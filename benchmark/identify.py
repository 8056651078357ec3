"""What the identify drives share: the seeded inputs and weights, the
program's models, bank and pipeline config built from them through the
program's own loaders, the detection-bias recipe, the outputs kept for
the comparison, the work counts of a traced batch, and the reference
run over the kept batches.

A drive (drives/<name>.py) subclasses `Identify` and supplies
`dispatch(i)` and `resolve(handle)`: the loop that feeds one entry point.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from benchmark import inputs, weights
from benchmark.counts import kernels as kcounts
from benchmark.counts import models as mcounts
from benchmark.reference import identify as ref_identify
from benchmark.reference import nets
from benchmark.reference import warp as ref_warp

BIAS_FRAMES = 8  # frames of the pool the detection-bias recipe reads


def detection_bias(det_tree: Dict, plan, frames_u8: torch.Tensor, per_frame: int) -> None:
    """In place: the cls bias that lets about `per_frame` anchors of a
    noise frame clear the 0.5 score threshold, read from the reference's
    detector with a zero bias (the median over frames of the logit
    halfway between the per_frame-th and the next anchor)."""
    head = det_tree["head"]["cls"]
    head["b"] = torch.zeros_like(head["b"])
    with torch.no_grad():
        logits = nets.scrfd_cls_logits(det_tree, ref_identify.normalize(frames_u8), plan,
                                       frames_u8.device)
    ranked = torch.sort(logits, dim=-1, descending=True).values
    nth = (ranked[:, per_frame - 1] + ranked[:, per_frame]) / 2
    head["b"] = torch.full_like(head["b"], -float(nth.median()))


class _precision:
    """TF32 for cuDNN convolutions and for matrix products, set for a block."""

    def __init__(self, conv_tf32: bool, matmul_tf32: bool):
        self.want = (conv_tf32, matmul_tf32)

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.want

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.prev


def tf32_off():
    """float32 convolutions and matrix products in full float32."""
    return _precision(False, False)


def program_arithmetic():
    """The arithmetic the program's convolutions run in on the card (torch's
    defaults): TF32 convolutions, whose products of bfloat16-rounded
    operands are exact, and full float32 matrix products. The reference's
    detector runs in it at the program's batch, so that its detections
    follow the program's summation order and a score near the threshold
    or a near-tie in NMS falls the same way on both sides."""
    return _precision(True, False)


COMPARED = ("unpaired_slots", "feature_gap", "topk_sim_gap", "topk_row_gap")


class Identify:
    """Frames → identities. Subclasses: `dispatch(i)` and `resolve(h)`."""

    COMPARED = COMPARED

    kind = "identify"

    def __init__(self, cell: Dict, seed: int, device, log):
        self.cell, self.seed, self.device, self.log = cell, seed, torch.device(device), log
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.K = self.cfg["faces_per_frame"]
        self.top_k = self.traffic["top_k"]
        self.valid_cap = self.traffic["valid_cap"]
        self.kept: Dict[int, Dict] = {}  # window position → program outputs
        self.keep_at = set(inputs.sample_positions(self.traffic, inputs.sub_seeds(seed)["sample"]))

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from facerecognizeonnx_tpu_torch import bridge
        from facerecognizeonnx_tpu_torch.config import PipelineConfig
        from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
        from facerecognizeonnx_tpu_torch.models import recognizer_module_for, scrfd

        t0 = time.perf_counter()
        seeds, dev, cfg = inputs.sub_seeds(self.seed), self.device, self.cfg
        det_cfg, rec_cfg = cfg["detector"], cfg["recognizer"]
        self.det_plan = [tuple(p) for p in det_cfg["plan"]]
        self.rec_plan = weights.mbf_plan(rec_cfg) if rec_cfg["kind"] == "mobilefacenet" else None
        self.pool = inputs.frame_pool(self.traffic, seeds["frames"], dev)
        self.det_tree = weights.scrfd_tree(det_cfg, seeds["detector"], dev)
        with tf32_off():
            detection_bias(self.det_tree, self.det_plan, self.pool[0, :BIAS_FRAMES],
                           self.traffic["anchors_per_frame"])
        self.rec_tree = weights.recognizer_tree(rec_cfg, seeds["recognizer"], dev)
        self.gallery = inputs.gallery(self.traffic, rec_cfg["feature_dim"], seeds["gallery"], dev)
        self.log(f"set-up: inputs and weights drawn, bias set, {time.perf_counter() - t0:.2f} s")

        det = bridge.params_from_numpy(weights.to_numpy(self.det_tree), dev)
        rec = bridge.params_from_numpy(weights.to_numpy(self.rec_tree), dev)
        if cfg["fold_bn"]:
            det = scrfd.fold_inference_params(det)
            rec = recognizer_module_for(rec).fold_inference_params(rec)
        self.det, self.rec = det, rec
        self.pcfg = PipelineConfig(
            det_input_size=det_cfg["input_size"], score_threshold=cfg["score_threshold"],
            nms_threshold=cfg["nms_threshold"], pre_nms_topk=cfg["pre_nms_topk"],
            max_faces=cfg["max_faces"], nms_int_rects=cfg["nms_int_rects"],
            rec_input_size=rec_cfg["input_size"], feature_dim=rec_cfg["feature_dim"],
            rec_arch=rec_cfg["arch"], compute_dtype=cfg["compute"],
            scrfd_variant=det_cfg["variant"], warp_impl="cuda", skip_invalid_faces=True,
        )
        bank = GalleryBank(rec_cfg["feature_dim"], device=dev)
        n = self.gallery.shape[0]
        bank.add_batch([f"id{i}" for i in range(n)], self.gallery.cpu().numpy())
        self.bank_padded, self.n_rows, self.names = bank.device_bank_padded()
        self.build()
        self.log(f"set-up: the program's models and bank, {time.perf_counter() - t0:.2f} s")

    def build(self) -> None:
        """Subclass hook: the entry point's own objects."""

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The program's modules whose forward opens a layer's range."""
        return {"detect": self.det, "embed": self.rec}

    def frames(self, i: int) -> torch.Tensor:
        return self.pool[i % self.pool.shape[0]]

    # ------------------------------------------------------------ window

    def keep(self, i: int, dets, feats, sims, idx) -> None:
        """Hold the program's outputs of window position i if it is sampled,
        and those of the latest batch (`keep_last` adds them when the
        window closes)."""
        K = self.K
        out = {
            "boxes": dets.boxes[:, :K], "scores": dets.scores[:, :K],
            "kps": dets.kps[:, :K], "det_valid": dets.valid[:, :K],
            "feats": feats, "sims": sims, "idx": idx,
        }
        if i in self.keep_at:
            self.kept[i] = out
        self.last = (i, out)

    def keep_last(self) -> None:
        i, out = self.last
        self.kept[i] = out

    def embed_valid(self, det_valid: torch.Tensor) -> torch.Tensor:
        if self.valid_cap is None:
            return det_valid
        k = torch.arange(self.K, device=det_valid.device)[None, :] < self.valid_cap
        return k.expand(det_valid.shape)

    def work(self, dets) -> Dict:
        """Model FLOPs and kernel bytes of one batch, from its shapes and
        the program's detections (which faces the warp and embed served)."""
        K, B = self.K, dets.valid.shape[0]
        s = self.cfg["detector"]["input_size"]
        ev = self.embed_valid(dets.valid[:, :K])
        n_faces = int(ev.sum())
        Ms = ref_warp.align_matrices(dets.kps[:, :K], dets.boxes[:, :K], s, s)
        flops = (B * mcounts.scrfd_flops(self.cfg["detector"], s)
                 + n_faces * mcounts.recognizer_flops(self.cfg["recognizer"])
                 + mcounts.match_flops(n_faces, self.n_rows, self.cfg["recognizer"]["feature_dim"]))
        return {
            "model_flops": flops,
            "kernels": {
                "warp_xm_pyramid": {"bytes": kcounts.pyramid_bytes(B, s, s), "flops": 0},
                "warp_xm": {"bytes": kcounts.warp_xm_bytes(Ms, ev, s, s), "flops": 0},
                "nms_greedy": {"bytes": kcounts.nms_bytes(B, self.cfg["pre_nms_topk"]),
                               "flops": 0},
            },
        }

    def counters(self) -> Dict:
        return {}

    def reset_counters(self) -> None:
        """Called when the warm-up ends."""

    def free_program(self) -> None:
        """Drop the program's models and state before the reference runs."""
        for name in ("det", "rec", "bank_padded", "pipe", "last"):
            if hasattr(self, name):
                delattr(self, name)

    # ------------------------------------------------------------ reference

    def _ref_detect(self, frames, prec):
        with program_arithmetic():
            return ref_identify.detect_slots(frames, self.det_tree, self.det_plan, self.cfg, prec)

    def _serve(self, frames, d, prec):
        with tf32_off():
            return ref_identify.serve(
                frames, d["kps"], d["boxes"], self.embed_valid(d["det_valid"]), self.rec_tree,
                self.cfg["recognizer"]["kind"], self.rec_plan, self.gallery, self.top_k, prec)

    def control(self, det_prec, rec_prec, positions: List[int]) -> Dict:
        """The reference in the program's place at the given precisions:
        outputs shaped as the kept program outputs."""
        out: Dict[int, Dict] = {}
        with torch.no_grad():
            for i in positions:
                frames = self.frames(i)
                d = self._ref_detect(frames, det_prec)
                s = self._serve(frames, d, rec_prec)
                s.pop("sim_rows")
                out[i] = dict(d, **s)
        return out

    def judge(self, outs: Dict[int, Dict], pairing: Dict) -> Dict[str, float]:
        """The numbers `correct` is judged by, a whole batch at a time (the
        program's batch, so the reference's detector takes the program's
        convolution algorithms): detected slots that find no partner in
        the reference's own detections within the pairing tolerance
        (`pairing`: coord_px, score), counted over every compared frame;
        and, over the paired slots that both sides serve, the largest gap
        of the features and the match, the reference served at its own
        landmarks (so a landmark moved by the program shows in the
        features). The widest gaps of mutual-nearest pairs are returned
        beside them for the calibration."""
        out = {"unpaired_slots": 0.0}
        with torch.no_grad():
            for i in sorted(outs):
                frames = self.frames(i)
                side = outs[i]
                ref_d = self._ref_detect(frames, nets.BF16)
                ref_s = self._serve(frames, ref_d, nets.BF16)
                nums = compare(side, ref_d, ref_s, self.embed_valid(side["det_valid"]),
                               self.embed_valid(ref_d["det_valid"]), pairing)
                for k, v in nums.items():
                    out[k] = out[k] + v if k == "unpaired_slots" else max(out.get(k, -math.inf), v)
        return out


def slot_pairs(side: Dict, ref: Dict):
    """Pairs each judged slot with its mutual-nearest reference slot of the
    same frame, by the largest box / landmark coordinate gap. Returns the
    reference slot (B, K) or -1, and the pair's coordinate and score
    gaps (inf where unpaired)."""
    pb = torch.cat([side["boxes"], side["kps"].flatten(2)], -1)
    rb = torch.cat([ref["boxes"], ref["kps"].flatten(2)], -1)
    d = (pb[:, :, None, :] - rb[:, None, :, :]).abs().amax(-1)  # (B, Kp, Kr)
    both = side["det_valid"][:, :, None] & ref["det_valid"][:, None, :]
    d = torch.where(both, d, torch.full_like(d, math.inf))
    best_r = d.argmin(2)
    best_p = d.argmin(1)
    gap = d.gather(2, best_r[..., None])[..., 0]
    mutual = best_p.gather(1, best_r) == torch.arange(d.shape[1], device=d.device)[None, :]
    ok = mutual & torch.isfinite(gap)
    inf = torch.full_like(gap, math.inf)
    score_gap = torch.where(ok, (side["scores"] - ref["scores"].gather(1, best_r)).abs(), inf)
    return (torch.where(ok, best_r, torch.full_like(best_r, -1)), torch.where(ok, gap, inf),
            score_gap)


def compare(side: Dict, ref_d: Dict, ref_s: Dict, served, ref_served,
            pairing: Dict) -> Dict[str, float]:
    """The numbers of one batch:

    - unpaired_slots: detected slots (of the first K), on either side,
      whose mutual-nearest slot on the other side lies farther than
      pairing["coord_px"] in a box or landmark coordinate or
      pairing["score"] in score, or is served on one side only;
    - pair_coord_gap_px, pair_score_gap: the widest gaps of the
      mutual-nearest pairs (for setting the tolerance; not compared);
    - feature_gap: the largest 1 - cos between a paired served slot's
      feature and the reference's at the reference's own landmarks (inf
      when no pair is served);
    - topk_sim_gap: the largest gap between the two sides' j-th best
      similarity of a paired served slot;
    - topk_row_gap: how far below the reference's j-th best similarity
      the row the judged side put j-th lies, in the reference's scores.
    """
    pair, gap, score_gap = slot_pairs(side, ref_d)
    paired = (pair >= 0) & (gap <= pairing["coord_px"]) & (score_gap <= pairing["score"])
    j = pair.clamp_min(0)
    ref_served_at = ref_served.gather(1, j)
    both_served = paired & served & ref_served_at
    n_pair = int((paired & (served == ref_served_at)).sum())
    n_p, n_r = int(side["det_valid"].sum()), int(ref_d["det_valid"].sum())
    found = pair >= 0
    out = {
        "unpaired_slots": float(n_p - n_pair + n_r - n_pair),
        "pair_coord_gap_px": float(gap[found].max()) if bool(found.any()) else math.inf,
        "pair_score_gap": float(score_gap[found].max()) if bool(found.any()) else math.inf,
    }
    if not bool(both_served.any()):
        return dict(out, feature_gap=math.inf, topk_sim_gap=math.inf, topk_row_gap=math.inf)
    zero = torch.zeros((), device=served.device)
    u = both_served[..., None]
    at = lambda t: t.gather(1, j.view(*j.shape, *([1] * (t.dim() - 2))).expand(  # noqa: E731
        *j.shape, *t.shape[2:]))
    r_feats, r_sims, r_rows = at(ref_s["feats"]), at(ref_s["sims"]), at(ref_s["sim_rows"])
    cos = (side["feats"] * r_feats).sum(-1)
    at_side = r_rows.gather(2, side["idx"].to(torch.int64))
    out["feature_gap"] = float(torch.where(both_served, 1.0 - cos, zero).max())
    out["topk_sim_gap"] = float(torch.where(u, (side["sims"] - r_sims).abs(), zero).max())
    out["topk_row_gap"] = float(torch.where(u, (r_sims - at_side).clamp_min(0), zero).max())
    return out
