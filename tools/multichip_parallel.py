"""The parallel layer (`facerecognizeonnx_tpu_torch/parallel/`), the
ArcFace trainer and the CLI over N ranks, one device each, over NCCL on
N cards (or Gloo on the CPU): the port's counterpart of
`__graft_entry__.py::dryrun_multichip`.

chip_smoke.py phases 16 and 17 run every parallel function and the
train step as one rank on one card. This tool runs the multi-rank forms
where each rank has its own card: it starts N processes of itself
(`parallel.distributed.RankProcesses`, the CLI's launcher), which meet
through `init_distributed` (COORDINATOR_ADDRESS on a free localhost
port, NUM_PROCESSES, PROCESS_ID) and each drive cuda:{rank}. Forms, each
against the plain single-device call (rank 0 prints one line each):

  dp       `make_dp_program` on 8 frames per rank (SCRFD-500m 640² +
           IResNet-50, folded, bf16, K=8): each rank's block bit-equal to
           the eager `frames_to_features` on that block; one warp_xm, one
           pyramid and one nms_greedy launch per rank per call; the dp
           step (N × 8 frames) against the eager step on 8 and on N × 8
           frames on one card, wall, synchronized, median of 10 [min–max]
  search   `sharded_topk_search` at Q=128, G=1,000,000, D=512, k=5 (rows
           over the N ranks) against `gallery_topk_reference` on one
           card: sims within 1.67e-6, indices equal outside near-ties;
           eager times (between CUDA events, median of 20) of the
           sharded, dense and kernel searches
  tp       `tp_embed_crops` over an N-wide "model" axis, 64 IResNet-50
           crops in float32 (TF32 off), against `embed_crops`: rtol 1e-4,
           atol 1e-5
  ep       `ep_embed_crops` with N seeded IResNet-50 experts, one per
           rank, 64 crops in float32: every face within 1e-5 of its
           expert alone
  pp       `pipelined_frames_to_features` on a ("data", "stage")
           (N/2, 2) mesh, 8 frames in float32: masks equal, boxes rtol
           1e-5 / atol 1e-4, features rtol 1e-4 / atol 1e-5 against the
           fused step
  service  `IdentifyService(mesh=N, sharded=True)` on every rank against
           the plain service on 16 requests in float32 (TF32 off): masks
           equal, names equal clear of near-ties and sims within 1e-4 (a
           rank embeds 2 of the 8 padded frames; in bf16 detections and
           features move with the batch)
  train    the data × model ArcFace step (`make_train_step(mesh)`):
           (a) speed at full width, IResNet-50 112², 512-d, float32 with
           cuDNN's TF32 convolutions, B=128 per "data" rank, C=93,431
           (arcface_torch's configs/ms1mv3_r50.py), on the (N, 1) and
           (N/2, 2) meshes: ms/step median of 10 after 3 warm-ups with
           min-max, images/s in all and per card, peak MiB per rank; the
           gradient all-reduce alone (one flat buffer of the step's
           size, between CUDA events, median of 20); the BN-statistics
           all-reduces of one step, counted, each timed between CUDA
           events in the step and summed, and the same sizes replayed
           alone; (b) parity, float32 with TF32 off, the same 32-image
           global batch on both meshes against the one-card step:
           loss rel 1e-5, classifier and momentum within 1e-4 of scale,
           BN statistics within 1e-4, the backbone's update and
           momentum within 1e-2 relative L2 (the bars of
           tests/test_torch_train_step.py::hold_step); (c) the data: an
           8-id × 4-image folder of 640x480 noise PNGs, detected and
           aligned through the kernels with the ranks splitting the
           images (`IdentityFolderDataset.load_crops`): the crop cache's
           hash all-gathered and equal on every rank and to one card's
           own crops of the whole folder; the kernels' launches per rank
           from the device counters
  bucketed `BucketedEmbedPipeline(mesh, search_top_k=3)` against
           `make_dp_program(search_top_k=3)` on the dp frames, float32
           (TF32 off): masks equal, features within rtol 1e-4 / atol
           1e-4 (the JAX dryrun's bar), launches per call
  w8a8     `make_dp_program` with a `quantize_recognizer` copy (bf16):
           each rank's block bit-equal to the eager w8a8 step on it
  pp_tp    `pipelined_frames_to_features` on a ("stage", "model") (2,
           N/2) mesh against the fused step, under pp's bars
  cli      the CLI as a user starts it, in float32 with TF32 off (a `-c`
           wrapper the CLI re-executes for its other ranks): `serve
           --dp -1` and `serve --sharded` (N ranks each, started by the
           CLI) against a one-card `serve` on 16 concurrent /identify
           requests (masks and boxes equal within 1e-3 px, names equal
           clear of near-ties, sims within 1e-4), one /enroll each that
           every rank takes (rank 0's drained line), SIGTERM → exit 0;
           `train --align` on the identity folder for 20 steps reports
           `mesh data=N` and saves a `.npz` that loads

Usage, from the repo root:

    python3 tools/multichip_parallel.py [--world 4] [--cpu] [--small]
                                        [--forms dp,search,...]

--cpu runs the ranks over Gloo on the CPU (a rehearsal; the cli form
then starts the CLI's ranks itself through the launcher's variables),
--small at 128² with IResNet-18, a 10,000-row gallery and small train
batches. The last line of the standard output is a JSON object of the
checks and times. Exit code 0 when every rank finished and every check
held.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from facerecognizeonnx_tpu_torch.parallel.distributed import (  # noqa: E402
    RankProcesses,
    free_port,
)

SERVICE_BAR = 1e-4  # float32 sims, the one-at-a-time serving bar of chip_smoke phase 12
FORMS = ("dp", "search", "tp", "ep", "pp", "service", "train", "bucketed", "w8a8", "pp_tp",
         "cli")
TRAIN_C = 93_431  # arcface_torch configs/ms1mv3_r50.py: classes
TRAIN_B = 128  # its per-GPU batch
PARITY_B = 32  # the parity step's global batch
CLI_F32 = (  # the CLI in float32 with TF32 off; its ranks re-execute this
    "import sys, torch; sys.path.insert(0, {repo!r}); "
    "torch.backends.cudnn.allow_tf32 = False; torch.backends.cuda.matmul.allow_tf32 = False; "
    "from facerecognizeonnx_tpu_torch.cli import main as cli; auto = cli.auto_config; "
    "cli.auto_config = lambda **kw: auto(**{{'compute_dtype': 'float32', **kw}}); "
    "sys.exit(cli.main(sys.argv[1:]))"
)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fns: dict, dev, rounds=10) -> dict:
    """Wall ms of each callable, synchronized, a barrier before each call,
    the callables in turns: name → (median, min, max)."""
    import torch.distributed as dist

    times = {k: [] for k in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: [statistics.median(v), min(v), max(v)] for k, v in times.items()}


def _event_ms(fn, dev, iters=20) -> float:
    """Median ms of fn's eager call between CUDA events (host clock on the CPU)."""
    fn()
    out = []
    for _ in range(iters):
        _sync(dev)
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def rank_main(args) -> int:
    import torch.distributed as dist

    import chip_smoke as cs
    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.config import PipelineConfig
    from facerecognizeonnx_tpu_torch.models import arcface, scrfd
    from facerecognizeonnx_tpu_torch.parallel import mesh as pm
    from facerecognizeonnx_tpu_torch.parallel.distributed import init_distributed

    forms = args.forms.split(",")
    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        torch.set_num_threads(1)
    init_distributed(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    data = pm.make_mesh(("data",), device=device)
    model = pm.make_mesh(("model",), device=device)
    dev = pm.mesh_device(data)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        if rank == 0:
            cs.build_all()
        dist.barrier()

    def say(line):
        if rank == 0:
            print(line, flush=True)

    size = 128 if args.small else 640
    arch = "iresnet18" if args.small else "iresnet50"
    per_rank, K, TOP_K = (2, 4, 5) if args.small else (8, 8, 5)
    cfg = PipelineConfig(det_input_size=size, compute_dtype="bfloat16", warp_impl="cuda",
                         rec_arch=arch)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(0)
    B = per_rank * world
    frames = torch.from_numpy(rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8))
    det_tree = cs.detection_bias(bridge.init_params_numpy("500m", seed=0), frames.to(dev))
    det = scrfd.fold_inference_params(bridge.params_from_numpy(det_tree, dev))
    rec_tree = bridge.init_params_numpy(arch, seed=1)
    rec = arcface.fold_inference_params(bridge.params_from_numpy(rec_tree, dev))
    frames = frames.to(dev)
    gen = torch.Generator().manual_seed(5)
    summary = {"world": world, "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                          else "cpu"), "checks": {}}
    if dev.type == "cuda":
        summary["nvidia_smi"] = cs.nvidia_smi()
    say(f"{world} ranks over {dist.get_backend()}, rank 0 on {dev} ({summary['device']})"
        + (f" | {summary['nvidia_smi']}" if dev.type == "cuda" else ""))
    lo, hi = rank * per_rank, (rank + 1) * per_rank
    ctx = dict(args=args, cs=cs, rank=rank, world=world, data=data, model=model, dev=dev,
               device=device, cfg=cfg, cfg32=cfg32, rng=rng, frames=frames, det=det, rec=rec,
               det_tree=det_tree, rec_tree=rec_tree, arch=arch, size=size, K=K, TOP_K=TOP_K,
               per_rank=per_rank, B=B, lo=lo, hi=hi, gen=gen, say=say, summary=summary)
    for form in forms:
        if form in RANK_FORMS:
            t0 = time.perf_counter()
            RANK_FORMS[form](ctx)
            dist.barrier()
            say(f"  ({form}: {time.perf_counter() - t0:.1f} s)")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(args.summary, "w") as f:
            json.dump(summary, f)
    return 0


def form_dp(c):
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import make_dp_program
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

    cs, dev, frames, det, rec, cfg, K = (c[k] for k in ("cs", "dev", "frames", "det", "rec",
                                                          "cfg", "K"))
    lo, hi, B = c["lo"], c["hi"], c["B"]
    program, _ = make_dp_program(det, rec, cfg, mesh=c["data"], max_faces_embed=K)
    with torch.no_grad():
        cs.reset_counts()
        dets, feats = program(frames)
        _sync(dev)
        counts = cs.read_counts()
        e_dets, e_feats = frames_to_features(det, rec, frames[lo:hi], cfg, K)
        for a, b in zip(tuple(dets) + (feats,), tuple(e_dets) + (e_feats,)):
            assert torch.equal(a[lo:hi], b), f"rank {c['rank']}: dp block differs from eager"
        assert dets.valid[:, :K].any(dim=-1).all(), "a frame found no faces"
        if dev.type == "cuda":
            assert [counts[n] for n in ("warp_xm", "warp_xm_pyramid", "nms_greedy")] == [1] * 3
        t = _timed({
            "dp": lambda: program(frames),
            "eager_rank_share": lambda: frames_to_features(det, rec, frames[lo:hi], cfg, K),
            "eager_whole_batch": lambda: frames_to_features(det, rec, frames, cfg, K),
        }, dev)
    c["summary"]["checks"]["dp"] = dict(frames=B, launches=counts, ms=t)
    c["say"](f"dp: {B} frames over {c['world']} ranks ({c['per_rank']} each, {c['size']}², "
             f"{c['arch']}, bf16, K={K}): each block bit-equal to the eager step on it; "
             f"launches per call on rank 0 {counts}; wall ms median [min-max]: dp {t['dp']}, "
             f"eager on one card {c['per_rank']} frames {t['eager_rank_share']}, {B} frames "
             f"{t['eager_whole_batch']}")


def form_search(c):
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.ops import gallery_cuda
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import sharded_topk_search

    cs, dev, model, TOP_K = c["cs"], c["dev"], c["model"], c["TOP_K"]
    G = 10_000 if c["args"].small else 1_000_000
    gen = c["gen"]
    # every rank holds the global gallery on its card (the SPMD call), and
    # searches only its own row block of it
    gallery = torch.nn.functional.normalize(torch.randn(G, 512, generator=gen), dim=-1).to(dev)
    q = torch.nn.functional.normalize(torch.randn(128, 512, generator=gen), dim=-1).to(dev)
    sv, si = sharded_topk_search(q, gallery, TOP_K, mesh=model)
    s_ms = _event_ms(lambda: sharded_topk_search(q, gallery, TOP_K, mesh=model), dev)
    if c["rank"] == 0:
        g = gallery
        rv, ri = gallery_cuda.gallery_topk_reference(q, g, TOP_K + 1)
        err, ties = cs.check_topk(sv, si, rv[:, :TOP_K], ri[:, :TOP_K], rv[:, TOP_K],
                                  bar=cs.PARALLEL_SEARCH_BAR)
        dense_ms = _event_ms(lambda: gallery_cuda.gallery_topk_reference(q, g, TOP_K), dev)
        kernel_ms = (_event_ms(lambda: gallery_cuda.gallery_topk_cuda(q, g, TOP_K), dev)
                     if dev.type == "cuda" else None)
        del g
        c["summary"]["checks"]["search"] = dict(G=G, max_abs_err=err, ties=ties,
                                                sharded_ms=s_ms, dense_ms=dense_ms,
                                                kernel_ms=kernel_ms)
        c["say"](f"search: Q=128, G={G:,}, k={TOP_K}, rows over {c['world']} ranks: sims "
                 f"max|d| {err:.3g} (bar {cs.PARALLEL_SEARCH_BAR:g}), indices equal outside "
                 f"near-ties ({ties} exact ties); eager ms (median of 20): sharded "
                 f"{s_ms:.4f}, dense on one card {dense_ms:.4f}, kernel on one card "
                 f"{kernel_ms}")
    dist.barrier()
    del gallery


def form_tp_ep(c):
    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops
    from facerecognizeonnx_tpu_torch.parallel import mesh as pm
    from facerecognizeonnx_tpu_torch.parallel.expert_parallel import ep_embed_crops
    from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import tp_embed_crops

    cs, dev, rec, cfg32, world, rank = (c[k] for k in ("cs", "dev", "rec", "cfg32", "world",
                                                       "rank"))
    crops = torch.from_numpy(c["rng"].integers(0, 256, (64, 112, 112, 3), dtype=np.uint8))
    experts = [bridge.init_params_numpy(c["arch"], seed=10 + e) for e in range(world)]
    ids = np.arange(64) % world
    with torch.no_grad(), cs.tf32_off():
        tp = tp_embed_crops(rec, crops.to(dev), cfg32, mesh=c["model"])
        want = embed_crops(rec, crops.to(dev), cfg32)
        torch.testing.assert_close(tp, want, rtol=1e-4, atol=1e-5)
        tp_err = float((tp - want).abs().max())
        expert = pm.make_mesh(("expert",), device=c["device"])
        ep, routed = ep_embed_crops(experts, ids, crops.numpy(), cfg32, mesh=expert,
                                    capacity_factor=2.0)
        assert routed.all()
        mine = ids == rank  # each rank checks its own expert's faces
        alone = embed_crops(bridge.params_from_numpy(experts[rank], dev),
                            crops[mine].to(dev), cfg32).cpu().numpy()
        ep_err = float(np.abs(ep[mine] - alone).max())
        assert ep_err <= 1e-5, ep_err
    c["summary"]["checks"]["tp"] = dict(max_abs_err=tp_err)
    c["summary"]["checks"]["ep"] = dict(max_abs_err_rank0=ep_err)
    c["say"](f"tp: 64 {c['arch']} crops over a {world}-wide model axis, float32 TF32 off: "
             f"max|d| {tp_err:.3g} (bar rtol 1e-4 / atol 1e-5) | ep: {world} experts, one per "
             f"rank, 64 crops: every face routed, rank 0's faces within {ep_err:.3g} of its "
             f"expert alone (bar 1e-5)")


def _hold_pp(p_dets, p_feats, f_dets, f_feats) -> float:
    """pp's bars against the fused step; returns the features' max|d|."""
    assert torch.equal(p_dets.valid, f_dets.valid)
    torch.testing.assert_close(p_dets.boxes, f_dets.boxes, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(p_feats, f_feats, rtol=1e-4, atol=1e-5)
    return float((p_feats - f_feats).abs().max())


def _pp_frames(c):
    n_pp = 2 * c["world"]
    frames, B = c["frames"], c["B"]
    return frames[:n_pp] if B >= n_pp else frames.repeat(2, 1, 1, 1)[:n_pp]


def form_pp(c, axes=("data", "stage"), name="pp"):
    from facerecognizeonnx_tpu_torch.parallel import mesh as pm
    from facerecognizeonnx_tpu_torch.parallel.pipeline_stage import (
        pipelined_frames_to_features,
    )
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

    world = c["world"]
    if world % 2:
        return
    shape = (world // 2, 2) if axes[0] == "data" else (2, world // 2)
    pmesh = pm.make_mesh(axes, shape, device=c["device"])
    pp_frames = _pp_frames(c)
    det, rec, cfg32, K = c["det"], c["rec"], c["cfg32"], c["K"]
    with torch.no_grad(), c["cs"].tf32_off():
        p_dets, p_feats = pipelined_frames_to_features(det, rec, pp_frames, cfg32,
                                                       mesh=pmesh, max_faces_embed=K)
        f_dets, f_feats = frames_to_features(det, rec, pp_frames, cfg32, K)
    err = _hold_pp(p_dets, p_feats, f_dets, f_feats)
    c["summary"]["checks"][name] = dict(frames=len(pp_frames), mesh=list(shape),
                                        max_abs_err=err)
    c["say"](f"{name}: {len(pp_frames)} frames on a {axes} {shape} mesh, float32 TF32 off: "
             f"masks equal, boxes within rtol 1e-5 / atol 1e-4, features max|d| {err:.3g} "
             f"(bar rtol 1e-4 / atol 1e-5) against the fused step")


def form_pp_tp(c):
    form_pp(c, axes=("stage", "model"), name="pp_tp")


def form_service(c):
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService

    cs, dev, frames, B, K, world = (c[k] for k in ("cs", "dev", "frames", "B", "K", "world"))
    bank = GalleryBank(device=dev)
    bank.add_batch([f"id{i}" for i in range(1000)], np.asarray(
        torch.nn.functional.normalize(torch.randn(1000, 512, generator=c["gen"]), dim=-1)))
    requests = [frames[i % B].cpu().numpy() for i in range(16)]
    # float32 (TF32 off): each rank embeds its 2 of the 8 padded frames
    # where the plain service runs all 8, and in bf16 both detection and
    # features move with the batch (sims 6.5e-3 apart on four cards)
    with cs.tf32_off():
        svc = {name: IdentifyService(c["det"], c["rec"], bank, c["cfg32"], max_batch=8,
                                     max_faces=K, device=dev, **kw)
               for name, kw in (("mesh", dict(mesh=world, sharded=True)), ("plain", {}))}
        try:
            res = {name: [s.identify(im, top_k=3) for im in requests]
                   for name, s in svc.items()}
        finally:
            for s in svc.values():
                s.close()
    checked = equal = 0
    sim_err = 0.0
    for a, b in zip(res["mesh"], res["plain"]):
        assert np.array_equal(a.valid, b.valid) and a.valid.any()
        n_c, n_e = cs.names_outside_ties(a, b, SERVICE_BAR)
        checked, equal = checked + n_c, equal + n_e
        sim_err = max(sim_err, float(np.abs(a.sims - b.sims).max()))
    assert equal == checked and sim_err <= SERVICE_BAR, (equal, checked, sim_err)
    c["summary"]["checks"]["service"] = dict(requests=16, names_checked=checked,
                                             sims_max_abs_diff=sim_err)
    c["say"](f"service: IdentifyService(mesh={world}, sharded=True) on every rank vs the "
             f"plain service, float32 TF32 off, 16 requests one at a time: masks equal, names "
             f"equal on all {checked} positions clear of near-ties, sims max|d| {sim_err:.3g} "
             f"(bar {SERVICE_BAR:g})")
    dist.barrier()


def form_bucketed(c):
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import make_dp_program
    from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline

    cs, dev, frames, K, cfg32 = (c[k] for k in ("cs", "dev", "frames", "K", "cfg32"))
    bank = torch.zeros((1024, 512))
    bank[:1000] = torch.nn.functional.normalize(torch.randn(1000, 512, generator=c["gen"]),
                                                dim=-1)
    bank = bank.to(dev)
    with torch.no_grad(), cs.tf32_off():
        program, _ = make_dp_program(c["det"], c["rec"], cfg32, mesh=c["data"],
                                     max_faces_embed=K, search_top_k=3)
        pipe = BucketedEmbedPipeline(c["det"], c["rec"], cfg32, max_faces_embed=K,
                                     search_top_k=3, mesh=c["data"], device=dev)
        want = program(frames, bank, 1000)
        pipe(frames, bank, 1000)  # the first step guesses full occupancy
        cs.reset_counts()
        got = pipe(frames, bank, 1000)
        _sync(dev)
        counts = cs.read_counts()
    (b_dets, b_feats, b_sims, _b_idx, n_valid), (d_dets, d_feats, d_sims, _d_idx) = got, want
    assert torch.equal(b_dets.valid, d_dets.valid), "bucketed masks differ from the dp step"
    torch.testing.assert_close(b_feats, d_feats, rtol=1e-4, atol=1e-4)
    err = float((b_feats - d_feats).abs().max())
    if dev.type == "cuda":
        assert [counts[n] for n in ("warp_xm", "warp_xm_pyramid", "nms_greedy")] == [1] * 3, \
            counts
    c["summary"]["checks"]["bucketed"] = dict(max_abs_err=err, launches=counts,
                                              bucket=pipe.last_bucket, n_valid=int(n_valid))
    c["say"](f"bucketed: BucketedEmbedPipeline(mesh={c['world']}, search_top_k=3) vs "
             f"make_dp_program(search_top_k=3), {len(frames)} frames, float32 TF32 off: masks "
             f"equal, features max|d| {err:.3g} (bar rtol 1e-4 / atol 1e-4), {int(n_valid)} "
             f"faces, bucket {pipe.last_bucket}; launches in one call on rank 0 {counts}")


def form_w8a8(c):
    from facerecognizeonnx_tpu_torch.models.quant import quantize_recognizer
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import make_dp_program
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

    cs, dev, frames, det, cfg, K, lo, hi = (c[k] for k in ("cs", "dev", "frames", "det", "cfg",
                                                            "K", "lo", "hi"))
    calib = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (8, 112, 112, 3))
                             .astype(np.float32)).to(dev)
    qrec = quantize_recognizer(c["rec"], calib, cfg.torch_compute_dtype)
    program, _ = make_dp_program(det, qrec, cfg, mesh=c["data"], max_faces_embed=K)
    with torch.no_grad():
        cs.reset_counts()
        dets, feats = program(frames)
        _sync(dev)
        counts = cs.read_counts()
        e_dets, e_feats = frames_to_features(det, qrec, frames[lo:hi], cfg, K)
    for a, b in zip(tuple(dets) + (feats,), tuple(e_dets) + (e_feats,)):
        assert torch.equal(a[lo:hi], b), f"rank {c['rank']}: w8a8 dp block differs from eager"
    assert dets.valid[:, :K].any(dim=-1).all()
    if dev.type == "cuda":
        assert [counts[n] for n in ("warp_xm", "warp_xm_pyramid", "nms_greedy")] == [1] * 3
    c["summary"]["checks"]["w8a8"] = dict(launches=counts)
    c["say"](f"w8a8: make_dp_program with a quantize_recognizer copy of {c['arch']} (bf16, "
             f"{len(frames)} frames): each rank's block bit-equal to the eager w8a8 step on "
             f"it; launches in one call on rank 0 {counts}")


class _CountedDist:
    """`torch.distributed` for `models.layers` with each all_reduce (the
    BN statistics' forward and backward) counted and bracketed by CUDA
    events."""

    def __init__(self, dist, dev):
        self._dist, self._dev, self.calls = dist, dev, []

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_reduce(self, t, *a, group=None, **kw):
        if self._dev.type != "cuda":
            self.calls.append((t.numel(), group, None, None))
            return self._dist.all_reduce(t, *a, group=group, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._dist.all_reduce(t, *a, group=group, **kw)
        end.record()
        self.calls.append((t.numel(), group, start, end))
        return out


def _train_state_arrays(state, mesh):
    """Rank 0's flat numpy view of a (possibly column-split) state, the
    classifier and its trace gathered over "model" (collective)."""
    import chip_smoke as cs
    from facerecognizeonnx_tpu_torch.utils.checkpoint import _gather_cols

    flat = cs.train_arrays(state)
    flat["classifier"] = _gather_cols(state.classifier, mesh).cpu().numpy()
    flat["trace_cls"] = _gather_cols(state.opt_state["trace"]["classifier"], mesh).cpu().numpy()
    return flat


def form_train(c):
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.config import PipelineConfig
    from facerecognizeonnx_tpu_torch.models import layers
    from facerecognizeonnx_tpu_torch.parallel import mesh as pm
    from facerecognizeonnx_tpu_torch.train.trainer import init_train_state, make_train_step

    cs, dev, world, rank, say = (c[k] for k in ("cs", "dev", "world", "rank", "say"))
    small = c["args"].small
    arch = c["arch"]
    rcfg = PipelineConfig(compute_dtype="float32")
    shapes = [(world, 1)] + ([(world // 2, 2)] if world % 2 == 0 and world > 2 else [])
    out = {"speed": {}, "parity": {}}

    # ---- (a) speed at full width
    per_rank_b, classes = (4, 1000) if small else (TRAIN_B, TRAIN_C)
    warm, timed = (1, 2) if small else (3, 10)
    for shape in shapes:
        mesh = pm.make_mesh(("data", "model"), shape, device=c["device"])
        n_data = shape[0]
        # the classifier's columns split evenly over "model" (one padding
        # column at 93,431 over 2): the JAX sharding's requirement too
        n_cls = -(-classes // shape[1]) * shape[1]
        gb = per_rank_b * n_data
        gen = torch.Generator().manual_seed(3)
        xb = (torch.rand((gb, 112, 112, 3), generator=gen) * 2 - 1).to(dev)
        yb = torch.randint(0, n_cls, (gb,), generator=gen).to(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = init_train_state(1, n_cls, rcfg, arch, mesh=mesh)
        step = make_train_step(mesh, rcfg)
        for _ in range(warm):
            state, loss = step(state, xb, yb)
        times = []
        for _ in range(timed):
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            state, loss = step(state, xb, yb)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        loss = float(loss)
        # the BN statistics' all-reduces of one more step, each between CUDA events
        counted = _CountedDist(layers.dist, dev)
        layers.dist = counted
        try:
            state, _ = step(state, xb, yb)
        finally:
            layers.dist = counted._dist
        _sync(dev)
        bn_n = len(counted.calls)
        bn_insitu = (sum(s.elapsed_time(e) for _, _, s, e in counted.calls)
                     if dev.type == "cuda" else None)
        data_g = mesh.get_group("data") if n_data > 1 else None
        bn_alone = None
        if data_g is not None and counted.calls:
            sizes = [n for n, _, _, _ in counted.calls]
            bufs = {n: torch.zeros(n, device=dev) for n in sorted(set(sizes))}
            per = {n: _event_ms(lambda n=n: dist.all_reduce(bufs[n], group=data_g), dev)
                   for n in bufs}
            bn_alone = sum(per[n] for n in sizes)
        # the gradient all-reduce alone: one flat buffer of the step's size
        n_grad = sum(t.numel() for t in layers.trainable_tensors(state.model).values()) \
            + state.classifier.numel() + 1
        flat = torch.zeros(n_grad, device=dev)
        grad_ms = (_event_ms(lambda: dist.all_reduce(flat, group=data_g), dev)
                   if data_g is not None else 0.0)
        del flat
        peak = (torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0)
        peaks = [None] * world
        dist.all_gather_object(peaks, round(peak, 1))
        med = statistics.median(times)
        assert np.isfinite(loss)
        key = f"{shape[0]}x{shape[1]}"
        out["speed"][key] = dict(
            global_batch=gb, classes=n_cls, ms=[med, min(times), max(times)],
            images_per_s=gb / med * 1e3, images_per_s_per_card=gb / med * 1e3 / world,
            peak_mib_per_rank=peaks, grad_allreduce_floats=n_grad, grad_allreduce_ms=grad_ms,
            bn_allreduces=bn_n, bn_allreduce_ms_in_step=bn_insitu,
            bn_allreduce_ms_alone=bn_alone, loss=loss)
        say(f"train speed ({shape[0]}, {shape[1]}) mesh, {arch} 112² f32 (cuDNN TF32), "
            f"B={per_rank_b} per data rank ({gb} in all), C={n_cls:,}: {med:.2f} ms/step "
            f"median of {timed} after {warm} (min {min(times):.2f}, max {max(times):.2f}) = "
            f"{gb / med * 1e3:.1f} images/s, {gb / med * 1e3 / world:.1f} per card; peak MiB "
            f"per rank {peaks}; gradient all-reduce alone ({n_grad:,} floats, "
            f"{n_grad * 4 / 1e9:.3f} GB) {grad_ms:.3f} ms; BN all-reduces per step {bn_n}, "
            f"summed {bn_insitu} ms in the step, {bn_alone} ms replayed alone")
        del state, xb, yb, step

    # ---- (b) parity against the one-card step, float32 TF32 off
    gen = torch.Generator().manual_seed(4)
    pb = 8 if small else PARITY_B
    x = (torch.rand((pb, 112, 112, 3), generator=gen) * 2 - 1).to(dev)
    y = torch.randint(0, 1000, (pb,), generator=gen).to(dev)
    with cs.tf32_off():
        if rank == 0:
            one = init_train_state(0, 1000, rcfg, arch, device=dev)
            before = cs.train_arrays(one)
            one, one_loss = make_train_step(None, rcfg)(one, x, y)
            want = cs.train_arrays(one)
            one_loss = float(one_loss)
            del one
        for shape in shapes:
            mesh = pm.make_mesh(("data", "model"), shape, device=c["device"])
            st = init_train_state(0, 1000, rcfg, arch, mesh=mesh)
            st, loss = make_train_step(mesh, rcfg)(st, x, y)
            got = _train_state_arrays(st, mesh)
            del st
            if rank == 0:
                errs = cs.step_errors(got, want, before)
                loss_rel = abs(float(loss) - one_loss) / abs(one_loss)
                key = f"{shape[0]}x{shape[1]}"
                out["parity"][key] = dict(loss_rel=loss_rel, **errs)
                assert loss_rel <= 1e-5, (float(loss), one_loss)
                assert errs["stats"] <= 1e-4 and errs["classifier"] <= 1e-4, errs
                assert errs["update"] <= 1e-2 and errs["momentum"] <= 1e-2, errs
                say(f"train parity ({shape[0]}, {shape[1]}) vs one card, {arch} f32 TF32 off, "
                    f"{pb} images in all: loss rel {loss_rel:.2e} (bar 1e-5), BN stats "
                    f"{errs['stats']:.2e} and classifier+momentum {errs['classifier']:.2e} "
                    f"(bar 1e-4), backbone update {errs['update']:.2e} and momentum "
                    f"{errs['momentum']:.2e} rel L2 (bar 1e-2)")

    # ---- (c) the data: ranks split the folder's crops, all-gathered
    out["data"] = _train_data(c)
    c["summary"]["checks"]["train"] = out


def _train_data(c):
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch import FaceDetector
    from facerecognizeonnx_tpu_torch.config import PipelineConfig
    from facerecognizeonnx_tpu_torch.ops import nms, warp_cuda
    from facerecognizeonnx_tpu_torch.parallel import mesh as pm
    from facerecognizeonnx_tpu_torch.train.data import IdentityFolderDataset

    cs, dev, rank, world, size = (c[k] for k in ("cs", "dev", "rank", "world", "size"))
    hw = (96, 128) if c["args"].small else cs.TRAIN_HW
    obj = [tempfile.mkdtemp(prefix="frt_ids_") if rank == 0 else None]
    dist.broadcast_object_list(obj, src=0)
    root = os.path.join(obj[0], "ids")
    if rank == 0:
        cs.write_identity_folder(root, np.random.default_rng(17), hw)
    dist.barrier()
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda", det_input_size=size)
    det = FaceDetector(cfg, device=dev)
    assert det.load_model(None)
    boxed = torch.zeros((cs.TRAIN_IDS * cs.TRAIN_PER_ID, size, size, 3), dtype=torch.uint8)
    images = [cs.imread(p) for p in sorted(glob.glob(os.path.join(root, "*", "*.png")))]
    boxed[:, :hw[0], :hw[1]] = torch.from_numpy(np.stack(images))  # letterbox at scale 1
    cs.bias_detector(det, boxed.to(dev))
    mesh = pm.make_mesh(("data", "model"), (world, 1), device=c["device"])
    ds = IdentityFolderDataset(root, detector=det, cfg=cfg)
    before = ((nms.device_launches(), *warp_cuda.device_launches()) if dev.type == "cuda"
              else (0, 0, 0))
    t0 = time.perf_counter()
    n = ds.load_crops(mesh=mesh)
    secs = time.perf_counter() - t0
    after = ((nms.device_launches(), *warp_cuda.device_launches()) if dev.type == "cuda"
             else (0, 0, 0))
    moved = [a - b for a, b in zip(after, before)]
    digest = hashlib.sha256(b"".join(ds.crop(p).tobytes() for p, _ in ds.samples)).hexdigest()
    every = [None] * world
    dist.all_gather_object(every, (digest, moved))
    alone = None
    if rank == 0:  # one card's own crops of the whole folder
        one = IdentityFolderDataset(root, detector=det, cfg=cfg)
        alone = hashlib.sha256(b"".join(one.crop(p).tobytes()
                                        for p, _ in one.samples)).hexdigest()
        assert n == len(ds.samples), (n, len(ds.samples))
        assert all(d == digest for d, _ in every) and alone == digest, (every, alone)
        if dev.type == "cuda":
            share = [len(range(r, len(ds.samples), world)) for r in range(world)]
            assert [m for _, m in every] == [[s] * 3 for s in share], every
        c["say"](f"train data: {len(ds.samples)} PNGs {hw[1]}x{hw[0]} split over {world} "
                 f"ranks, {secs:.2f} s: crop caches equal on every rank and to one card's "
                 f"own crops (sha256 {digest[:12]}); device-counter launches per rank "
                 f"(nms_greedy, pyramid, warp_xm): {[m for _, m in every]}")
    if rank == 0:
        import shutil

        shutil.rmtree(obj[0], ignore_errors=True)
    return dict(images=len(ds.samples), seconds=secs, launches_per_rank=[m for _, m in every],
                equal=True)


RANK_FORMS = {
    "dp": form_dp, "search": form_search, "tp": form_tp_ep, "pp": form_pp,
    "service": form_service, "train": form_train, "bucketed": form_bucketed,
    "w8a8": form_w8a8, "pp_tp": form_pp_tp,
}


# ---------------------------------------------------------------- the CLI form


def _cli_start(argv, world, cpu, log_path, env):
    """The CLI in float32 with TF32 off: on the card one process (the CLI
    starts its other ranks); on the CPU every rank here, through the
    launcher's variables (the CLI on the CPU is one rank otherwise)."""
    cmd = [sys.executable, "-c", CLI_F32.format(repo=REPO), *argv]
    if not cpu or world == 1:
        f = open(log_path, "wb")
        return [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO)]
    address = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(world):
        f = open(log_path if r == 0 else f"{log_path}.{r}", "wb")
        procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
                                      env=dict(env, COORDINATOR_ADDRESS=address,
                                               NUM_PROCESSES=str(world), PROCESS_ID=str(r))))
    return procs


def _read(path):
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")


def _listening(path, procs, deadline):
    while time.monotonic() < deadline:
        m = re.search(r"服务已启动: http://[0-9.]+:(\d+)", _read(path))
        if m:
            return int(m.group(1))
        if procs[0].poll() is not None:
            break
        time.sleep(0.25)
    raise AssertionError(f"serve never listened:\n{_read(path)[-4000:]}")


def _post(port, path, data, timeout=600):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def cli_form(args, out_dir) -> dict:
    """The CLI as a user starts it (module docstring). Weights and
    galleries go to a temporary directory, the logs to out_dir/cli_logs."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="frt_cli_")
    try:
        return _cli_form(args, out_dir, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_form(args, out_dir, tmp) -> dict:
    import chip_smoke as cs
    from facerecognizeonnx_tpu_torch import FaceRecognizer, bridge
    from facerecognizeonnx_tpu_torch.config import PipelineConfig
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.utils.checkpoint import save_params

    world, cpu = args.world, args.cpu
    size = 128 if args.small else 640
    arch = "iresnet18" if args.small else "iresnet50"
    logs_dir = os.path.join(out_dir, "cli_logs")  # small files only, beside the summary
    os.makedirs(logs_dir, exist_ok=True)
    rng = np.random.default_rng(23)
    frames = rng.integers(0, 256, (16, size, size, 3), dtype=np.uint8)
    hw = (96, 128) if args.small else cs.TRAIN_HW
    root = os.path.join(tmp, "ids")
    images = cs.write_identity_folder(root, rng, hw)
    boxed = np.zeros((len(images), size, size, 3), np.uint8)
    boxed[:, :hw[0], :hw[1]] = np.stack(images)
    det_npz, rec_npz = os.path.join(tmp, "det.npz"), os.path.join(tmp, "rec.npz")
    # one detector finds faces on both the requests and the folder's images
    save_params(det_npz, cs.detection_bias(bridge.init_params_numpy("500m", seed=0),
                                           torch.from_numpy(np.concatenate([frames, boxed]))))
    save_params(rec_npz, bridge.init_params_numpy(arch, seed=1))
    feats = rng.normal(size=(1000, 512)).astype(np.float32)
    bank = GalleryBank(device="cpu")
    bank.add_batch([f"id{i}" for i in range(1000)],
                   feats / np.linalg.norm(feats, axis=1, keepdims=True))
    models = ["--det-model", det_npz, "--rec-model", rec_npz, "--det-size", str(size),
              "--rec-arch", arch] + (["--cpu"] if cpu else [])
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=REPO)
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    servers = {"one": ([], 1), "dp": (["--dp", "-1"], world), "sharded": (["--sharded"], world)}
    procs, logs = {}, {}
    t0 = time.perf_counter()
    deadline = time.monotonic() + 420
    try:
        for name, (extra, n) in servers.items():
            gallery = os.path.join(tmp, f"{name}.npz")
            bank.save(gallery)
            logs[name] = os.path.join(logs_dir, f"serve_{name}.log")
            procs[name] = _cli_start(["serve", "--port", "0", "--gallery", gallery, *models,
                                      *extra], n, cpu, logs[name], env)
        ports = {name: _listening(logs[name], procs[name], deadline) for name in servers}
        start_s = time.perf_counter() - t0
        pngs = [cs.png_bytes(f[..., ::-1].copy()) for f in frames]
        jobs = [(name, i) for name in servers for i in range(len(pngs))]
        with ThreadPoolExecutor(len(jobs)) as ex:
            got = list(ex.map(lambda j: _post(ports[j[0]], "/identify?top_k=3", pngs[j[1]]),
                              jobs))
        answers = {name: [a for (n, _), a in zip(jobs, got) if n == name] for name in servers}
        enrolled = {name: _post(port, "/enroll?name=alice", pngs[0])
                    for name, port in ports.items()}
        for name in servers:
            procs[name][0].send_signal(signal.SIGTERM)
        rcs = {name: [p.wait(timeout=max(1, deadline - time.monotonic())) for p in ps]
               for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    text = {name: _read(path) for name, path in logs.items()}
    for name in servers:
        assert rcs[name] == [0] * len(rcs[name]), (name, rcs[name], text[name][-4000:])
        assert enrolled[name] == {"enrolled": True, "name": "alice", "gallery_size": 1001}, \
            enrolled[name]
    res = {}
    backend = "gloo" if cpu else "nccl"
    for name in ("dp", "sharded"):
        assert f"进程组: {backend} × {world} rank" in text[name], text[name][-3000:]
        drained = re.search(r"所有 rank 已排空 \(请求, gallery 条数, 最后一条\): (.*)",
                            text[name]).group(1)
        assert drained == repr([(17, 1001, "alice")] * world), drained  # warm-up + 16
        faces = checked = 0
        sim_err = box_err = 0.0
        for a, b in zip(answers[name], answers["one"]):
            assert len(a["faces"]) == len(b["faces"]) and a["faces"], (name, a, b)
            for fa, fb in zip(a["faces"], b["faces"]):
                box_err = max(box_err, float(np.abs(np.subtract(fa["box"], fb["box"])).max()))
                sim_err = max(sim_err, float(np.abs(np.subtract(fa["sims"], fb["sims"])).max()))
                gaps = np.abs(np.diff(fb["sims"])) > 2 * SERVICE_BAR
                clear = np.concatenate([[True], gaps]) & np.concatenate([gaps, [False]])
                for p in np.nonzero(clear)[0]:
                    checked += 1
                    assert fa["names"][p] == fb["names"][p], (name, fa, fb)
                faces += 1
        assert box_err <= 1e-3 and sim_err <= SERVICE_BAR + 1e-9, (name, box_err, sim_err)
        res[f"serve_{name}"] = dict(faces=faces, names_checked=checked, box_max_abs_diff=box_err,
                                    sims_max_abs_diff=sim_err, drained=drained)
        started = ("here, through the launcher's variables" if cpu
                   else "by the CLI itself, no launcher variables given")
        print(f"cli serve {' '.join(servers[name][0])}: {world} ranks over {backend} (started "
              f"{started}), 16 concurrent /identify in float32 TF32 off vs a one-card serve: "
              f"{faces} faces, masks equal, boxes max|d| {box_err:.3g} px (bar 1e-3), names "
              f"equal on {checked} positions clear of near-ties, sims max|d| {sim_err:.3g} (bar "
              f"{SERVICE_BAR:g}); /enroll taken by every rank {drained}; SIGTERM → exit 0 on "
              f"every rank | the three servers listening {start_s:.1f} s after start",
              flush=True)
    # train --align over every card
    out_npz = os.path.join(tmp, "trained.npz")
    t0 = time.perf_counter()
    log = os.path.join(logs_dir, "train.log")
    ps = _cli_start(["train", root, "--align", "--steps", "20", "--det-model", det_npz,
                     "--det-size", str(size), "--rec-arch", arch, "--out", out_npz,
                     *(["--cpu"] if cpu else [])], world, cpu, log, env)
    try:
        rc = [p.wait(timeout=420) for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
    train_s = time.perf_counter() - t0
    text = _read(log)
    assert rc == [0] * len(ps), (rc, text[-4000:])
    assert f"mesh data={world}" in text and "训练完成: 20 步" in text, text[-3000:]
    rec = FaceRecognizer(PipelineConfig(compute_dtype="float32", rec_arch=arch),
                         device="cpu")
    assert rec.load_model(out_npz)
    crops_line = re.search(r"数据: .*", text).group(0)
    res["train"] = dict(seconds=train_s, mesh_data=world, crops=crops_line)
    print(f"cli train <root> --align --steps 20: {world} ranks, `mesh data={world}`, {train_s:.1f}"
          f" s; {crops_line}; the .npz loads as --rec-model", flush=True)
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--small", action="store_true")
    p.add_argument("--forms", default=",".join(FORMS))
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--summary", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank-child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.rank_child:
        return rank_main(args)
    unknown = set(args.forms.split(",")) - set(FORMS)
    if unknown:
        p.error(f"unknown forms {sorted(unknown)}; known: {', '.join(FORMS)}")
    if not args.cpu and torch.cuda.device_count() < args.world:
        print(f"{args.world} ranks need {args.world} cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "multichip_summary.json")
    summary = {"checks": {}}
    if set(args.forms.split(",")) & set(RANK_FORMS):
        argv = [a for a in sys.argv[1:] if a != "--rank-child"]
        procs = RankProcesses([sys.executable, os.path.abspath(__file__), *argv, "--rank-child",
                               "--summary", summary_path],
                              range(args.world), args.world, f"127.0.0.1:{free_port()}",
                              passthrough=[0])
        if procs.wait(args.timeout):
            return 1
        with open(summary_path) as f:
            summary = json.load(f)
    if "cli" in args.forms.split(","):
        summary["checks"]["cli"] = cli_form(args, out_dir)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
