#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py        # from the repo root, on a host with a CUDA card

Phases (any failure exits non-zero; there is no CPU path):
  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for the float32 checks
  2. build csrc/warp_xm.cu with nvcc for sm_90a (first use builds it)
  3. the warp kernel vs its plain-torch version on the card: 16 frames of
     640x640, K=8 faces each over pyramid levels 0-3, frame edges, one
     degenerate matrix and a mixed valid mask; raw and epilogue outputs;
     and 2 frames with odd sides (251x317);
     kernel, plain and pyramid times (median of 20, CUDA events)
  4. small-input agreement: frames_to_matches at 128x128 with iresnet18 in
     float32, kernel path on the card vs the port's CPU path (the plain
     warp, which tests/test_torch_pipeline.py holds against the JAX package)
  5. the main path at full width: SCRFD-500m at 640x640 and IResNet-50,
     both BN-folded, random weights from a seed, bfloat16, B=8 frames,
     K=8 face slots, through frames_to_matches against a 10,000 x 512
     gallery padded to 16,384 rows; then with skip_invalid_faces=False;
     the same detections through the plain warp (crops held against the
     kernel's at these shapes, features by cosine); frames/s and faces/s
     (median of 10 after warm-up) and a per-stage time split
  6. one JSON line of the kernels, the nvidia-smi line, and last
     {"ok": true, "device": {...}}

Detections recipe (tests/test_torch_pipeline.py uses it too): random
SCRFD weights score every anchor about σ(−4.59) ≈ 0.01, so nothing clears
0.5. `detection_bias` runs the detector once with the cls bias at 0 and
sets the bias to minus the median over frames of the midpoint between
each frame's 32nd and 33rd largest logits, so about 32 anchors per
frame clear 0.5.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.embed.pipeline import (
    _align_matrices,
    align_faces_batch,
    embed_crops,
)
from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
from facerecognizeonnx_tpu_torch.models import arcface, scrfd
from facerecognizeonnx_tpu_torch.ops import warp_cuda
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.pipeline.fused import detect_topk, frames_to_matches

EPI = (127.5, 128.0)


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters=20, warmup=3) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, iters=10, warmup=3) -> float:
    """Median host time of fn() in ms, synchronized (for code with host syncs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def face_matrix(scale, theta, tx, ty):
    """Forward src→dst similarity taking a face of the given scale and
    rotation around (tx, ty) to the 112 crop."""
    A = scale * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    Ainv = np.linalg.inv(A)
    return np.hstack([Ainv, (-Ainv @ np.array([tx, ty]))[:, None]]).astype(np.float32)


def spread_matrices(rng, B, K, H, W):
    scales = (0.6, 0.9, 1.3, 1.9, 2.6, 5.0, 11.0, 0.8)
    out = np.zeros((B, K, 2, 3), np.float32)
    for b in range(B):
        for k in range(K):
            edge = (k + b) % 3
            tx = (-10.0, W * 0.5, W - 8.0)[edge] + rng.uniform(-4, 4)
            ty = (H - 6.0, 12.0, H * 0.5)[edge] + rng.uniform(-4, 4)
            out[b, k] = face_matrix(scales[k % len(scales)], rng.uniform(-1.2, 1.2), tx, ty)
    out[0, K - 1] = 0.0  # degenerate
    return out


def ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def detection_bias(det_tree, frames_u8: torch.Tensor, per_frame=32):
    """A copy of the SCRFD tree whose cls bias lets ~per_frame anchors per
    frame clear 0.5 (module docstring)."""
    tree = {**det_tree, "head": {**det_tree["head"]}}
    tree["head"]["cls"] = {"w": det_tree["head"]["cls"]["w"],
                           "b": np.zeros_like(det_tree["head"]["cls"]["b"])}
    model = bridge.params_from_numpy(tree).to(frames_u8.device)
    x = (frames_u8.flip(-1).float() - 127.5) / 128.0
    with torch.no_grad():
        outs = model(x)
    logits = torch.logit(torch.cat([outs[s][0][..., 0] for s in (8, 16, 32)], -1))
    ranked = torch.sort(logits, dim=-1, descending=True).values
    nth = (ranked[:, per_frame - 1] + ranked[:, per_frame]) / 2  # between two anchors
    tree["head"]["cls"]["b"] = np.full_like(tree["head"]["cls"]["b"], -float(nth.median()))
    return tree


def check_features(feats, valid, n_rows=None, idx=None):
    assert torch.isfinite(feats).all(), "non-finite features"
    norms = feats.norm(dim=-1)
    assert torch.allclose(norms[valid], torch.ones_like(norms[valid]), atol=1e-3), norms[valid]
    assert (feats[~valid] == 0).all(), "invalid slots must be zero"
    if idx is not None:
        assert (idx[valid] < n_rows).all(), "a valid slot matched a padding row"


def main() -> int:
    # ---- 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {kind} x{torch.cuda.device_count()} | nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convolutions and matmuls (float32 checks run in full f32)")

    # ---- 2. build
    t0 = time.perf_counter()
    _, build_log = warp_cuda.build_library()
    log(f"build csrc/warp_xm.cu: {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  nvcc: {line.strip()}")

    # ---- 3. the kernel vs its plain version
    rng = np.random.default_rng(0)
    B, K, H, W = 16, 8, 640, 640
    frames = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    Ms = torch.from_numpy(spread_matrices(rng, B, K, H, W)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(B, K)) < 0.6).to(dev)
    pyr = warp_cuda.build_pyramid_xm(frames)
    prm = warp_cuda.face_params_xm(Ms)
    levels = sorted(set(prm[:, 0].int().tolist()))
    assert levels == [0, 1, 2, 3], levels
    before = warp_cuda.warp_affine_xm.launches
    raw = warp_cuda.resample_xm(pyr, prm, H, W, K)
    raw_ref = warp_cuda.resample_xm_reference(pyr, prm, H, W, K)
    epi = warp_cuda.resample_xm(pyr, prm, H, W, K, EPI, valid)
    epi_ref = warp_cuda.resample_xm_reference(pyr, prm, H, W, K, EPI, valid)
    full = warp_cuda.warp_affine_xm(frames, Ms, EPI, valid)
    torch.cuda.synchronize()
    assert warp_cuda.warp_affine_xm.launches == before + 3
    assert torch.isfinite(raw).all()
    raw_err = float((raw - raw_ref).abs().max())
    epi_diff = (epi.float() - epi_ref.float()).abs()
    epi_err = float(epi_diff.max())
    assert raw_err <= 1e-3, f"raw warp deviates {raw_err}"
    assert (epi_diff <= ulp_bf16(epi_ref)).all(), f"epilogue deviates {epi_err}"
    assert (epi[~valid] == 0).all() and (full[~valid] == 0).all()
    assert torch.equal(full, epi)
    # odd frame sides: level sizes floor, so the kernel's level offsets differ
    odd = torch.from_numpy(rng.integers(0, 256, (2, 251, 317, 3), dtype=np.uint8)).to(dev)
    odd_Ms = torch.from_numpy(spread_matrices(rng, 2, K, 251, 317)).to(dev)
    odd_pyr, odd_prm = warp_cuda.build_pyramid_xm(odd), warp_cuda.face_params_xm(odd_Ms)
    odd_err = float(
        (warp_cuda.resample_xm(odd_pyr, odd_prm, 251, 317, K)
         - warp_cuda.resample_xm_reference(odd_pyr, odd_prm, 251, 317, K)).abs().max()
    )
    assert odd_err <= 1e-3, f"raw warp deviates {odd_err} on 251x317 frames"
    raw_err = max(raw_err, odd_err)
    log(f"warp kernel vs plain (B={B}, K={K}, {H}x{W}, levels {levels}; and 2 frames "
        f"of 251x317): raw max|d| {raw_err:.3g} (bar 1e-3), epilogue max|d| "
        f"{epi_err:.3g} (bar 1 bf16 ulp)")

    all_valid = torch.ones_like(valid)
    kernel_ms = event_ms(lambda: warp_cuda.resample_xm(pyr, prm, H, W, K, EPI, all_valid))
    plain_ms = event_ms(
        lambda: warp_cuda.resample_xm_reference(pyr, prm, H, W, K, EPI, all_valid)
    )
    pyr_ms = event_ms(lambda: warp_cuda.build_pyramid_xm(frames))
    params_ms = event_ms(lambda: warp_cuda.face_params_xm(Ms))
    wrapper_ms = event_ms(lambda: warp_cuda.warp_affine_xm(frames, Ms, EPI, all_valid))
    log(f"warp times (B={B}, K={K}, epilogue, all slots valid; median of 20): "
        f"kernel {kernel_ms:.4f} ms | plain {plain_ms:.4f} ms | pyramid {pyr_ms:.4f} ms "
        f"| face table {params_ms:.4f} ms | whole warp_affine_xm {wrapper_ms:.4f} ms")

    # ---- 4. small input: the card's kernel path vs the port's CPU path (f32)
    small_cfg = PipelineConfig(det_input_size=128, compute_dtype="float32", warp_impl="cuda")
    small_frames = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    small_det_tree = detection_bias(
        bridge.init_params_numpy("500m", seed=3), torch.from_numpy(small_frames)
    )
    small_det = bridge.params_from_numpy(small_det_tree)
    small_rec = bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=4))
    small_bank = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(48, 512)).astype(np.float32)), dim=-1
    )
    with torch.no_grad():
        cpu = frames_to_matches(small_det, small_rec, torch.from_numpy(small_frames),
                                small_bank, 40, small_cfg, 4, 3)
        warp_cuda.warp_affine_xm.launches = 0
        gpu = frames_to_matches(small_det.to(dev), small_rec.to(dev),
                                torch.from_numpy(small_frames).to(dev),
                                small_bank.to(dev), 40, small_cfg, 4, 3)
        torch.cuda.synchronize()
    small_launches = warp_cuda.warp_affine_xm.launches
    assert small_launches > 0
    gdets, gfeats = gpu[0], gpu[1].cpu()
    assert torch.equal(gdets.valid.cpu(), cpu[0].valid), "detections differ GPU vs CPU"
    box_err = float((gdets.boxes.cpu() - cpu[0].boxes).abs().max())
    sv = cpu[0].valid[:, :4]
    assert sv.any(), "small input found no faces"
    small_cos = float((gfeats * cpu[1]).sum(-1)[sv].min())
    assert box_err <= 1e-2 and small_cos >= 1 - 1e-4, (box_err, small_cos)
    log(f"small input 128x128 f32, card vs CPU path: valid masks equal, "
        f"boxes max|d| {box_err:.3g}, feature cos min {small_cos:.7f}, "
        f"{int(sv.sum())} faces, warp launches {small_launches}")

    # ---- 5. the main path at full width
    B, K, TOP_K, N_ROWS, G_PAD = 8, 8, 5, 10_000, 16_384
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    frames = torch.from_numpy(
        rng.integers(0, 256, (B, 640, 640, 3), dtype=np.uint8)
    ).to(dev)
    det_tree = detection_bias(bridge.init_params_numpy("500m", seed=0), frames)
    det = scrfd.fold_inference_params(bridge.params_from_numpy(det_tree)).to(dev)
    rec = arcface.fold_inference_params(
        bridge.params_from_numpy(bridge.init_params_numpy("iresnet50", seed=1))
    ).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    bank = torch.zeros((G_PAD, 512), dtype=torch.float32)
    bank[:N_ROWS] = torch.nn.functional.normalize(torch.randn(N_ROWS, 512, generator=gen), dim=-1)
    bank = bank.to(dev)

    def run(c):
        return frames_to_matches(det, rec, frames, bank, N_ROWS, c, K, TOP_K)

    with torch.no_grad():
        warp_cuda.warp_affine_xm.launches = 0
        dets, feats, sims, idx = run(cfg)
        torch.cuda.synchronize()
        main_launches = warp_cuda.warp_affine_xm.launches
        assert main_launches > 0, "the main path did not launch the warp kernel"
        slot_valid = dets.valid[:, :K]
        assert slot_valid.any(dim=-1).all(), "a frame found no faces"
        check_features(feats, slot_valid, N_ROWS, idx)
        assert feats.shape == (B, K, 512) and sims.shape == idx.shape == (B, K, TOP_K)

        noskip_cfg = dataclasses.replace(cfg, skip_invalid_faces=False)
        warp_cuda.warp_affine_xm.launches = 0
        _, feats_ns, _, idx_ns = run(noskip_cfg)
        torch.cuda.synchronize()
        noskip_launches = warp_cuda.warp_affine_xm.launches
        assert noskip_launches > 0
        check_features(feats_ns, slot_valid, N_ROWS, idx_ns)
        noskip_cos = float((feats_ns * feats).sum(-1)[slot_valid].min())
        assert noskip_cos >= 0.999, noskip_cos

        # the same detections through the plain warp; the kernel's crops at
        # the main path's shapes held against it
        M = _align_matrices(dets.kps[:, :K], dets.boxes[:, :K], 640, 640, 112)
        crops = warp_cuda.warp_affine_xm_reference(frames, M, EPI, slot_valid)
        kcrops = warp_cuda.warp_affine_xm(frames, M, EPI, slot_valid)
        main_diff = (kcrops.float() - crops.float()).abs()
        main_err = float(main_diff.max())
        assert (main_diff <= ulp_bf16(crops)).all(), f"main-path crops deviate {main_err}"
        plain = embed_crops(rec, crops.reshape(B * K, 112, 112, 3), cfg, normalized=True)
        plain = plain.reshape(B, K, -1) * slot_valid[..., None]
        plain_cos = float((plain * feats).sum(-1)[slot_valid].min())
        assert plain_cos >= 0.999, plain_cos
    occupancy = int(slot_valid.sum())
    log(f"main path (SCRFD-500m 640 + IResNet-50, folded, bf16, B={B}, K={K}, gallery "
        f"{N_ROWS}/{G_PAD} rows): {occupancy}/{B * K} slots occupied, "
        f"{int(dets.count().sum())} detections; warp launches {main_launches} "
        f"(skip) / {noskip_launches} (no skip); kernel vs plain crops max|d| "
        f"{main_err:.3g} (bar 1 bf16 ulp); cos vs no-skip {noskip_cos:.6f}, "
        f"vs plain warp {plain_cos:.6f} (bar 0.999)")

    with torch.no_grad():
        step_ms = wall_ms(lambda: run(cfg))
        noskip_ms = wall_ms(lambda: run(noskip_cfg))
        # per-stage split of one step (host clock, synchronized)
        _, top = detect_topk(det, frames, cfg, K)
        crops = align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
        flat = crops.reshape(B * K, 112, 112, 3)
        f = embed_crops(rec, flat, cfg, normalized=True)
        detect_ms = wall_ms(lambda: detect_topk(det, frames, cfg, K))
        align_ms = wall_ms(
            lambda: align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
        )
        embed_ms = wall_ms(lambda: embed_crops(rec, flat, cfg, normalized=True))
        match_ms = wall_ms(lambda: topk_stable(similarity_matrix(f, bank), TOP_K))
    log(f"main path step (median of 10): {step_ms:.3f} ms = {B / step_ms * 1e3:.1f} "
        f"frames/s, {B * K / step_ms * 1e3:.1f} faces/s (K={K} slots per frame); "
        f"skip_invalid_faces=False {noskip_ms:.3f} ms | card: {smi}")
    log(f"stages (median of 10): detect+NMS {detect_ms:.3f} ms | align+warp "
        f"{align_ms:.3f} ms | embed {embed_ms:.3f} ms | match {match_ms:.3f} ms | "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    # ---- 6. result lines
    log(json.dumps({"kernels": [{
        "name": "warp_xm",
        "route": "cuda",
        "source": "facerecognizeonnx_tpu_torch/csrc/warp_xm.cu",
        "replaces": "facerecognizeonnx_tpu/ops/warp_pallas.py:273 (_kernel_xm)",
        "launches": main_launches,
        "max_abs_err": raw_err,
        "max_abs_dev": raw_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
