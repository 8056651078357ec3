#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py        # from the repo root, on a host with a CUDA card

Phases (any failure exits non-zero; there is no CPU path):
  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for the float32 checks
  2. build every csrc/*.cu with nvcc for sm_90a, one nvcc per source, all
     started together
  3. the x-major warp kernel vs its plain-torch version on the card: 16
     frames of 640x640, K=8 faces each over pyramid levels 0-3, frame
     edges, one degenerate matrix and a mixed valid mask; raw and
     epilogue outputs; and 2 frames with odd sides (251x317); kernel,
     plain and pyramid times (median of 20, CUDA events)
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
  6. the y-major warp kernel vs its plain version on phase 3's frames and
     matrices (raw and xpass_bf16; times, median of 20), then its path:
     `warp_cuda.warp_affine` with its default layout
  7. the gallery top-k kernel vs its plain version at Q=128, G=100,000,
     D=512 with 1,000 planted duplicate rows, k=5 and k=512; G=5, k=5
     (padding never wins); self-queries; kernel, plain and library
     composite times (median of 20)
  8. `GalleryBank.search(method="auto")` on a 1,000,000 x 512 bank with
     2,048 queries (Q·G > 2·10^9): it must launch the gallery kernel once;
     64 of its rows held against the plain version
  9. the identify path at full width: FaceDetector (SCRFD-500m, 640) and
     FaceRecognizer (IResNet-50, bf16) on the card, enroll_batch of 64
     frames plus 9,936 random rows (a 10,000-row bank), IdentifyService
     two-dispatch and fuse_search with 64 concurrent requests each
 10. one JSON line of the kernels, the nvidia-smi line, and last
     {"ok": true, "device": {...}}

Each path is driven with every launch counter set to 0 just before it
and read just after; launches made to compare a kernel with its plain
version are not counted.

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
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from facerecognizeonnx_tpu_torch import FaceDetector, FaceRecognizer, bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.embed.pipeline import (
    _align_matrices,
    align_faces_batch,
    embed_crops,
)
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
from facerecognizeonnx_tpu_torch.models import arcface, scrfd
from facerecognizeonnx_tpu_torch.ops import gallery_cuda, warp_cuda
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.pipeline.enroll import enroll_batch
from facerecognizeonnx_tpu_torch.pipeline.fused import detect_topk, frames_to_matches
from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService, _Request
from facerecognizeonnx_tpu_torch.utils import checkpoint

EPI = (127.5, 128.0)
# the card's published peaks (H100 SXM data sheet, at 700 W): device
# memory rate, and float32 outside the tensor cores (an FMA is 2 ops)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per output pixel of the warp kernels, counted from
# their source (coordinates, 4 hat weights, 4 y taps and 2 x taps on 3
# channels; the epilogue adds 6)
WARP_OPS_PER_PIXEL = 80
COUNTERS = {
    "warp_xm": warp_cuda.warp_affine_xm,
    "warp_ym": warp_cuda.warp_affine_ym,
    "gallery_topk": gallery_cuda.gallery_topk_cuda,
}
BUILDS = {
    "warp_xm.cu": warp_cuda.build_library,
    "warp_ym.cu": warp_cuda.build_library_ym,
    "gallery_topk.cu": gallery_cuda.build_library,
}


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
    model = bridge.params_from_numpy(tree, frames_u8.device)
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


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def warp_read_bytes(prm, H, W, K, win_x, win_y, valid=None) -> int:
    """Distinct pyramid bytes that a warp over this face table reads:
    the 2x2 taps of every output pixel of every computed face that fall
    inside its window and its level (3 bytes each)."""
    dev = prm.device
    sizes = warp_cuda.level_sizes(H, W)
    offs = torch.tensor([0] + list(np.cumsum([h * w for h, w in sizes])[:-1]), device=dev)
    frame_px = sum(h * w for h, w in sizes)
    faces = torch.arange(prm.shape[0], device=dev)
    if valid is not None:
        faces = faces[valid.reshape(-1)]
    p = prm[faces]
    level = p[:, 0].long()
    hl = torch.tensor([h for h, _ in sizes], device=dev)[level][:, None]
    wl = torch.tensor([w for _, w in sizes], device=dev)[level][:, None]
    pix = torch.arange(112 * 112, device=dev, dtype=torch.float32)
    fi, fj = torch.floor(pix / 112), pix % 112
    lx = (p[:, 3:4] * fj + p[:, 4:5] * fi + p[:, 7:8]).clamp(-2.0, win_x + 1.0)
    ly = (p[:, 5:6] * fj + p[:, 6:7] * fi + p[:, 8:9]).clamp(-2.0, win_y + 1.0)
    ids = []
    for dx in (0, 1):
        for dy in (0, 1):
            xw, yw = torch.floor(lx).long() + dx, torch.floor(ly).long() + dy
            gx, gy = p[:, 1:2].long() + xw, p[:, 2:3].long() + yw
            ok = (xw >= 0) & (xw < win_x) & (yw >= 0) & (yw < win_y) & (gx < wl) & (gy < hl)
            pid = (faces // K)[:, None] * frame_px + offs[level][:, None] + gy * wl + gx
            ids.append(pid[ok])
    return 3 * int(torch.unique(torch.cat(ids)).numel())


def check_topk(kv, ki, rv, ri, r_next, bar=1e-5):
    """Kernel top-k (kv, ki) vs plain (rv, ri): sims within `bar`; indices
    identical wherever the plain sims around a position (r_next: the
    plain (k+1)-th value, past the last column) differ by more than
    `bar`; equal sims in ascending index. Returns (max |Δsim|, ties)."""
    err = float((kv - rv).abs().max())
    assert err <= bar, f"gallery sims deviate {err}"
    nxt = torch.cat([rv[:, 1:], r_next[:, None]], 1)
    prev = torch.cat([torch.full_like(rv[:, :1], float("inf")), rv[:, :-1]], 1)
    clear = ((prev - rv) > bar) & ((rv - nxt) > bar)
    assert torch.equal(ki[clear], ri[clear].to(ki.dtype)), "gallery indices differ"
    ties = kv[:, 1:] == kv[:, :-1]
    assert (ki[:, 1:] > ki[:, :-1])[ties].all(), "tied sims not in ascending index"
    return err, int(ties.sum())


def build_all() -> float:
    """Build every kernel source at once (one nvcc each); log ptxas."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        logs = dict(zip(BUILDS, pool.map(lambda fn: fn()[1], BUILDS.values())))
    secs = time.perf_counter() - t0
    log(f"build {', '.join('csrc/' + s for s in BUILDS)} in parallel: {secs:.2f} s")
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {source}: {line.strip()}")
    return secs


def phase_ymajor(frames, Ms, odd, odd_Ms, K) -> dict:
    """The y-major kernel vs its plain version, then its path."""
    H, W = frames.shape[1:3]
    pyr, prm = warp_cuda.build_pyramid(frames), warp_cuda.face_params_ym(Ms)
    odd_pyr, odd_prm = warp_cuda.build_pyramid(odd), warp_cuda.face_params_ym(odd_Ms)
    oh, ow = odd.shape[1:3]
    err = 0.0
    for xbf in (False, True):
        for p_, q_, h, w in ((pyr, prm, H, W), (odd_pyr, odd_prm, oh, ow)):
            got = warp_cuda.resample_ym(p_, q_, h, w, K, xbf)
            want = warp_cuda.resample_ym_reference(p_, q_, h, w, K, xbf)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            d = float((got - want).abs().max())
            assert d <= 1e-3, f"y-major warp deviates {d} (xpass_bf16={xbf}, {h}x{w})"
            err = max(err, d)
    ms = event_ms(lambda: warp_cuda.resample_ym(pyr, prm, H, W, K))
    plain_ms = event_ms(lambda: warp_cuda.resample_ym_reference(pyr, prm, H, W, K))
    bf16_ms = event_ms(lambda: warp_cuda.resample_ym(pyr, prm, H, W, K, True))
    n_out = prm.shape[0] * 112 * 112
    bound, by = bound_ms(
        warp_read_bytes(prm, H, W, K, warp_cuda.YM_WIN_X, warp_cuda.YM_WIN_Y)
        + prm.numel() * 4 + n_out * 3 * 4,
        n_out * WARP_OPS_PER_PIXEL,
    )
    # its path: the counterpart of warp_affine_pallas, default layout
    reset_counts()
    out = warp_cuda.warp_affine(frames, Ms)
    torch.cuda.synchronize()
    launches = read_counts()["warp_ym"]
    assert launches > 0, "warp_affine(layout='ymajor') did not launch the kernel"
    assert torch.equal(out, warp_cuda.resample_ym(pyr, prm, H, W, K))
    log(f"y-major warp kernel vs plain (B={frames.shape[0]}, K={K}, {H}x{W}; 2 frames of "
        f"{oh}x{ow}; raw and xpass_bf16): max|d| {err:.3g} (bar 1e-3); times (median of 20): "
        f"kernel {ms:.4f} ms (xpass_bf16 {bf16_ms:.4f} ms) | plain {plain_ms:.4f} ms | "
        f"bound {bound:.4f} ms ({by}); warp_affine(default layout) launches {launches}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def _gallery(gen, Q, G, D, dev, dups=0):
    g = torch.nn.functional.normalize(torch.randn(G, D, generator=gen, device=dev), dim=-1)
    q = torch.nn.functional.normalize(torch.randn(Q, D, generator=gen, device=dev), dim=-1)
    if dups:
        perm = torch.randperm(G, generator=gen, device=dev)
        src, dst = perm[:dups // 2], perm[dups // 2: dups]
        g[dst] = g[src]  # each source row now has an exact copy elsewhere
        q[: min(Q, 16)] = g[src[: min(Q, 16)]]  # queries whose top-k ties
    return q, g


def phase_gallery(dev) -> dict:
    """The gallery kernel vs its plain version; times at Q=128, G=100,000."""
    gen = torch.Generator(device=dev).manual_seed(5)
    Q, G, D = 128, 100_000, 512
    q, g = _gallery(gen, Q, G, D, dev, dups=1_000)
    err, ties = 0.0, {}
    for k in (5, 512):
        kv, ki = gallery_cuda.gallery_topk_cuda(q, g, k)
        rv, ri = gallery_cuda.gallery_topk_reference(q, g, k + 1)
        torch.cuda.synchronize()
        e, ties[k] = check_topk(kv, ki, rv[:, :k], ri[:, :k], rv[:, k])
        err = max(err, e)
        assert ties[k] > 0, "the planted duplicates made no tie"
    # padding never wins (k = G = 5), and self-queries rank first at 1.0
    q5, g5 = _gallery(gen, 3, 5, D, dev)
    kv, ki = gallery_cuda.gallery_topk_cuda(q5, g5 * 0.01, 5)
    assert int(ki.max()) < 5 and torch.isfinite(kv).all()
    assert torch.equal(ki.sort(dim=1).values.cpu(), torch.arange(5).repeat(3, 1).int())
    kv, ki = gallery_cuda.gallery_topk_cuda(g[:8], g, 2)  # (or an exact copy of itself)
    assert (kv[:, 0] >= 1.0 - 1e-5).all() and torch.equal(g[ki[:, 0].long()], g[:8])
    ms = event_ms(lambda: gallery_cuda.gallery_topk_cuda(q, g, 5))
    plain_ms = event_ms(lambda: gallery_cuda.gallery_topk_reference(q, g, 5))
    half = torch.full((1,), 0.5, device=dev)
    library_ms = event_ms(lambda: torch.topk(torch.addmm(half, q, g.t(), alpha=0.5), 5))
    ms_512 = event_ms(lambda: gallery_cuda.gallery_topk_cuda(q, g, 512), iters=5)
    bound, by = bound_ms(4 * (Q * D + G * D) + 8 * Q * 5, 2 * Q * G * D)
    log(f"gallery kernel vs plain (Q={Q}, G={G}, D={D}, 1,000 planted duplicate rows; "
        f"k=5 and k=512): sims max|d| {err:.3g} (bar 1e-5), indices identical outside "
        f"1e-5 near-ties, {ties[5]} / {ties[512]} exact ties in ascending index; G=5 k=5 "
        f"no padding; self-queries first at 1.0; times k=5 (median of 20): kernel "
        f"{ms:.4f} ms | plain {plain_ms:.4f} ms | library composite topk(addmm) "
        f"{library_ms:.4f} ms | bound {bound:.4f} ms ({by}); k=512 kernel {ms_512:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def phase_auto(dev, G=1_000_000, Q=2_048) -> int:
    """GalleryBank.search(method="auto") past the 2·10^9 boundary on a
    CUDA bank must stream through the kernel; returns its launches."""
    gen = torch.Generator(device=dev).manual_seed(6)
    D = 512
    q, g = _gallery(gen, Q, G, D, dev)
    bank = GalleryBank(D, device=dev)
    bank.add_batch([f"row{i}" for i in range(G)], g.cpu().numpy())
    del g
    queries = q.cpu().numpy()
    bank.search(queries[:1], 1)  # uploads the bank (cached on its version)
    reset_counts()
    t0 = time.perf_counter()
    names, sims = bank.search(queries, 5, method="auto")
    secs = time.perf_counter() - t0
    launches = read_counts()["gallery_topk"]
    assert launches == 1, f"auto search launched the gallery kernel {launches} times"
    assert len(names) == Q and sims.shape == (Q, 5)
    rv, ri = gallery_cuda.gallery_topk_reference(q[:64], bank._device_feats(), 6)
    idx = torch.tensor([[int(n[3:]) for n in row] for row in names[:64]], device=dev)
    err, _ = check_topk(torch.from_numpy(sims[:64]).to(dev), idx, rv[:, :5], ri[:, :5],
                        rv[:, 5])
    log(f"GalleryBank.search(method='auto') at Q={Q} x G={G:,} (Q·G = {Q * G:.3g} > 2e9, "
        f"bank {G * D * 4 / 1e9:.2f} GB on the card): gallery kernel launches {launches}; "
        f"first 64 rows vs plain: sims max|d| {err:.3g}; one search {secs * 1e3:.1f} ms "
        f"(host clock, queries in and names out)")
    del bank
    torch.cuda.empty_cache()
    return launches


def phase_identify(dev, rng, cfg=None, n_enroll=64, n_bank=10_000, n_req=64) -> dict:
    """The 1:N identify path at full width through the user entry points."""
    cfg = cfg or PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    size = cfg.det_input_size
    frames = rng.integers(0, 256, (n_enroll, size, size, 3), dtype=np.uint8)
    det, rec = FaceDetector(cfg, device=dev), FaceRecognizer(cfg, device=dev)
    tree = detection_bias(bridge.init_params_numpy(cfg.scrfd_variant, seed=cfg.seed),
                          torch.from_numpy(frames).to(dev))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "det.npz")
        checkpoint.save_params(path, tree)
        assert det.load_model(path), "FaceDetector.load_model failed"
    assert rec.load_model(), "FaceRecognizer.load_model failed"
    names = [f"person{i:02d}" for i in range(n_enroll)]
    reset_counts()
    t0 = time.perf_counter()
    bank, kept = enroll_batch(det, rec, names, list(frames), device=dev)
    torch.cuda.synchronize()
    enroll_s = time.perf_counter() - t0
    assert kept == names, f"enrolled {len(kept)} of {n_enroll} frames"
    extra = np.random.default_rng(7).normal(size=(n_bank - n_enroll, 512)).astype(np.float32)
    bank.add_batch([f"random{i}" for i in range(len(extra))], extra)
    assert len(bank) == n_bank
    requests = [frames[i % n_enroll] for i in range(n_req)]
    results, rates, lat = {}, {}, {}
    for mode in ("two-dispatch", "fuse_search"):
        kw = dict(max_batch=8, max_faces=8, search_top_k=5, fuse_search=mode == "fuse_search",
                  device=dev)
        warm = IdentifyService(det.params, rec.params, bank, cfg, **kw)
        [f.result(300) for f in [warm.identify_async(im, 5) for im in requests[:16]]]
        warm.close()
        svc = IdentifyService(det.params, rec.params, bank, cfg, **kw)
        t0 = time.perf_counter()
        futs = [svc.identify_async(im, 5) for im in requests]
        results[mode] = [f.result(300) for f in futs]
        wall = time.perf_counter() - t0
        st = svc.stats()
        svc.close()
        rates[mode] = n_req / wall
        lat[mode] = st["latency_ms"]
    counts = read_counts()
    assert counts["warp_xm"] > 0, "the identify path did not launch the warp kernel"
    # one batch of 8 split by hand (the service is closed): host letterbox,
    # dispatch (letterbox included; synchronized), resolve; median of 5
    splits = []
    for _ in range(5):
        batch = [_Request(image=im, top_k=5) for im in requests[:8]]
        t0 = time.perf_counter()
        for r in batch:
            svc._letterbox(r.image)
        t1 = time.perf_counter()
        ctx = svc._dispatch(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        svc._resolve(ctx)
        t3 = time.perf_counter()
        splits.append(((t1 - t0) * 1e3, (t2 - t1 - (t1 - t0)) * 1e3, (t3 - t2) * 1e3))
    lb_ms, disp_ms, res_ms = (statistics.median(x) for x in zip(*splits))
    sim_err, exact = 0.0, 0
    for a, b in zip(results["two-dispatch"], results["fuse_search"]):
        assert np.array_equal(a.valid, b.valid) and a.valid[0], "slot 0 empty or masks differ"
        sim_err = max(sim_err, float(np.abs(a.sims - b.sims).max()))
        exact += a.names == b.names
        for j in np.nonzero(a.valid)[0]:
            gaps = np.abs(np.diff(a.sims[j])) > 1e-5  # near-ties may swap
            clear = np.concatenate([[True], gaps]) & np.concatenate([gaps, [True]])
            assert [n for n, c in zip(a.names[j], clear) if c] == \
                [n for n, c in zip(b.names[j], clear) if c], (a.names[j], b.names[j])
        assert a.sims[0, 0] >= 0.99, f"a request's top-1 sim is {a.sims[0, 0]}"
    assert sim_err <= 1e-3, sim_err
    top1 = min(float(r.sims[0, 0]) for r in results["two-dispatch"])
    log(f"identify path (SCRFD-500m {size} + {cfg.rec_arch} {cfg.compute_dtype}, enroll "
        f"{n_enroll} frames in "
        f"{enroll_s:.2f} s, bank {len(bank):,} rows; IdentifyService max_batch=8, "
        f"max_faces=8, search_top_k=5, {n_req} concurrent requests): two-dispatch "
        f"{rates['two-dispatch']:.1f} req/s p50 {lat['two-dispatch']['p50']} ms p99 "
        f"{lat['two-dispatch']['p99']} ms | fuse_search {rates['fuse_search']:.1f} req/s "
        f"p50 {lat['fuse_search']['p50']} ms p99 {lat['fuse_search']['p99']} ms; modes: "
        f"{exact}/{n_req} identical name lists (the rest differ only inside 1e-5 "
        f"near-ties), sims max|d| {sim_err:.3g} (bar 1e-3); top-1 sim min {top1:.5f} "
        f"(bar 0.99); one fuse_search batch of 8 by hand: host letterbox {lb_ms:.2f} ms, "
        f"dispatch less letterbox {disp_ms:.2f} ms, resolve {res_ms:.2f} ms (median of 5); "
        f"launches {counts}")
    return counts


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

    # ---- 2. build every kernel source
    build_all()

    # ---- 3. the kernel vs its plain version
    rng = np.random.default_rng(0)
    B, K, H, W = 16, 8, 640, 640
    frames = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    Ms = torch.from_numpy(spread_matrices(rng, B, K, H, W)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(B, K)) < 0.6).to(dev)
    pyr = warp_cuda.build_pyramid(frames)
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
    odd_pyr, odd_prm = warp_cuda.build_pyramid(odd), warp_cuda.face_params_xm(odd_Ms)
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
    pyr_ms = event_ms(lambda: warp_cuda.build_pyramid(frames))
    params_ms = event_ms(lambda: warp_cuda.face_params_xm(Ms))
    wrapper_ms = event_ms(lambda: warp_cuda.warp_affine_xm(frames, Ms, EPI, all_valid))
    xm_bound, xm_by = bound_ms(
        warp_read_bytes(prm, H, W, K, warp_cuda.WIN_X, warp_cuda.WIN_Y, all_valid)
        + prm.numel() * 4 + B * K * 112 * 112 * 3 * 2,
        B * K * 112 * 112 * WARP_OPS_PER_PIXEL,
    )
    log(f"warp times (B={B}, K={K}, epilogue, all slots valid; median of 20): "
        f"kernel {kernel_ms:.4f} ms | plain {plain_ms:.4f} ms | pyramid {pyr_ms:.4f} ms "
        f"| face table {params_ms:.4f} ms | whole warp_affine_xm {wrapper_ms:.4f} ms | "
        f"bound {xm_bound:.4f} ms ({xm_by})")
    warp_case = (frames, Ms, odd, odd_Ms, K)

    # ---- 4. small input: the card's kernel path vs the port's CPU path (f32)
    small_cfg = PipelineConfig(det_input_size=128, compute_dtype="float32", warp_impl="cuda")
    small_frames = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    small_det_tree = detection_bias(
        bridge.init_params_numpy("500m", seed=3), torch.from_numpy(small_frames)
    )
    small_det = bridge.params_from_numpy(small_det_tree, "cpu")
    small_rec = bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=4), "cpu")
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
    det = scrfd.fold_inference_params(bridge.params_from_numpy(det_tree, dev))
    rec = arcface.fold_inference_params(
        bridge.params_from_numpy(bridge.init_params_numpy("iresnet50", seed=1), dev)
    )
    gen = torch.Generator(device="cpu").manual_seed(2)
    bank = torch.zeros((G_PAD, 512), dtype=torch.float32)
    bank[:N_ROWS] = torch.nn.functional.normalize(torch.randn(N_ROWS, 512, generator=gen), dim=-1)
    bank = bank.to(dev)

    def run(c):
        return frames_to_matches(det, rec, frames, bank, N_ROWS, c, K, TOP_K)

    with torch.no_grad():
        reset_counts()
        dets, feats, sims, idx = run(cfg)
        torch.cuda.synchronize()
        main_launches = read_counts()["warp_xm"]
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

    # ---- 6. the y-major warp kernel, and its path
    ym = phase_ymajor(*warp_case)

    # ---- 7. the gallery top-k kernel vs its plain version
    gallery = phase_gallery(dev)

    # ---- 8. GalleryBank.search(method="auto") past the 2·10^9 boundary
    gallery["launches"] = phase_auto(dev)

    # ---- 9. the identify path at full width
    phase_identify(dev, rng)

    # ---- 10. result lines
    kernels = [
        dict(name="warp_xm", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/warp_xm.cu",
             replaces="facerecognizeonnx_tpu/ops/warp_pallas.py:273 (_kernel_xm)",
             launches=main_launches, max_abs_err=raw_err, ms=kernel_ms, plain_ms=plain_ms,
             bound_ms=xm_bound, bound_by=xm_by, library_ms=None),
        dict(name="warp_ym", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/warp_ym.cu",
             replaces="facerecognizeonnx_tpu/ops/warp_pallas.py:101 (_kernel)", **ym),
        dict(name="gallery_topk", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/gallery_topk.cu",
             replaces="facerecognizeonnx_tpu/ops/pallas_gallery.py:60 (_kernel)", **gallery),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
