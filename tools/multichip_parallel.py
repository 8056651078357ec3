"""The parallel layer (`facerecognizeonnx_tpu_torch/parallel/`) over N
ranks, one device each, over NCCL on N cards (or Gloo on the CPU).

chip_smoke.py phase 16 runs every parallel function as one rank on one
card. This tool runs the multi-rank forms where each rank has its own
card: it starts N processes of itself, which meet through
`init_distributed` (COORDINATOR_ADDRESS on a free localhost port,
NUM_PROCESSES, PROCESS_ID) and each drive cuda:{rank}. Checks, each
against the plain single-device call (rank 0 prints them):

  dp      `make_dp_program` on 8 frames per rank (SCRFD-500m 640² +
          IResNet-50, folded, bf16, K=8): each rank's block bit-equal to
          the eager `frames_to_features` on that block; one warp_xm, one
          pyramid and one nms_greedy launch per rank per call; the dp
          step (N × 8 frames) against the eager step on 8 and on N × 8
          frames on one card, wall, synchronized, median of 10 [min–max]
  search  `sharded_topk_search` at Q=128, G=1,000,000, D=512, k=5 (rows
          over the N ranks) against `gallery_topk_reference` on one
          card: sims within 1.67e-6, indices equal outside near-ties;
          eager times (between CUDA events, median of 20) of the sharded,
          dense and kernel searches
  tp      `tp_embed_crops` over an N-wide "model" axis, 64 IResNet-50
          crops in float32 (TF32 off), against `embed_crops`: rtol 1e-4,
          atol 1e-5
  ep      `ep_embed_crops` with N seeded IResNet-50 experts, one per
          rank, 64 crops in float32: every face within 1e-5 of its
          expert alone
  pp      `pipelined_frames_to_features` on a ("data", "stage")
          (N/2, 2) mesh, 8 frames in float32: masks equal, boxes rtol
          1e-5 / atol 1e-4, features rtol 1e-4 / atol 1e-5 against the
          fused step
  service `IdentifyService(mesh=N, sharded=True)` on every rank against
          the plain service on 16 requests in float32 (TF32 off): masks
          equal, names equal clear of near-ties and sims within 1e-4 (a
          rank embeds 2 of the 8 padded frames; in bf16 detections and
          features move with the batch)

Usage, from the repo root:

    python3 tools/multichip_parallel.py [--world 4] [--cpu] [--small]

--cpu runs the ranks over Gloo on the CPU (a rehearsal), --small at
128² with IResNet-18 and a 10,000-row gallery. The last line of the
standard output is a JSON object of the checks and times. Exit code 0
when every rank finished and every check held.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


SERVICE_BAR = 1e-4  # float32 sims, the one-at-a-time serving bar of chip_smoke phase 12


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(world: int, argv, timeout: float) -> int:
    """Start the ranks; rank 0's output passes through, the others' on failure."""
    env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               NUM_PROCESSES=str(world))
    procs = []
    for r in range(world):
        out = None if r == 0 else subprocess.PIPE
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv, "--rank-child"],
            env=dict(env, PROCESS_ID=str(r)), stdout=out, stderr=subprocess.STDOUT,
            text=True,
        ))
    deadline = time.monotonic() + timeout
    logs = [""] * world
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] or ""
    except subprocess.TimeoutExpired:
        print(f"ranks still running after {timeout} s", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        print(f"rank {r} exit {procs[r].returncode}:\n{logs[r][-4000:]}", file=sys.stderr)
    return 1 if bad else 0


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
    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.models import arcface, scrfd
    from facerecognizeonnx_tpu_torch.ops import gallery_cuda
    from facerecognizeonnx_tpu_torch.parallel import mesh as pm
    from facerecognizeonnx_tpu_torch.parallel.distributed import init_distributed
    from facerecognizeonnx_tpu_torch.parallel.expert_parallel import ep_embed_crops
    from facerecognizeonnx_tpu_torch.parallel.pipeline_stage import (
        pipelined_frames_to_features,
    )
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import (
        make_dp_program,
        sharded_topk_search,
    )
    from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import tp_embed_crops
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features
    from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService

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
    G = 10_000 if args.small else 1_000_000
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
    summary = {"world": world, "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                          else "cpu"), "checks": {}}
    say(f"{world} ranks over {dist.get_backend()}, rank 0 on {dev} ({summary['device']})"
        + (f" | {cs.nvidia_smi()}" if dev.type == "cuda" else ""))

    # ---- dp
    program, _ = make_dp_program(det, rec, cfg, mesh=data, max_faces_embed=K)
    lo, hi = rank * per_rank, (rank + 1) * per_rank
    with torch.no_grad():
        cs.reset_counts()
        dets, feats = program(frames)
        _sync(dev)
        counts = cs.read_counts()
        e_dets, e_feats = frames_to_features(det, rec, frames[lo:hi], cfg, K)
        for a, b in zip(tuple(dets) + (feats,), tuple(e_dets) + (e_feats,)):
            assert torch.equal(a[lo:hi], b), f"rank {rank}: dp block differs from eager"
        assert dets.valid[:, :K].any(dim=-1).all(), "a frame found no faces"
        if dev.type == "cuda":
            assert [counts[n] for n in ("warp_xm", "warp_xm_pyramid", "nms_greedy")] == [1] * 3
        t = _timed({
            "dp": lambda: program(frames),
            "eager_rank_share": lambda: frames_to_features(det, rec, frames[lo:hi], cfg, K),
            "eager_whole_batch": lambda: frames_to_features(det, rec, frames, cfg, K),
        }, dev)
    summary["checks"]["dp"] = dict(frames=B, launches=counts, ms=t)
    say(f"dp: {B} frames over {world} ranks ({per_rank} each, {size}², {arch}, bf16, K={K}): "
        f"each block bit-equal to the eager step on it; launches per call on rank 0 "
        f"{counts}; wall ms median [min-max]: dp {t['dp']}, eager on one card "
        f"{per_rank} frames {t['eager_rank_share']}, {B} frames {t['eager_whole_batch']}")

    # ---- search
    gen = torch.Generator().manual_seed(5)
    # every rank holds the global gallery on its card (the SPMD call), and
    # searches only its own row block of it
    gallery = torch.nn.functional.normalize(torch.randn(G, 512, generator=gen), dim=-1).to(dev)
    q = torch.nn.functional.normalize(torch.randn(128, 512, generator=gen), dim=-1).to(dev)
    sv, si = sharded_topk_search(q, gallery, TOP_K, mesh=model)
    s_ms = _event_ms(lambda: sharded_topk_search(q, gallery, TOP_K, mesh=model), dev)
    if rank == 0:
        g = gallery
        rv, ri = gallery_cuda.gallery_topk_reference(q, g, TOP_K + 1)
        err, ties = cs.check_topk(sv, si, rv[:, :TOP_K], ri[:, :TOP_K], rv[:, TOP_K],
                                  bar=cs.PARALLEL_SEARCH_BAR)
        dense_ms = _event_ms(lambda: gallery_cuda.gallery_topk_reference(q, g, TOP_K), dev)
        kernel_ms = (_event_ms(lambda: gallery_cuda.gallery_topk_cuda(q, g, TOP_K), dev)
                     if dev.type == "cuda" else None)
        del g
        summary["checks"]["search"] = dict(G=G, max_abs_err=err, ties=ties,
                                           sharded_ms=s_ms, dense_ms=dense_ms,
                                           kernel_ms=kernel_ms)
        say(f"search: Q=128, G={G:,}, k={TOP_K}, rows over {world} ranks: sims max|d| "
            f"{err:.3g} (bar {cs.PARALLEL_SEARCH_BAR:g}), indices equal outside near-ties "
            f"({ties} exact ties); eager ms (median of 20): sharded {s_ms:.4f}, dense on one "
            f"card {dense_ms:.4f}, kernel on one card {kernel_ms}")
    dist.barrier()
    del gallery

    # ---- tp and ep (float32, TF32 off)
    crops = torch.from_numpy(rng.integers(0, 256, (64, 112, 112, 3), dtype=np.uint8))
    experts = [bridge.init_params_numpy(arch, seed=10 + e) for e in range(world)]
    ids = np.arange(64) % world
    with torch.no_grad(), cs.tf32_off():
        tp = tp_embed_crops(rec, crops.to(dev), cfg32, mesh=model)
        want = embed_crops(rec, crops.to(dev), cfg32)
        torch.testing.assert_close(tp, want, rtol=1e-4, atol=1e-5)
        tp_err = float((tp - want).abs().max())
        expert = pm.make_mesh(("expert",), device=device)
        ep, routed = ep_embed_crops(experts, ids, crops.numpy(), cfg32, mesh=expert,
                                    capacity_factor=2.0)
        assert routed.all()
        mine = ids == rank  # each rank checks its own expert's faces
        alone = embed_crops(bridge.params_from_numpy(experts[rank], dev),
                            crops[mine].to(dev), cfg32).cpu().numpy()
        ep_err = float(np.abs(ep[mine] - alone).max())
        assert ep_err <= 1e-5, ep_err
    summary["checks"]["tp"] = dict(max_abs_err=tp_err)
    summary["checks"]["ep"] = dict(max_abs_err_rank0=ep_err)
    say(f"tp: 64 {arch} crops over a {world}-wide model axis, float32 TF32 off: max|d| "
        f"{tp_err:.3g} (bar rtol 1e-4 / atol 1e-5) | ep: {world} experts, one per rank, 64 "
        f"crops: every face routed, rank 0's faces within {ep_err:.3g} of its expert alone "
        f"(bar 1e-5)")

    # ---- pp
    if world % 2 == 0:
        pmesh = pm.make_mesh(("data", "stage"), (world // 2, 2), device=device)
        n_pp = 2 * world
        pp_frames = frames[:n_pp] if B >= n_pp else frames.repeat(2, 1, 1, 1)[:n_pp]
        with torch.no_grad(), cs.tf32_off():
            p_dets, p_feats = pipelined_frames_to_features(det, rec, pp_frames, cfg32,
                                                           mesh=pmesh, max_faces_embed=K)
            f_dets, f_feats = frames_to_features(det, rec, pp_frames, cfg32, K)
        assert torch.equal(p_dets.valid, f_dets.valid)
        torch.testing.assert_close(p_dets.boxes, f_dets.boxes, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(p_feats, f_feats, rtol=1e-4, atol=1e-5)
        pp_err = float((p_feats - f_feats).abs().max())
        summary["checks"]["pp"] = dict(frames=n_pp, max_abs_err=pp_err)
        say(f"pp: {n_pp} frames on a (data, stage) ({world // 2}, 2) mesh, float32 TF32 off: "
            f"masks equal, features max|d| {pp_err:.3g} against the fused step")

    # ---- service
    bank = GalleryBank(device=dev)
    bank.add_batch([f"id{i}" for i in range(1000)], np.asarray(
        torch.nn.functional.normalize(torch.randn(1000, 512, generator=gen), dim=-1)))
    requests = [frames[i % B].cpu().numpy() for i in range(16)]
    # float32 (TF32 off): each rank embeds its 2 of the 8 padded frames
    # where the plain service runs all 8, and in bf16 both detection and
    # features move with the batch (sims 6.5e-3 apart on four cards)
    with cs.tf32_off():
        svc = {name: IdentifyService(det, rec, bank, cfg32, max_batch=8, max_faces=K,
                                     device=dev, **kw)
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
        c, e = cs.names_outside_ties(a, b, SERVICE_BAR)
        checked, equal = checked + c, equal + e
        sim_err = max(sim_err, float(np.abs(a.sims - b.sims).max()))
    assert equal == checked and sim_err <= SERVICE_BAR, (equal, checked, sim_err)
    summary["checks"]["service"] = dict(requests=16, names_checked=checked,
                                        sims_max_abs_diff=sim_err)
    say(f"service: IdentifyService(mesh={world}, sharded=True) on every rank vs the plain "
        f"service, float32 TF32 off, 16 requests one at a time: masks equal, names equal "
        f"on all {checked} positions clear of near-ties, sims max|d| {sim_err:.3g} (bar "
        f"{SERVICE_BAR:g})")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(summary), flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--small", action="store_true")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--rank-child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.rank_child:
        return rank_main(args)
    if not args.cpu and torch.cuda.device_count() < args.world:
        print(f"{args.world} ranks need {args.world} cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    argv = [a for a in sys.argv[1:] if a != "--rank-child"]
    return launch(args.world, argv, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
