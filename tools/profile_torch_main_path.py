"""Device-time profile of the PyTorch port's main path on one GPU.

Builds chip_smoke.py's full-width configuration (SCRFD-500m at 640x640 and
IResNet-50, both BN-folded, random weights from a seed, bf16, B=8 frames x
K=8 slots, a 10,000-row gallery padded to 16,384), runs warm-up steps, then
profiles STEPS calls of `frames_to_matches` with torch.profiler and prints:

  - host wall ms per step (synchronized), under the profiler and without
    it, and the summed device time of the kernels per step;
  - the device busy share (kernel time / wall) — 1 minus the idle share —
    against both walls, and the device operations (kernels and copies)
    per step;
  - device and host time per stage (record_function ranges around the
    stages, run one after another as frames_to_matches runs them);
  - the top kernels by device time.

Usage, from the repo root on a GPU host:

    python3 tools/profile_torch_main_path.py [TRACE.json] [--gallery]

With a path, the chrome trace of the profiled steps is written there.
With --gallery it also splits the gallery top-k kernel's time
(csrc/gallery_topk.cu at Q=128, G=100,000, D=512; k = 5, 32, 512): it
builds two copies of the source in gallery_variants/ beside the trace
(or under the working directory),
one that skips the selection (its results are wrong: it times the
product loop, the copies and the other launches) and one that counts,
per block, the clock64 cycles of the product loop and of the selection;
both are timed against the real kernel, CUDA-graph replays in turns.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 5


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import detection_bias, nvidia_smi
    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.config import PipelineConfig
    from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces_batch, embed_crops
    from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
    from facerecognizeonnx_tpu_torch.models import arcface, scrfd
    from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
    from facerecognizeonnx_tpu_torch.pipeline.fused import detect_topk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    B, K, TOP_K, N_ROWS, G_PAD = 8, 8, 5, 10_000, 16_384
    rng = np.random.default_rng(0)
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    frames = torch.from_numpy(rng.integers(0, 256, (B, 640, 640, 3), dtype=np.uint8)).to(dev)
    det_tree = detection_bias(bridge.init_params_numpy("500m", seed=0), frames)
    det = scrfd.fold_inference_params(bridge.params_from_numpy(det_tree, dev))
    rec = arcface.fold_inference_params(
        bridge.params_from_numpy(bridge.init_params_numpy("iresnet50", seed=1), dev)
    )
    bank = torch.zeros((G_PAD, 512), device=dev)
    bank[:N_ROWS] = torch.nn.functional.normalize(torch.randn(N_ROWS, 512, device=dev), dim=-1)

    def step():
        # frames_to_matches, stage by stage
        with record_function("stage/detect+nms"):
            _, top = detect_topk(det, frames, cfg, K)
        with record_function("stage/align+warp"):
            crops = align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
        with record_function("stage/embed"):
            feats = embed_crops(rec, crops.reshape(B * K, 112, 112, 3), cfg, normalized=True)
            feats = feats * top.valid.reshape(-1, 1)
        with record_function("stage/match"):
            sims = similarity_matrix(feats, bank)
            mask = torch.arange(G_PAD, device=dev)[None, :] < N_ROWS
            topk_stable(torch.where(mask, sims, torch.full_like(sims, -1.0)), TOP_K)

    with torch.no_grad():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = sorted(
        (e for e in events
         if e.device_type == DeviceType.CUDA and not e.key.startswith("stage/")),
        key=lambda e: -e.self_device_time_total,
    )
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / STEPS
    launches = sum(e.count for e in kernels) / STEPS
    print(f"card: {nvidia_smi()}")
    print(f"wall {wall_ms:.3f} ms/step under the profiler, {bare_ms:.3f} ms/step without; "
          f"device kernels {device_ms:.3f} ms/step in {launches:.0f} device operations/step; "
          f"busy share {device_ms / wall_ms:.3f} under the profiler, "
          f"{device_ms / bare_ms:.3f} against the unprofiled wall")
    for e in events:
        if e.key.startswith("stage/") and e.device_type == DeviceType.CPU:
            print(f"  {e.key:18s} device {e.device_time_total / 1e3 / STEPS:8.3f} ms/step"
                  f"  host {e.cpu_time_total / 1e3 / STEPS:8.3f} ms/step")
    print("top kernels by device time (ms/step, launches/step):")
    for e in kernels[:25]:
        print(f"  {e.self_device_time_total / 1e3 / STEPS:8.3f}  {e.count // STEPS:4d}  "
              f"{e.key[:110]}")
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        os.makedirs(os.path.dirname(os.path.abspath(paths[0])), exist_ok=True)
        prof.export_chrome_trace(paths[0])
    if "--gallery" in sys.argv:
        out = os.path.dirname(os.path.abspath(paths[0])) if paths else "."
        gallery_split(dev, os.path.join(out, "gallery_variants"))
    return 0


SELECTION = "    // ---- selection: accumulator i holds"
TILE_END = "    named_sync(1, CONSUMERS);  // the sims buffer is free for the next tile\n  }\n"


def _instrumented(src: str) -> str:
    """csrc/gallery_topk.cu counting, per block, the cycles of the product
    loop and of the selection (g_dbg, read by dbg_read)."""
    t = src.replace("namespace {\n\nconstexpr unsigned FULL",
                    "__device__ long long g_dbg[8192][2];\nnamespace {\n\nconstexpr unsigned FULL")
    t = t.replace("  int it = 0;\n  for (int t = 0; t < n_tiles; ++t) {",
                  "  int it = 0;\n  long long c_mma = 0, c_sel = 0;\n"
                  "  for (int t = 0; t < n_tiles; ++t) {\n    long long t0 = clock64();")
    t = t.replace(SELECTION, "    long long t1 = clock64();\n    c_mma += t1 - t0;\n" + SELECTION)
    t = t.replace(TILE_END, TILE_END[:-4] + "    c_sel += clock64() - t1;\n  }\n"
                  "  if (tid == 0) {\n    long long* d = g_dbg[blockIdx.y * gridDim.x + blockIdx.x];\n"
                  "    d[0] = c_mma; d[1] = c_sel;\n  }\n")
    t += ('\nextern "C" int dbg_read(long long* h) {\n'
          "  return (int)cudaMemcpyFromSymbol(h, g_dbg, sizeof(g_dbg));\n}\n")
    assert t.count("clock64()") == 3, "csrc/gallery_topk.cu changed shape"
    return t


def gallery_split(dev, out_dir: str) -> None:
    import ctypes
    import subprocess

    import numpy as np
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    from chip_smoke import _gallery, graph_timer, in_turns
    from facerecognizeonnx_tpu_torch.ops import _nvcc, gallery_cuda

    src = (_nvcc.CSRC / "gallery_topk.cu").read_text()
    assert SELECTION in src and TILE_END in src, "csrc/gallery_topk.cu changed shape"
    os.makedirs(out_dir, exist_ok=True)
    texts = {"noselect": src.replace(SELECTION, "    continue;\n" + SELECTION),
             "counted": _instrumented(src)}
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *_nvcc.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"kernel": gallery_cuda.build_library()[0]}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        gallery_cuda._bind(libs[name])
    libs["counted"].dbg_read.argtypes = [ctypes.c_void_p]

    def call(lib, q, g, k):
        Q, D = q.shape
        G = g.shape[0]
        tile = lib.gallery_topk_query_tile(k)
        rows, splits = gallery_cuda.split_plan(
            Q, G, tile, torch.cuda.get_device_properties(dev).multi_processor_count)
        q_hi = torch.zeros((max(Q, tile), D), device=dev)
        q_lo = torch.zeros_like(q_hi)
        pv = torch.empty((Q, splits, k), device=dev)
        pi = torch.empty((Q, splits, k), dtype=torch.int32, device=dev)
        ov = torch.empty((Q, k), device=dev)
        oi = torch.empty((Q, k), dtype=torch.int32, device=dev)
        rc = lib.gallery_topk_launch(
            q.data_ptr(), q_hi.data_ptr(), q_lo.data_ptr(), g.data_ptr(), pv.data_ptr(),
            pi.data_ptr(), ov.data_ptr(), oi.data_ptr(), Q, max(Q, tile), G, D, k, rows, splits,
            torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, lib.gallery_topk_error_string(rc)
        return -(-Q // tile) * splits  # blocks of kernel A

    gen = torch.Generator(device=dev).manual_seed(5)
    q, g = _gallery(gen, 128, 100_000, 512, dev, dups=1_000)
    print("gallery_topk split (Q=128, G=100,000, D=512; CUDA-graph replays, median of 20 "
          "in turns; cycles: clock64 per block, mean over blocks):")
    for k in (5, 32, 512):
        names = list(libs)
        times = in_turns(*[graph_timer(lambda n=n: call(libs[n], q, g, k)) for n in names])
        buf = np.zeros((8192, 2), np.int64)
        blocks = call(libs["counted"], q, g, k)
        torch.cuda.synchronize()
        assert libs["counted"].dbg_read(buf.ctypes.data) == 0
        used = buf[:blocks]
        print(f"  k={k}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in zip(names, times))
              + f"; blocks {len(used)}: product loop {used[:, 0].mean():.0f} cycles, "
              f"selection {used[:, 1].mean():.0f} cycles")


if __name__ == "__main__":
    sys.exit(main())
