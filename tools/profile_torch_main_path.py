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

    python3 tools/profile_torch_main_path.py [TRACE.json] [--pack NAME] [--gallery] [--warp-ym]

With a path, the chrome trace of the profiled steps is written there.
With --pack NAME the detector and recognizer are the named buffalo
pack's (`models/packs.load_pack`, seeded weights, chip_smoke's
detections recipe) instead of SCRFD-500m and IResNet-50.
With --gallery it also splits the gallery top-k kernel's time
(csrc/gallery_topk.cu at Q=128, G=100,000, D=512; k = 5, 32, 512): it
builds two copies of the source in gallery_variants/ beside the trace
(or under the working directory),
one that skips the selection (its results are wrong: it times the
product loop, the copies and the other launches) and one that counts,
per block, the clock64 cycles of the product loop and of the selection;
both are timed against the real kernel, CUDA-graph replays in turns.

With --warp-ym it splits the warp kernels' time at B=16 frames of 640x640,
K=8 faces each over levels 0-3 (chip_smoke.py phase 3's frames and
matrices): it builds, in warp_variants/ beside the trace (or under the
working directory), a copy of csrc/warp_ym.cu and one of csrc/warp_xm.cu
that count per block (per team of 224 threads for warp_ym) the clock64
cycles of four parts: the table (and, for warp_ym, the bands' boxes), the
boxes and the staging wait (for warp_xm thread 0's box, the copies and
their wait; for warp_ym the copies issued for the next band, the wait for
this one's and the team barriers), the gather, and the stores; and a copy
of csrc/warp_xm.cu whose staging budget is 16 KB instead of 64 KB (up to 5
blocks per SM instead of 3). All are timed against the real kernels,
CUDA-graph replays in turns, and the crops of each copy are held against
the real kernel's.
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
    argv = sys.argv[1:]
    pack = None
    if "--pack" in argv:
        i = argv.index("--pack")
        pack = argv[i + 1]
        del argv[i:i + 2]
    dev = torch.device("cuda", 0)
    B, K, TOP_K, N_ROWS, G_PAD = 8, 8, 5, 10_000, 16_384
    rng = np.random.default_rng(0)
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    frames = torch.from_numpy(rng.integers(0, 256, (B, 640, 640, 3), dtype=np.uint8)).to(dev)
    if pack:
        from chip_smoke import bias_detector
        from facerecognizeonnx_tpu_torch.models.packs import load_pack

        face_det, face_rec = load_pack(pack, device=dev)
        bias_detector(face_det, frames)
        det, rec = face_det.params, face_rec.params
        print(f"pack {pack}: {face_det.cfg.scrfd_variant} + {face_rec.cfg.rec_arch}")
    else:
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
    paths = [a for a in argv if not a.startswith("--")]
    if paths:
        os.makedirs(os.path.dirname(os.path.abspath(paths[0])), exist_ok=True)
        prof.export_chrome_trace(paths[0])
    out = os.path.dirname(os.path.abspath(paths[0])) if paths else "."
    if "--gallery" in argv:
        gallery_split(dev, os.path.join(out, "gallery_variants"))
    if "--warp-ym" in argv:
        warp_split(dev, os.path.join(out, "warp_variants"))
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



# ---------------------------------------------------------------- the warp split

DBG = ("__device__ long long g_dbg[4096][5];\n", 'extern "C" int dbg_read(long long* h) {\n'
       "  return (int)cudaMemcpyFromSymbol(h, g_dbg, sizeof(g_dbg));\n}\n")


def _edit(text: str, pairs) -> str:
    for old, new in pairs:
        assert text.count(old) == 1, f"the source changed shape at: {old[:60]!r}"
        text = text.replace(old, new)
    return text


def _counted_ym(src: str) -> str:
    """csrc/warp_ym.cu counting, per team of 224 threads (its thread 0):
    table + boxes, staging wait and barriers, gather, stores, and the
    whole kernel."""
    sync_in = "    team_sync(team);  // unit u's box has landed, from every team thread's copies\n"
    store = "  float* dst = out + (static_cast<size_t>(i) * OUT + j0) * 3;\n"
    store_end = "  store16(dst + 8, y[8], y[9], y[10], y[11]);\n}\n"
    t = _edit(src, [
        ("namespace {\n\nconstexpr int OUT", DBG[0] + "namespace {\n\nconstexpr int OUT"),
        ("const int* rowoff, int i0, float* out, int t) {",
         "const int* rowoff, int i0, float* out, int t, long long* acc) {"),
        (store, "  const long long c_s = clock64();\n" + store),
        (store_end, store_end[:-2] + "  *acc += clock64() - c_s;\n}\n"),
        ("  const int owned = (n_faces - static_cast<int>(blockIdx.x) + grid - 1) / grid;\n",
         "  const int owned = (n_faces - static_cast<int>(blockIdx.x) + grid - 1) / grid;\n"
         "  const long long c_t0 = clock64();\n  long long c_wait = 0, c_gat = 0, c_st = 0;\n"),
        ("  __syncthreads();\n\n  // units u", "  __syncthreads();\n"
         "  const long long c_tab = clock64() - c_t0;\n\n  // units u"),
        ("    const int nu = u + TEAMS;\n", "    const long long c_a = clock64();\n"
         "    const int nu = u + TEAMS;\n"),
        (sync_in, sync_in + "    const long long c_b = clock64();\n    c_wait += c_b - c_a;\n"),
        ("i0, dst, t);\n    else", "i0, dst, t, &c_st);\n    else"),
        ("i0, dst, t);\n  }\n}\n", "i0, dst, t, &c_st);\n    c_gat += clock64() - c_b;\n  }\n"
         "  if (t == 0) {\n    long long* d = g_dbg[blockIdx.x * TEAMS + team];\n"
         "    d[0] = c_tab; d[1] = c_wait; d[2] = c_gat - c_st; d[3] = c_st;\n"
         "    d[4] = clock64() - c_t0;\n  }\n}\n"),
    ])
    return t + "\n" + DBG[1]


def _counted_xm(src: str) -> str:
    """csrc/warp_xm.cu counting, per block (thread 0): table, box + staging
    wait, gather, stores, and the whole kernel."""
    t = _edit(src, [
        ("namespace {\n\nconstexpr int OUT", DBG[0] + "namespace {\n\nconstexpr int OUT"),
        ("  const bool live = valid == nullptr || valid[n] != 0;\n",
         "  const bool live = valid == nullptr || valid[n] != 0;\n"
         "  const long long c_t0 = clock64();\n"),
        ("  __syncthreads();\n\n  Face f;", "  __syncthreads();\n"
         "  const long long c_t1 = clock64();\n\n  Face f;"),
        ("  // this thread: 8 consecutive pixels", "  const long long c_t2 = clock64();\n"
         "  // this thread: 8 consecutive pixels"),
        ("  const size_t o = (static_cast<size_t>(n) * PIX",
         "  const long long c_t3 = clock64();\n  const size_t o = (static_cast<size_t>(n) * PIX"),
        ("    for (int q = 0; q < 6; ++q) dst[q] = v[q];\n  }\n}\n",
         "    for (int q = 0; q < 6; ++q) dst[q] = v[q];\n  }\n  if (threadIdx.x == 0) {\n"
         "    long long* d = g_dbg[blockIdx.y * N_BANDS + blockIdx.x];\n"
         "    const long long c_t4 = clock64();\n"
         "    d[0] = c_t1 - c_t0; d[1] = c_t2 - c_t1; d[2] = c_t3 - c_t2; d[3] = c_t4 - c_t3;\n"
         "    d[4] = c_t4 - c_t0;\n  }\n}\n"),
    ])
    return t + "\n" + DBG[1]


def warp_split(dev, out_dir: str) -> None:
    import ctypes
    import re
    import subprocess

    import numpy as np
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    from chip_smoke import EPI, graph_timer, in_turns, spread_matrices
    from facerecognizeonnx_tpu_torch.ops import _nvcc, warp_cuda

    xm_src = (_nvcc.CSRC / "warp_xm.cu").read_text()
    ym_src = (_nvcc.CSRC / "warp_ym.cu").read_text()
    stage = "constexpr int STAGE_BYTES = 64 * 1024;"
    texts = {"ym_counted": _counted_ym(ym_src), "xm_counted": _counted_xm(xm_src),
             "xm_stage16k": _edit(xm_src, [(stage, "constexpr int STAGE_BYTES = 16 * 1024;")])}
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *_nvcc.NVCC_FLAGS, "-I", str(_nvcc.CSRC),
             "-o", cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {"ym": warp_cuda.build_library_ym()[0], "xm": warp_cuda.build_library()[0]}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        (warp_cuda._bind_ym if name.startswith("ym") else warp_cuda._bind_xm)(libs[name])
        if name.endswith("counted"):
            libs[name].dbg_read.argtypes = [ctypes.c_void_p]

    rng = np.random.default_rng(0)
    B, K, H, W = 16, 8, 640, 640
    N = B * K
    frames = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    Ms = torch.from_numpy(spread_matrices(rng, B, K, H, W)).to(dev)
    pyr = warp_cuda.build_pyramid(frames)

    def stream():  # the stream a CUDA-graph capture records
        return torch.cuda.current_stream(dev).cuda_stream

    def ym(lib):
        out = torch.empty((B, K, 112, 112, 3), device=dev)
        table = torch.empty((N, 9), device=dev)
        rc = lib.warp_ym_launch(frames.data_ptr(), pyr.data_ptr(), Ms.data_ptr(), out.data_ptr(),
                                table.data_ptr(), N, K, H, W, 0, stream())
        assert rc == 0, lib.warp_ym_error_string(rc)
        return out

    def xm(lib):
        out = torch.empty((B, K, 112, 112, 3), dtype=torch.bfloat16, device=dev)
        table = torch.empty((N, 9), device=dev)
        rc = lib.warp_xm_launch(frames.data_ptr(), pyr.data_ptr(), Ms.data_ptr(), None,
                                out.data_ptr(), table.data_ptr(), N, K, H, W, 1, EPI[0],
                                1.0 / EPI[1], stream())
        assert rc == 0, lib.warp_xm_error_string(rc)
        return out

    calls = {"ym": ym, "ym_counted": ym, "xm": xm, "xm_counted": xm, "xm_stage16k": xm}
    for name, fn in calls.items():
        same = torch.equal(fn(libs[name]), fn(libs[name[:2]]))
        assert same, f"{name} crops differ from the real kernel's"
    names = list(calls)
    times = in_turns(*[graph_timer(lambda n=n: calls[n](libs[n])) for n in names])
    print(f"warp split (B={B}, K={K}, {H}x{W}, levels 0-3; CUDA-graph replays, median of 20 in "
          f"turns; crops of every copy equal the real kernel's): "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in zip(names, times)))
    parts = ("table", "box + staging wait", "gather", "stores", "whole")
    for name, unit in (("ym_counted", "team"), ("xm_counted", "block")):
        buf = np.zeros((4096, 5), np.int64)
        calls[name](libs[name])
        torch.cuda.synchronize()
        assert libs[name].dbg_read(buf.ctypes.data) == 0
        used = buf[buf[:, 4] > 0]
        slow = used[used[:, 4].argmax()]
        print(f"  {name}: clock64 cycles per {unit}, mean over {len(used)}: " + ", ".join(
            f"{p} {used[:, k].mean():.0f}" for k, p in enumerate(parts))
            + "; the slowest: " + ", ".join(f"{p} {slow[k]}" for k, p in enumerate(parts)))
        if name == "ym_counted":  # team TEAMS·f + m of block f: face f (one face per block here)
            teams = int(re.search(r"constexpr int TEAMS = (\d+);", ym_src).group(1))
            table = warp_cuda.face_params_ym(Ms).cpu().numpy()
            whole = buf[: teams * N, 4].reshape(N, teams).max(axis=1)
            for f in np.argsort(-whole)[:8]:
                a, b = table[f, 3], table[f, 4]
                print(f"    face {f}: {whole[f]} cycles, level {table[f, 0]:.0f}, "
                      f"{np.hypot(a, b):.3f} window px per output px, angle "
                      f"{np.degrees(np.arctan2(b, a)):.0f} deg")
            print(f"    median face {np.median(whole):.0f} cycles")


if __name__ == "__main__":
    sys.exit(main())
