"""Device-time profile of the PyTorch port's main path on one GPU.

Builds chip_smoke.py's full-width configuration (SCRFD-500m at 640x640 and
IResNet-50, both BN-folded, random weights from a seed, bf16, B=8 frames x
K=8 slots, a 10,000-row gallery padded to 16,384), runs warm-up steps, then
profiles STEPS calls of `frames_to_matches` with torch.profiler and prints:

  - host wall ms per step (synchronized), under the profiler and without
    it, and the summed device time of the kernels per step;
  - the device busy share (kernel time / wall) — 1 minus the idle share —
    against both walls;
  - device and host time per stage (record_function ranges around the
    stages, run one after another as frames_to_matches runs them);
  - the top kernels by device time.

Usage, from the repo root on a GPU host:

    python3 tools/profile_torch_main_path.py [TRACE.json]

With a path, the chrome trace of the profiled steps is written there.
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
    print(f"card: {nvidia_smi()}")
    print(f"wall {wall_ms:.3f} ms/step under the profiler, {bare_ms:.3f} ms/step without; "
          f"device kernels {device_ms:.3f} ms/step; busy share {device_ms / wall_ms:.3f} "
          f"under the profiler, {device_ms / bare_ms:.3f} against the unprofiled wall")
    for e in events:
        if e.key.startswith("stage/") and e.device_type == DeviceType.CPU:
            print(f"  {e.key:18s} device {e.device_time_total / 1e3 / STEPS:8.3f} ms/step"
                  f"  host {e.cpu_time_total / 1e3 / STEPS:8.3f} ms/step")
    print("top kernels by device time (ms/step, launches/step):")
    for e in kernels[:25]:
        print(f"  {e.self_device_time_total / 1e3 / STEPS:8.3f}  {e.count // STEPS:4d}  "
              f"{e.key[:110]}")
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        prof.export_chrome_trace(sys.argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
