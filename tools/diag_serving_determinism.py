"""How reproducible is the identify path on the card in bf16? (diagnostic)

Runs `frames_to_features` on one batch of 8 640x640 frames twice, on the
same frames in another order, and on a batch whose other 7 frames differ,
with cuDNN's default algorithms and with cudnn.deterministic=True, and
prints max |Δ| of the features of the same frame.
"""

import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from chip_smoke import detection_bias  # noqa: E402
from facerecognizeonnx_tpu_torch import bridge  # noqa: E402
from facerecognizeonnx_tpu_torch.config import PipelineConfig  # noqa: E402
from facerecognizeonnx_tpu_torch.models import arcface, scrfd  # noqa: E402
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features  # noqa: E402


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (16, 640, 640, 3), dtype=np.uint8)).to(dev)
    det = scrfd.fold_inference_params(bridge.params_from_numpy(
        detection_bias(bridge.init_params_numpy("500m", seed=0), frames), dev))
    rec = arcface.fold_inference_params(
        bridge.params_from_numpy(bridge.init_params_numpy("iresnet50", seed=1), dev))

    def feats(x):
        with torch.no_grad():
            d, f = frames_to_features(det, rec, x, cfg, 8)
        torch.cuda.synchronize()
        return d, f

    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        a = feats(frames[:8])
        b = feats(frames[:8])
        perm = torch.tensor([3, 1, 0, 2, 7, 6, 5, 4], device=dev)
        c = feats(frames[:8][perm])
        mixed = torch.cat([frames[:1], frames[8:15]])
        m = feats(mixed)
        va = a[0].valid[:, :8]

        def diff(f1, f2, rows1, rows2):
            return float((f1[rows1] - f2[rows2]).abs().max())

        inv = torch.argsort(perm)
        same_boxes = bool(torch.equal(a[0].boxes, c[0].boxes[inv]))
        print(f"cudnn.deterministic={deterministic}: repeat max|d| {diff(a[1], b[1], slice(None), slice(None)):.3g}"
              f" (bit-equal {torch.equal(a[1], b[1])}); permuted batch {diff(a[1], c[1][inv], slice(None), slice(None)):.3g}"
              f" (boxes equal {same_boxes}); frame 0 beside 7 other frames "
              f"{diff(a[1], m[1], 0, 0):.3g} (boxes equal {torch.equal(a[0].boxes[0], m[0].boxes[0])}); "
              f"valid slots {int(va.sum())}", flush=True)


if __name__ == "__main__":
    main()
