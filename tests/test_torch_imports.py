"""The port imports torch and never jax (nor the JAX package)."""

import subprocess
import sys
from pathlib import Path

SLICE_MODULES = [
    "facerecognizeonnx_tpu_torch",
    "facerecognizeonnx_tpu_torch.config",
    "facerecognizeonnx_tpu_torch.types",
    "facerecognizeonnx_tpu_torch.errors",
    "facerecognizeonnx_tpu_torch.bridge",
    "facerecognizeonnx_tpu_torch.ops.image",
    "facerecognizeonnx_tpu_torch.ops.nms",
    "facerecognizeonnx_tpu_torch.ops.topk",
    "facerecognizeonnx_tpu_torch.ops.umeyama",
    "facerecognizeonnx_tpu_torch.ops.warp",
    "facerecognizeonnx_tpu_torch.ops.warp_cuda",
    "facerecognizeonnx_tpu_torch.ops._nvcc",
    "facerecognizeonnx_tpu_torch.ops.gallery_cuda",
    "facerecognizeonnx_tpu_torch.ops.warp_banded",
    "facerecognizeonnx_tpu_torch.runtime",
    "facerecognizeonnx_tpu_torch.runtime.native",
    "facerecognizeonnx_tpu_torch.io",
    "facerecognizeonnx_tpu_torch.io.imageio",
    "facerecognizeonnx_tpu_torch.models",
    "facerecognizeonnx_tpu_torch.models.layers",
    "facerecognizeonnx_tpu_torch.models.scrfd",
    "facerecognizeonnx_tpu_torch.models.arcface",
    "facerecognizeonnx_tpu_torch.models.mobilefacenet",
    "facerecognizeonnx_tpu_torch.models.vit",
    "facerecognizeonnx_tpu_torch.models.quant",
    "facerecognizeonnx_tpu_torch.models.packs",
    "facerecognizeonnx_tpu_torch.detect.decode",
    "facerecognizeonnx_tpu_torch.detect.pipeline",
    "facerecognizeonnx_tpu_torch.embed.pipeline",
    "facerecognizeonnx_tpu_torch.match",
    "facerecognizeonnx_tpu_torch.match.similarity",
    "facerecognizeonnx_tpu_torch.match.gallery",
    "facerecognizeonnx_tpu_torch.utils",
    "facerecognizeonnx_tpu_torch.utils.checkpoint",
    "facerecognizeonnx_tpu_torch.utils.observability",
    "facerecognizeonnx_tpu_torch.pipeline.fused",
    "facerecognizeonnx_tpu_torch.pipeline.api",
    "facerecognizeonnx_tpu_torch.pipeline.enroll",
    "facerecognizeonnx_tpu_torch.pipeline.service",
    "facerecognizeonnx_tpu_torch.pipeline.bucketed",
    "facerecognizeonnx_tpu_torch.pipeline.video",
    "facerecognizeonnx_tpu_torch.pipeline.track",
    "facerecognizeonnx_tpu_torch.pipeline.app",
    "facerecognizeonnx_tpu_torch.pipeline.client",
    "facerecognizeonnx_tpu_torch.pipeline.server",
    "facerecognizeonnx_tpu_torch.pipeline.aot",
    "facerecognizeonnx_tpu_torch.utils.debug",
    "facerecognizeonnx_tpu_torch.utils.draw",
    "facerecognizeonnx_tpu_torch.utils.realmodels",
    "facerecognizeonnx_tpu_torch.onnx_import",
    "facerecognizeonnx_tpu_torch.onnx_import.proto",
    "facerecognizeonnx_tpu_torch.onnx_import.executor",
    "facerecognizeonnx_tpu_torch.onnx_import.importer",
    "facerecognizeonnx_tpu_torch.onnx_import.native_map",
    "facerecognizeonnx_tpu_torch.onnx_export",
    "facerecognizeonnx_tpu_torch.onnx_export.writer",
    "facerecognizeonnx_tpu_torch.onnx_export.emit",
    "facerecognizeonnx_tpu_torch.version",
    "facerecognizeonnx_tpu_torch.cli",
    "facerecognizeonnx_tpu_torch.cli.main",
    "facerecognizeonnx_tpu_torch.__main__",
    "facerecognizeonnx_tpu_torch.parallel",
    "facerecognizeonnx_tpu_torch.parallel.distributed",
    "facerecognizeonnx_tpu_torch.parallel.mesh",
    "facerecognizeonnx_tpu_torch.parallel.sharded_ops",
    "facerecognizeonnx_tpu_torch.parallel.tensor_parallel",
    "facerecognizeonnx_tpu_torch.parallel.expert_parallel",
    "facerecognizeonnx_tpu_torch.parallel.pipeline_stage",
]

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Nor cv2 or PIL, which `io.imageio` imports only when a call needs
    them: the GPU host has neither."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.split('.')[0] in ('facerecognizeonnx_tpu', 'cv2', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_without_a_card_fails_and_imports_no_jax():
    """chip_smoke.py runs where there is no JAX, and has no CPU path:
    without a CUDA device it exits non-zero and prints no result."""
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "facerecognizeonnx_tpu." not in src
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
