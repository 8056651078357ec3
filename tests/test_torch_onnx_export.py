"""The port's ONNX export vs the JAX package's: the same bytes.

Each tree comes from the JAX package's own initializer (jitted), goes to
the port's module through `bridge.params_from_numpy`, and the port's
`export_recognizer` / `export_detector` of that module must write the
bytes the JAX package's export of the tree writes. Folded modules, ONNX
runners and w8a8 copies are rejected with the JAX package's messages.
"""

import jax
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu import onnx_export as j_export
from facerecognizeonnx_tpu.models import arcface as j_arcface
from facerecognizeonnx_tpu.models import mobilefacenet as j_mbf
from facerecognizeonnx_tpu.models import scrfd as j_scrfd
from facerecognizeonnx_tpu.models import vit as j_vit
from facerecognizeonnx_tpu_torch import bridge, onnx_export
from facerecognizeonnx_tpu_torch.models import arcface, quant, scrfd
from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(init, **kw):
    return jax.device_get(jax.jit(lambda k: init(k, **kw))(jax.random.PRNGKey(4)))


RECOGNIZERS = {
    "iresnet18": (j_arcface.init_params, dict(arch="iresnet18", input_size=32), 32),
    "mbf": (j_mbf.init_params, dict(arch="mbf", input_size=32), 32),
    "vit_t": (j_vit.init_params, dict(arch="vit_t", input_size=32), 32),
}
DETECTORS = {"500m": 128, "500m_s2d": 160}


@pytest.mark.parametrize("arch", list(RECOGNIZERS))
def test_export_recognizer_bytes_equal_jax(arch, tmp_path):
    init, kw, size = RECOGNIZERS[arch]
    tree = _jax_tree(init, **kw)
    model = bridge.params_from_numpy(tree, "cpu")
    path = str(tmp_path / "rec.onnx")
    data = onnx_export.export_recognizer(model, path, input_size=size)
    assert data == j_export.export_recognizer(tree, input_size=size)
    assert open(path, "rb").read() == data


@pytest.mark.parametrize("variant", list(DETECTORS))
def test_export_detector_bytes_equal_jax(variant, tmp_path):
    size = DETECTORS[variant]
    tree = _jax_tree(j_scrfd.init_params, variant=variant)
    model = bridge.params_from_numpy(tree, "cpu")
    path = str(tmp_path / "det.onnx")
    data = onnx_export.export_detector(model, path, input_size=size)
    assert data == j_export.export_detector(tree, input_size=size)
    assert open(path, "rb").read() == data


def test_folded_modules_and_wrappers_are_rejected(tmp_path):
    rec = bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=1, input_size=32),
                                   "cpu")
    det = bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=2), "cpu")
    with pytest.raises(ValueError, match="BN-folded"):
        onnx_export.export_recognizer(arcface.fold_inference_params(rec), input_size=32)
    with pytest.raises(ValueError, match="BN-folded"):
        onnx_export.export_detector(scrfd.fold_inference_params(det))
    calib = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3))
                             .astype(np.float32))
    with pytest.raises(ValueError, match="wrapper"):
        onnx_export.export_recognizer(quant.quantize_recognizer(rec, calib), input_size=32)
    path = str(tmp_path / "rec.onnx")
    onnx_export.export_recognizer(rec, path, input_size=32)
    runner = OnnxRunner(path, kind="arcface", device="cpu")
    with pytest.raises(ValueError, match="wrapper"):
        onnx_export.export_recognizer(runner)
    with pytest.raises(ValueError, match="wrapper"):
        onnx_export.export_detector(runner)
    with pytest.raises(ValueError, match="wrapper"):
        onnx_export.export_detector(rec)
