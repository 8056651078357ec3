"""The buffalo packs (`models/packs.py`) and the quantized FaceRecognizer
vs the JAX package's.

`load_pack` builds the pack's models from seeds (no `.onnx` file exists
here); the JAX side runs the same numpy trees (`bridge.init_params_numpy`
draws them in JAX layouts) through its own `frames_to_matches`, float32,
the Pallas warp in interpret mode, with the detections recipe of
`chip_smoke.detection_bias` on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.models import packs as j_packs
from facerecognizeonnx_tpu.models import recognizer_module_for as j_rec_module_for
from facerecognizeonnx_tpu.models import scrfd as j_scrfd
from facerecognizeonnx_tpu.pipeline.api import FaceRecognizer as JaxRecognizer
from facerecognizeonnx_tpu.pipeline.fused import frames_to_matches as j_frames_to_matches
from facerecognizeonnx_tpu.utils import checkpoint as j_checkpoint
from facerecognizeonnx_tpu_torch import FaceRecognizer, bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.models import packs, quant
from facerecognizeonnx_tpu_torch.models.layers import Conv
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_matches
from tests.test_torch_models import _cos

SIZE, B, K, TOP_K, N_ROWS, G_PAD = 128, 2, 2, 3, 40, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_and_resolve_match_jax(tmp_path):
    assert packs.pack_names() == j_packs.pack_names()
    for name in packs.pack_names():
        assert dataclasses.asdict(packs.PACKS[name]) == dataclasses.asdict(j_packs.PACKS[name])
    for present in ([], ["det_500m.onnx"], ["det_500m.onnx", "w600k_r50.onnx"]):
        for f in present:
            (tmp_path / f).write_bytes(b"x")
        got = packs.resolve_pack("buffalo_sc", str(tmp_path))
        want = j_packs.resolve_pack("buffalo_sc", str(tmp_path))
        assert got[1:] == want[1:] and got[0].det_file == want[0].det_file
    assert packs.resolve_pack("buffalo_l")[1:] == (None, None)
    with pytest.raises(KeyError, match="buffalo_l"):
        packs.resolve_pack("nope")


def test_load_pack_with_onnx_files_raises(tmp_path):
    """Present .onnx files are never replaced by seeded weights: a corrupt
    one fails its load_model and load_pack raises (tests/
    test_torch_onnx_api.py loads real exports)."""
    (tmp_path / "det_2.5g.onnx").write_bytes(b"x")
    with pytest.raises(ModelLoadError, match="buffalo_m: failed to load"):
        packs.load_pack("buffalo_m", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="quant"):
        packs.load_pack("buffalo_s", quant="w4", device="cpu")


@pytest.mark.parametrize("quant_opt", ["w8a8", "w8a8-fast"])
def test_load_pack_quant_options(quant_opt):
    """'w8a8' quantizes every dense conv, 'w8a8-fast' those with at least
    128 outputs (min_channels 0 / 128, as the JAX pack loader maps them)."""
    det, rec = packs.load_pack("buffalo_s", quant=quant_opt, device="cpu")
    assert det.cfg.scrfd_variant == "500m" and rec.cfg.rec_arch == "mbf"
    assert quant.is_quantized(rec.params)
    for m in rec.params.modules():
        if isinstance(m, quant.QConv) and quant_opt == "w8a8-fast":
            assert m.w_q.shape[0] >= 128
        if isinstance(m, Conv):
            assert m.groups > 1 or (quant_opt == "w8a8-fast" and m.weight.shape[0] < 128)


@pytest.mark.parametrize("name", ["buffalo_s", "buffalo_l"])
def test_pack_frames_to_matches_matches_jax(name):
    """A pack loaded on the CPU runs the fused path: detections, features
    and matches against the JAX pipeline on the same trees."""
    det, rec = packs.load_pack(name, device="cpu")
    pack = packs.PACKS[name]
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    det_tree = detection_bias(bridge.init_params_numpy(pack.det_variant, seed=0),
                              torch.from_numpy(frames))
    det.params.cls.bias.data.copy_(torch.from_numpy(det_tree["head"]["cls"]["b"]))
    rec_tree = bridge.init_params_numpy(pack.rec_arch, seed=1)
    bank = rng.normal(size=(G_PAD, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    bank[N_ROWS:] = 0.0

    cfg = PipelineConfig(det_input_size=SIZE, compute_dtype="float32", warp_impl="cuda",
                         scrfd_variant=pack.det_variant, rec_arch=pack.rec_arch)
    with torch.no_grad():
        dets, feats, sims, idx = frames_to_matches(
            det.params, rec.params, torch.from_numpy(frames), torch.from_numpy(bank),
            N_ROWS, cfg, K, TOP_K)
    jcfg = JaxConfig(det_input_size=SIZE, compute_dtype="float32", warp_impl="pallas",
                     warp_interpret=True, scrfd_variant=pack.det_variant,
                     rec_arch=pack.rec_arch)
    jdet = j_scrfd.fold_inference_params(jax.tree_util.tree_map(jnp.asarray, det_tree))
    jrec = jax.tree_util.tree_map(jnp.asarray, rec_tree)
    jrec = j_rec_module_for(jrec).fold_inference_params(jrec)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda d, r, f, g: j_frames_to_matches(
            d, r, f, g, jnp.int32(N_ROWS), jcfg, K, TOP_K))(
            jdet, jrec, jnp.asarray(frames), jnp.asarray(bank))
    w_dets, w_feats, w_sims, w_idx = jax.tree_util.tree_map(np.asarray, want)

    np.testing.assert_array_equal(dets.valid.numpy(), w_dets.valid)
    assert dets.count().min() >= 4
    np.testing.assert_allclose(dets.boxes.numpy(), w_dets.boxes, atol=1e-3, rtol=0)
    slot_valid = dets.valid[:, :K].numpy()
    assert slot_valid.all()
    f = feats.numpy()
    cos = (f * w_feats).sum(-1)[slot_valid]
    assert cos.min() >= 1 - 1e-5, cos.min()
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_allclose(sims.numpy(), w_sims, atol=2.3e-3, rtol=0)


def test_face_recognizer_mbf_quantize_matches_jax(tmp_path):
    """FaceRecognizer(rec_arch="mbf").quantize() end to end on both sides:
    the same .npz weights, each side's default calibration batch (64 noise
    crops from cfg.seed, calibrated in bf16), then extract_feature_simple."""
    tree = bridge.init_params_numpy("mbf", seed=5)
    path = str(tmp_path / "mbf.npz")
    j_checkpoint.save_params(path, tree)
    common = dict(rec_arch="mbf", compute_dtype="float32")
    port, ref = FaceRecognizer(PipelineConfig(**common), device="cpu"), JaxRecognizer(
        JaxConfig(**common))
    img = np.random.default_rng(3).integers(0, 256, (112, 112, 3), dtype=np.uint8)
    feats = []
    for r in (port, ref):
        assert r.load_model(path)
        f32 = r.extract_feature_simple(img)
        assert r.quantize()
        assert not r.quantize()  # already quantized
        q = r.extract_feature_simple(img)
        assert q.shape == (512,) and _cos(q, f32) > 0.97
        feats.append(q)
    assert quant.is_quantized(port.params)
    # each side's own calibration (tests/test_torch_quant.py): measured
    # 1 - cos 1.15e-2
    assert _cos(feats[0], feats[1]) > 0.97
    at_load = FaceRecognizer(PipelineConfig(recognizer_quant="w8a8", **common), device="cpu")
    assert at_load.load_model(path) and quant.is_quantized(at_load.params)
    np.testing.assert_array_equal(at_load.extract_feature_simple(img), feats[0])
