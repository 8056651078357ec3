"""Tensor-parallel (channel-sharded) recognizers of the port
(`parallel/tensor_parallel.py`) on 4 real Gloo ranks vs the JAX
package's `tp_embed_crops` and its single-chip oracle `embed_crops`,
plus the spec and slicing rules in process.

One spawn of 4 ranks runs every case (tests/test_tensor_parallel.py of
the JAX package): tp2 folded (ranks 0-1; ranks 2-3, outside that mesh,
receive its answer), tp4 unfolded, dp × tp on a (2, 2) mesh, ViT tp2
and ViT folded dp × tp, and ViT heads that do not divide the axis.
IResNet-18 and ViT-T from `bridge.init_params_numpy`, float32, 5 crops
at 112². The sharded sums reorder float additions, so every case is held
to the JAX tests' bar (rtol 1e-4, atol 1e-5) against JAX's `embed_crops`
and, for tp2, against JAX's own `tp_embed_crops` on 2 of its virtual
devices.
"""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.embed.pipeline import embed_crops as j_embed_crops
from facerecognizeonnx_tpu.models import arcface as j_arcface
from facerecognizeonnx_tpu.models import vit as j_vit
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as j_make_mesh
from facerecognizeonnx_tpu.parallel.tensor_parallel import tp_embed_crops as j_tp_embed_crops
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import (
    local_module,
    pack_tp_params,
    recognizer_param_specs,
    validate_tp_width,
)
from tests.torch_ranks import run_ranks

JCFG = JaxConfig(compute_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    r18 = bridge.init_params_numpy("iresnet18", seed=5)
    vit = bridge.init_params_numpy("vit_t", seed=6)
    return {
        "r18": r18,
        "r18_folded": _np(j_arcface.fold_inference_params(r18)),
        "vit": vit,
        "vit_folded": _np(j_vit.fold_inference_params(vit)),
        "crops5": np.random.default_rng(13).integers(0, 256, (5, 112, 112, 3), dtype=np.uint8),
    }


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    outs = run_ranks(tmp_path_factory.mktemp("tp"), 4, ["tp"], trees)
    return [o["tp"] for o in outs]


@pytest.fixture(scope="module")
def jax_ref(trees):
    crops = trees["crops5"]
    fn = jax.jit(lambda p, c: j_embed_crops(p, c, JCFG))
    mesh2 = j_make_mesh(("model",), (2,), devices=jax.devices()[:2])
    with jax.default_matmul_precision("highest"):
        out = {k: np.asarray(fn(trees[k], crops)) for k in ("r18", "r18_folded", "vit",
                                                           "vit_folded")}
        out["tp2_r18"] = np.asarray(j_tp_embed_crops(trees["r18_folded"], crops, JCFG,
                                                     mesh=mesh2))
        out["tp2_vit"] = np.asarray(j_tp_embed_crops(trees["vit"], crops, JCFG, mesh=mesh2))
    return out


CASES = {  # case → the tree it embeds
    "r18_folded_tp2": "r18_folded",
    "r18_tp4": "r18",
    "r18_dpxtp": "r18",
    "vit_tp2": "vit",
    "vit_folded_dpxtp": "vit_folded",
}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_matches_jax_oracle(ranks, jax_ref, case):
    want = jax_ref[CASES[case]]
    for o in ranks:
        assert o[case].shape == (5, 512)
        np.testing.assert_allclose(o[case], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,ref", [("r18_folded_tp2", "tp2_r18"), ("vit_tp2", "tp2_vit")])
def test_tp_matches_jax_tp(ranks, jax_ref, case, ref):
    for o in ranks:
        np.testing.assert_allclose(o[case], jax_ref[ref], rtol=1e-4, atol=1e-5)


def test_vit_heads_not_divisible_raises(ranks):
    # vit_t has 2 heads (dh=128): a 4-wide model axis cannot shard them
    assert all(int(o["vit_heads"]) == 1 for o in ranks)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return 0


def test_specs_match_param_tree(trees):
    for key in ("r18", "r18_folded"):
        assert _structure(recognizer_param_specs(trees[key])) == _structure(trees[key])
    packed = pack_tp_params(trees["vit"])
    assert _structure(recognizer_param_specs(packed)) == _structure(packed)
    specs = recognizer_param_specs(trees["r18"])
    blk = specs["layer3"][0]
    assert blk["conv1"]["w"] == Shard(3) and blk["conv2"]["w"] == Shard(2)
    assert blk["bn1"]["scale"] == Replicate() and specs["fc"]["w"] == Shard(1)


@pytest.mark.parametrize("key", ["r18", "r18_folded", "vit"])
def test_weights_actually_sharded(trees, key):
    """Each rank's module holds 1/P of every sharded weight, not a copy."""
    packed = pack_tp_params(trees[key])
    full = bridge.params_from_numpy(trees[key], device="cpu")
    for idx in range(2):
        local = local_module(packed, idx, 2)
        if key == "vit":
            blk, fblk = local.blocks[0], full.blocks[0]
            assert blk.qkv.weight.shape == (fblk.qkv.weight.shape[0] // 2,
                                            fblk.qkv.weight.shape[1])
            assert blk.proj.weight.shape == (256, 128)  # rows of its heads
            d = 256
            rows = torch.cat([fblk.qkv.weight[i * d + idx * 128:i * d + (idx + 1) * 128]
                              for i in range(3)])
            torch.testing.assert_close(blk.qkv.weight, rows, rtol=0, atol=0)
        else:
            w = local.stages[2][0].unit1.conv.weight  # OIHW (256, 128, 3, 3) whole
            assert w.shape == (128, 128, 3, 3)
            torch.testing.assert_close(
                w, full.stages[2][0].unit1.conv.weight[idx * 128:(idx + 1) * 128],
                rtol=0, atol=0)
            assert local.stages[2][0].unit2.conv.weight.shape == (256, 128, 3, 3)
            assert local.fc.weight.shape == (256, full.fc.weight.shape[1])
        n_local = sum(p.numel() for p in local.parameters())
        assert n_local < 0.6 * sum(p.numel() for p in full.parameters())


def test_mbf_rejected():
    with pytest.raises(ValueError, match="IResNet"):
        recognizer_param_specs({"body": {}, "fc": {}})


def test_vit_specs_require_packed(trees):
    with pytest.raises(ValueError, match="pack_tp_params"):
        recognizer_param_specs(trees["vit"])


def test_validate_tp_width(trees):
    packed = pack_tp_params(trees["vit"])
    validate_tp_width(packed, 2)
    with pytest.raises(ValueError, match="heads"):
        validate_tp_width(packed, 4)
    validate_tp_width(trees["r18"], 4)  # IResNet widths divide by 4
