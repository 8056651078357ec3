"""The fused IResNet forward (`models/arcface.py` `iresnet_forward_fused`)
and its epilogue (`ops/conv_epilogue.py`, the plain version on the CPU).

Each epilogue form is held bit for bit against the eager layers it
replaces (`layers.conv2d`'s bias and rounding, `prelu`, the residual add,
`batch_norm`, the next conv's operand cast) on inputs with bf16 ties,
NaN, ±inf and −0.0 planted; the fused forward against the eager one on
a folded iresnet18 at 32², B=2; the rule that picks the fused path; the
weights kept per module; `torch.export` through the custom op's fake.
The kernel itself is held against the plain version on the card by
`chip_smoke.py --only conv_epilogue` (`test_kernel_on_the_card`).
"""

import copy
import types
import unittest.mock

import numpy as np
import pytest
import torch

from chip_smoke import EPILOGUE_FORMS, epilogue_case, jitter_bn, same_bits
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.models import arcface, layers, quant
from facerecognizeonnx_tpu_torch.ops import conv_epilogue as ce
from facerecognizeonnx_tpu_torch.utils import observability as obs

BF16 = torch.bfloat16
SIZE = 32


@pytest.fixture(scope="module")
def models():
    """(unfolded, folded) iresnet18 at 32² with seeded BN statistics and
    PReLU slopes, and a seeded (2, 32, 32, 3) input."""
    rng = np.random.default_rng(19)
    tree = jitter_bn(bridge.init_params_numpy("iresnet18", seed=5, input_size=SIZE), rng)
    raw = bridge.params_from_numpy(tree, "cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    return raw, arcface.fold_inference_params(raw), x


def _eager_conv2d(y, bias):
    """`layers.conv2d`'s bias and rounding of a conv output `y`."""
    with unittest.mock.patch.object(layers.F, "conv2d", lambda *a, **k: y):
        return layers.conv2d(y, torch.zeros(1), bias, compute_dtype=BF16)


@pytest.mark.parametrize("form", list(EPILOGUE_FORMS))
@pytest.mark.parametrize("C", [8, 64])
def test_epilogue_forms_match_the_eager_layers(form, C):
    gen = torch.Generator().manual_seed(C)
    kw = epilogue_case(gen, "cpu", form, (2, C, 5, 7))
    bn = kw.pop("bn", None)
    mod = None
    if bn is not None:
        c = torch.Generator().manual_seed(C + 1)
        mod = layers.BatchNorm(torch.rand(C, generator=c) + 0.5, torch.randn(C, generator=c),
                               torch.randn(C, generator=c), torch.rand(C, generator=c) + 0.5)
        kw["bn"] = arcface.bn_tables(mod)
    got = ce.conv_epilogue(**kw)

    t = _eager_conv2d(kw["y"], kw["bias"])
    if "alpha" in kw:
        t = layers.prelu(t, kw["alpha"])
    if "res" in kw:
        t = t + kw["res"]
    elif "down" in kw:
        t = t + _eager_conv2d(*kw["down"])
    operand = t.to(BF16).to(torch.float32)  # what conv2d makes of its input
    want = (
        operand if kw["write_f32"] else None,
        t if kw["write_bf16"] else None,
        None if mod is None else layers.batch_norm(
            t, mod.scale, mod.bias, mod.mean, mod.var).to(BF16).to(torch.float32),
    )
    for name, a, b in zip(("f32", "bf16", "bn"), got, want):
        assert same_bits(a, b), (form, name)
    assert torch.isnan(kw["y"]).any() and (kw["y"] == float("inf")).any()
    if got[0] is not None:  # −0.0 and NaN survive into the operand
        assert torch.isnan(got[0]).any()


def test_epilogue_case_plants_bf16_ties():
    """The planted y + bias lie halfway between two bf16 values, and
    `layers.conv2d` rounds them to even."""
    kw = epilogue_case(torch.Generator().manual_seed(3), "cpu", "conv1", (2, 16, 6, 5))
    s = kw["y"][:, :, ::3] + kw["bias"].view(1, -1, 1, 1)
    tie = (s.view(torch.int32) & 0xFFFF) == 0x8000
    assert tie.float().mean() > 0.9
    rounded = _eager_conv2d(kw["y"], kw["bias"])[:, :, ::3]
    assert ((rounded.view(torch.int16) & 1)[tie] == 0).all()


@pytest.mark.parametrize("features_bn", [False, True])
def test_fused_forward_matches_eager_on_cpu(models, features_bn):
    raw, folded, x = models
    model = folded
    if features_bn:  # the units folded, the head's BatchNorm kept
        model = copy.deepcopy(folded)
        model.fc, model.features_bn = raw.fc, raw.features_bn
    assert (model.features_bn is not None) == features_bn
    with torch.no_grad():
        want = model(x, BF16)
        got = arcface.iresnet_forward_fused(model, x, BF16)
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    assert same_bits(got, want)


def _cuda_input(requires_grad=False):
    """What `fusable` reads of a CUDA input."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=requires_grad)


def test_fusable_takes_a_folded_bf16_model_on_cuda(models):
    _, folded, x = models
    assert arcface.fusable(folded, _cuda_input(), BF16)
    assert not arcface.fusable(folded, x, BF16)  # a CPU input


@pytest.mark.parametrize("case", ["f32", "train", "grad", "input_grad", "qconv", "unfolded",
                                  "shortcut_prelu"])
def test_fusable_refuses(models, case):
    raw, folded, _ = models
    model, x, dtype = copy.deepcopy(folded), _cuda_input(), BF16
    stats = None
    if case == "f32":
        dtype = torch.float32
    elif case == "train":
        stats = {}
    elif case == "grad":
        model.stages[1][0].unit1.conv.weight.requires_grad_(True)
    elif case == "input_grad":
        x = _cuda_input(requires_grad=True)
    elif case == "qconv":
        unit = model.stages[2][1].unit2
        unit.conv = quant.QConv(unit.conv)
    elif case == "unfolded":
        model = raw
    elif case == "shortcut_prelu":
        model.stages[0][0].down.act = model.stem.act
    prev, layers._TRAIN.stats = layers._TRAIN.stats, stats
    try:
        assert not arcface.fusable(model, x, dtype)
    finally:
        layers._TRAIN.stats = prev
    if case == "input_grad":
        with torch.no_grad():  # no graph is recorded, so the input's flag does not matter
            assert arcface.fusable(model, x, dtype)


def test_block_counters(models):
    """`iresnet_blocks` counts every block a forward runs, eager or fused;
    `iresnet_blocks_fused` the fused ones."""
    _, folded, x = models
    n = sum(len(s) for s in folded.stages)
    obs.reset()
    obs.enable(True)
    try:
        with torch.no_grad():
            folded(x, BF16)  # the CPU takes the eager path
            eager = dict(obs.snapshot()["counters"])
            arcface.iresnet_forward_fused(folded, x, BF16)
            both = obs.snapshot()["counters"]
    finally:
        obs.enable(False)
        obs.reset()
    assert eager == {"iresnet_blocks": n}
    assert both == {"iresnet_blocks": 2 * n, "iresnet_blocks_fused": n}


def test_weights_are_rounded_once_and_follow_changes(models):
    _, folded, x = models
    model = copy.deepcopy(folded)
    conv = model.stages[1][1].unit1.conv
    with torch.no_grad():
        arcface.iresnet_forward_fused(model, x, BF16)
        w1 = arcface._DERIVED[conv][2]
        assert w1.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(w1, conv.weight.to(BF16).float())
        arcface.iresnet_forward_fused(model, x, BF16)
        assert arcface._DERIVED[conv][2] is w1  # kept
        conv.weight.mul_(1.5)  # in place: the kept copy is stale
        got = arcface.iresnet_forward_fused(model, x, BF16)
        assert arcface._DERIVED[conv][2] is not w1
        assert same_bits(got, model(x, BF16))
        model.bn2.mean.add_(0.25)
        assert same_bits(arcface.iresnet_forward_fused(model, x, BF16), model(x, BF16))


def test_epilogue_wrapper_rejects():
    y = torch.zeros((1, 8, 2, 2))
    with pytest.raises(Exception, match="res or down"):
        ce.conv_epilogue(y, torch.zeros(8), res=y.to(BF16), down=(y, torch.zeros(8)))
    with pytest.raises(Exception, match="multiple of 8"):
        ce._check_kernel_inputs(torch.zeros((1, 12, 2, 2)), [])
    with pytest.raises(Exception, match="channels-last"):
        ce._check_kernel_inputs(y, [("res", torch.zeros((1, 8, 2, 2), dtype=BF16), BF16, True)])
    with pytest.raises(Exception, match="float32"):
        ce._check_kernel_inputs(y, [("bias", torch.zeros(8, dtype=BF16), torch.float32, False)])


def test_export_traces_the_custom_op(models):
    """`torch.export` traces the fused forward through `frt::conv_epilogue`'s
    fake: one node per epilogue (1 + 2 a block), and the program computes
    the eager result."""
    _, folded, x = models

    class Fused(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            return arcface.iresnet_forward_fused(self.model, x, BF16)

    with torch.no_grad():
        ep = torch.export.export(Fused(folded), (x,), strict=False)
        got = ep.module()(x)
        want = folded(x, BF16)
    n = sum(len(s) for s in folded.stages)
    calls = [nd for nd in ep.graph.nodes if "conv_epilogue" in str(nd.target)]
    assert len(calls) == 1 + 2 * n
    assert same_bits(got, want)


def test_kernel_on_the_card():
    """The kernel against its plain version and the fused IResNet-50
    against the eager one, on the card (chip_smoke's epilogue phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python3 chip_smoke.py --only conv_epilogue`")
    import chip_smoke

    chip_smoke.phase_conv_epilogue(torch.device("cuda", 0))
