"""The port's native mappers vs the JAX package's.

Each family's tree (numpy, JAX layout; BN statistics and PReLU slopes
drawn so that no BN is the identity) is exported by the port, mapped
back by both packages, and the mapped modules are held to the original
weights (atol 1e-6) and to the JAX mapped forward; a wrong arch, a node
order that breaks the walk, and a graph whose weights fit the shapes but
not the numbers (an HWC flatten before the FC) all give None.
"""

import jax
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.models import arcface as j_arcface
from facerecognizeonnx_tpu.models import mobilefacenet as j_mbf
from facerecognizeonnx_tpu.models import vit as j_vit
from facerecognizeonnx_tpu.onnx_import import native_map as jmap
from facerecognizeonnx_tpu_torch import bridge, onnx_export
from facerecognizeonnx_tpu_torch.models.arcface import IResNet
from facerecognizeonnx_tpu_torch.models.mobilefacenet import MobileFaceNet
from facerecognizeonnx_tpu_torch.models.vit import ViT
from facerecognizeonnx_tpu_torch.onnx_import import proto
from facerecognizeonnx_tpu_torch.onnx_import.native_map import (
    map_arcface,
    map_mobilefacenet,
    map_recognizer,
    map_vit,
)

SIZE = 32
FAMILIES = {
    "iresnet18": (map_arcface, jmap.map_arcface, j_arcface, IResNet),
    "mbf": (map_mobilefacenet, jmap.map_mobilefacenet, j_mbf, MobileFaceNet),
    "vit_t": (map_vit, jmap.map_vit, j_vit, ViT),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """BN statistics and PReLU slopes away from their identity init."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32),
                    "mean": rng.normal(0, 0.1, c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        if set(tree) == {"alpha"}:
            return {"alpha": rng.uniform(0.1, 0.3, tree["alpha"].shape).astype(np.float32)}
        return {k: _perturb(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """arch → (tree, port module, .onnx path)."""
    root = tmp_path_factory.mktemp("rec")
    out = {}
    for i, arch in enumerate(FAMILIES):
        tree = _perturb(bridge.init_params_numpy(arch, seed=10 + i, input_size=SIZE),
                        np.random.default_rng(i))
        model = bridge.params_from_numpy(tree, "cpu")
        path = str(root / f"{arch}.onnx")
        onnx_export.export_recognizer(model, path, input_size=SIZE)
        out[arch] = (tree, model, path)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_round_trip_recovers_weights(exported, arch):
    tree, model, path = exported[arch]
    mapper, _, _, cls = FAMILIES[arch]
    mapped = mapper(path, arch=arch, input_size=SIZE, device="cpu")
    assert isinstance(mapped, cls) and mapped.verify_cosine >= 1 - 1e-3
    want = dict(_leaves(tree))
    got = dict(_leaves(bridge.tree_from_module(mapped)))
    if arch == "mbf":  # the export writes no FC bias where the tree has none
        assert "/fc/b" not in want and "/fc/b" not in got
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_mapped_forward_matches_jax_mapped_forward(exported, arch):
    _, _, path = exported[arch]
    mapper, jmapper, jmod, _ = FAMILIES[arch]
    mapped = mapper(path, arch=arch, input_size=SIZE, device="cpu")
    jtree = jmapper(path, arch=arch, input_size=SIZE, verify=False)
    assert jtree is not None
    x = np.random.default_rng(7).uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: jmod.apply(p, a))(jtree, x))
    with torch.no_grad():
        got = mapped(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()  # random weights: features reach ~1e4
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


def test_wrong_arch_and_broken_walks_return_none(exported):
    _, _, path = exported["iresnet18"]
    assert map_arcface(path, arch="iresnet34", input_size=SIZE, device="cpu") is None
    assert map_mobilefacenet(path, arch="mbf", input_size=SIZE, device="cpu") is None
    assert map_vit(path, input_size=SIZE, device="cpu") is None
    graph = proto.load_model(path)
    convs = [i for i, n in enumerate(graph.nodes) if n.op_type == "Conv"]
    nodes = list(graph.nodes)
    nodes[convs[0]], nodes[convs[1]] = nodes[convs[1]], nodes[convs[0]]  # stem ↔ 64→64
    reordered = proto.Graph(graph.name, nodes, graph.initializers, graph.inputs, graph.outputs)
    assert map_arcface(reordered, arch="iresnet18", input_size=SIZE, device="cpu") is None


def test_self_verification_rejects_weights_that_fit_the_shapes(exported):
    """A Transpose(0, 2, 3, 1) before the Flatten (an FC over an HWC
    flatten, not torch's CHW): every node and shape of the walk fits, the
    mapped module and the executor disagree, the mapper says None."""
    _, _, path = exported["iresnet18"]
    graph = proto.load_model(path)
    nodes = []
    for n in graph.nodes:
        if n.op_type == "Flatten":
            nodes.append(proto.Node("Transpose", "", [n.inputs[0]], ["hwc"], {"perm": [0, 2, 3, 1]}))
            n = proto.Node(n.op_type, n.name, ["hwc"], n.outputs, n.attrs)
        nodes.append(n)
    hwc = proto.Graph(graph.name, nodes, graph.initializers, graph.inputs, graph.outputs)
    unverified = map_arcface(hwc, arch="iresnet18", input_size=SIZE, verify=False, device="cpu")
    assert isinstance(unverified, IResNet)  # the walk itself fits
    assert map_arcface(hwc, arch="iresnet18", input_size=SIZE, device="cpu") is None


@pytest.mark.parametrize("arch, cfg_arch", [("iresnet18", "iresnet18"), ("mbf", "mbf"),
                                            ("vit_t", "vit_t"), ("vit_t", "iresnet18"),
                                            ("mbf", "vit_b")])
def test_map_recognizer_routes_by_family(exported, arch, cfg_arch):
    _, model, path = exported[arch]
    mapped = map_recognizer(path, cfg_arch, input_size=SIZE, device="cpu")
    assert type(mapped) is type(model)
