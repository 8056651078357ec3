"""Map an exported recognizer .onnx onto the port's native modules.

Port of `facerecognizeonnx_tpu/onnx_import/native_map.py`. The graph
executor runs any supported file, node by node; the native modules
(`models/arcface.py`, `mobilefacenet.py`, `vit.py`) are the fast path.
Torch exports emit nodes in forward order, so the weight sequence is
deterministic:

  IResNet convs:  stem, then per block conv1, conv2[, down] + the final Gemm
          bns:    stem, then per block bn1, bn2, bn3[, down], bn2 (post),
                  features
          prelus: stem, then one per block

Each mapper walks the per-op-type sequences against the module's
skeleton with a shape check at every step and builds the module on the
requested device: conv weights as the file holds them (OIHW, the port's
layout); the IResNet FC's rows re-permuted from the file's CHW flatten to
the NHWC flatten the port's IResNet computes. Then it SELF-VERIFIES: the
module's forward against the port's executor (reference mode, float32)
on a seeded input, on the same device, must reach cosine 1 − 1e-3, else
the mapper returns None and the caller stays on the executor. No silent
wrong-weights mode exists.

(det_500m's NAS backbone does not match the native SCRFD module: detector
files always run through the executor.)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import resolve_device
from facerecognizeonnx_tpu_torch.models.arcface import IRESNET_SPECS
from facerecognizeonnx_tpu_torch.models.mobilefacenet import MBF_SPECS, body_plan
from facerecognizeonnx_tpu_torch.models.vit import PATCH, VIT_SPECS
from facerecognizeonnx_tpu_torch.onnx_import import proto
from facerecognizeonnx_tpu_torch.onnx_import.executor import Executor

FEATURE_DIM = 512
VERIFY_COSINE = 1 - 1e-3


class _Mismatch(Exception):
    pass


def _gemm_weight(onnx_w: np.ndarray, trans_b: bool, spatial: int, cin: int) -> np.ndarray:
    """(out, in_chw) [or transposed] → (in_hwc, out): rows re-permuted."""
    w = onnx_w if trans_b else onnx_w.T  # → (out, in)
    out_dim = w.shape[0]
    w = w.reshape(out_dim, cin, spatial, spatial).transpose(0, 2, 3, 1)  # (out, H, W, C)
    return w.reshape(out_dim, -1).T


def _graph(path_or_graph) -> proto.Graph:
    if isinstance(path_or_graph, str):
        return proto.load_model(path_or_graph)
    return path_or_graph


def _collect(graph: proto.Graph):
    init = graph.initializers
    seq = {"Conv": [], "BatchNormalization": [], "PRelu": [], "Gemm": [], "MatMul": []}
    for node in graph.nodes:
        if node.op_type in seq:
            seq[node.op_type].append(
                {"node": node, "weights": [init.get(i) for i in node.inputs[1:]]}
            )
    return seq


class _Walker:
    """Takes Conv / BN / PRelu nodes in forward order, shape-checked, into
    the dicts of a JAX-structured tree (convs as "w_oihw")."""

    def __init__(self, seq):
        self.ci = iter(seq["Conv"])
        self.bi = iter(seq["BatchNormalization"])
        self.pi = iter(seq["PRelu"])

    def conv(self, kh, cin, cout, groups=None) -> Dict:
        item = next(self.ci, None)
        if item is None:
            raise _Mismatch("ran out of Conv nodes")
        w = item["weights"][0]
        want = (cout, cin // (groups or 1), kh, kh)
        if w is None or w.shape != want:
            raise _Mismatch(f"conv shape {None if w is None else w.shape} != {want}")
        if groups is not None and int(item["node"].attrs.get("group", 1)) != groups:
            raise _Mismatch("conv group attribute mismatch")
        out = {"w_oihw": np.asarray(w, np.float32)}
        if len(item["weights"]) > 1 and item["weights"][1] is not None:
            out["b"] = np.asarray(item["weights"][1], np.float32)
        return out

    def bn(self, c) -> Dict:
        item = next(self.bi, None)
        if item is None:
            raise _Mismatch("ran out of BN nodes")
        ws = item["weights"]
        if len(ws) < 4 or any(w is None or w.shape != (c,) for w in ws[:4]):
            raise _Mismatch(f"bn channels != {c}")
        return dict(zip(("scale", "bias", "mean", "var"), (np.asarray(w, np.float32) for w in ws[:4])))

    def prelu(self, c) -> Dict:
        item = next(self.pi, None)
        if item is None:
            raise _Mismatch("ran out of PRelu nodes")
        w = item["weights"][0]
        if w is None or w.size != c:
            raise _Mismatch(f"prelu channels != {c}")
        return {"alpha": np.asarray(w, np.float32).reshape(-1)}

    def exhausted(self):
        """Extra nodes mean a different arch."""
        for it, tag in ((self.ci, "Conv"), (self.bi, "BN"), (self.pi, "PRelu")):
            if next(it, None) is not None:
                raise _Mismatch(f"extra {tag} nodes")


def _fc(gemms, feat_in: int):
    """The head Gemm's (weight (out, in), bias or None, transB)."""
    if not gemms:
        raise _Mismatch("no Gemm/MatMul head")
    gemm = gemms[0]
    w = gemm["weights"][0]
    if w is None:
        raise _Mismatch("Gemm weight not an initializer")
    trans_b = bool(gemm["node"].attrs.get("transB", 0))
    wt = w if trans_b else w.T
    if wt.shape != (FEATURE_DIM, feat_in):
        raise _Mismatch(f"fc shape {w.shape} unexpected")
    b = gemm["weights"][1] if len(gemm["weights"]) > 1 else None
    return np.asarray(w, np.float32), None if b is None else np.asarray(b, np.float32), trans_b


def _verified(tree: Dict, graph: proto.Graph, input_size: int, device, verify: bool):
    """The module of `tree` on `device` if its forward agrees with the
    executor's (cosine ≥ VERIFY_COSINE, kept as `model.verify_cosine`),
    else None."""
    try:
        model = bridge.params_from_numpy(tree, device)
    except (KeyError, ValueError) as e:
        raise _Mismatch(str(e)) from e
    if not verify:
        return model
    try:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(
            rng.uniform(-1, 1, (1, input_size, input_size, 3)).astype(np.float32)
        ).to(device)
        with torch.no_grad():
            native = model(x).reshape(-1)
            ex = Executor(graph, device=x.device)
            ref = torch.as_tensor(
                ex.run({ex.input_names[0]: x.permute(0, 3, 1, 2)})[0]
            ).reshape(-1).to(torch.float32)
            cos = float((native * ref).sum()
                        / torch.clamp_min(native.norm() * ref.norm(), 1e-12))
    except Exception:  # noqa: BLE001 — a graph that cannot run earns no mapping
        return None
    if not np.isfinite(cos) or cos < VERIFY_COSINE:
        return None
    model.verify_cosine = cos
    return model


def map_arcface(path_or_graph, arch: str = "iresnet50", input_size: int = 112,
                verify: bool = True, device="cuda") -> Optional[torch.nn.Module]:
    """The port's IResNet (unfolded) on `device`, or None where the graph
    does not match `arch` (depth, a shape, or the numeric self-check)."""
    graph = _graph(path_or_graph)
    seq = _collect(graph)
    blocks, widths = IRESNET_SPECS[arch]
    take = _Walker(seq)
    try:
        tree: Dict = {"conv1": take.conv(3, 3, 64), "bn1": take.bn(64),
                      "prelu1": take.prelu(64)}
        inplanes = 64
        for s, (n, planes) in enumerate(zip(blocks, widths), start=1):
            stage = []
            for b in range(n):
                blk = {"bn1": take.bn(inplanes), "conv1": take.conv(3, inplanes, planes),
                       "bn2": take.bn(planes), "prelu": take.prelu(planes),
                       "conv2": take.conv(3, planes, planes), "bn3": take.bn(planes)}
                if b == 0 or inplanes != planes:
                    blk["down_conv"] = take.conv(1, inplanes, planes)
                    blk["down_bn"] = take.bn(planes)
                stage.append(blk)
                inplanes = planes
            tree[f"layer{s}"] = stage
        tree["bn2"] = take.bn(widths[-1])
        spatial = input_size // 16
        w, b, trans_b = _fc(seq["Gemm"] + seq["MatMul"], widths[-1] * spatial * spatial)
        tree["fc"] = {"w": _gemm_weight(w, trans_b, spatial, widths[-1])}
        if b is not None:
            tree["fc"]["b"] = b
        tree["features_bn"] = take.bn(FEATURE_DIM)
        take.exhausted()
        return _verified(tree, graph, input_size, resolve_device(device), verify)
    except _Mismatch:
        return None


def map_mobilefacenet(path_or_graph, arch: str = "mbf", input_size: int = 112,
                      verify: bool = True, device="cuda") -> Optional[torch.nn.Module]:
    """A w600k_mbf-shaped export onto the port's MobileFaceNet; the
    contract of map_arcface."""
    graph = _graph(path_or_graph)
    seq = _collect(graph)
    blocks, scale = MBF_SPECS[arch]
    take = _Walker(seq)
    c64 = 64 * scale
    spatial = input_size // 16
    try:
        tree: Dict = {
            "stem": {"conv": take.conv(3, 3, c64, 1), "bn": take.bn(c64),
                     "prelu": take.prelu(c64)},
            "stem_dw": {"conv": take.conv(3, c64, c64, 64), "bn": take.bn(c64),
                        "prelu": take.prelu(c64)},
        }
        body = []
        for cin, cout, g, _stride in body_plan(blocks, scale):
            body.append({
                "pw1": take.conv(1, cin, g, 1), "pw1_bn": take.bn(g),
                "pw1_prelu": take.prelu(g),
                "dw": take.conv(3, g, g, g), "dw_bn": take.bn(g), "dw_prelu": take.prelu(g),
                "pw2": take.conv(1, g, cout, 1), "pw2_bn": take.bn(cout),
            })
        tree["body"] = body
        tree["conv_sep"] = {"conv": take.conv(1, 2 * c64, 512, 1), "bn": take.bn(512),
                            "prelu": take.prelu(512)}
        tree["gdc_dw"] = {"conv": take.conv(spatial, 512, 512, 512), "bn": take.bn(512)}
        # the GDC output is 1x1, so its CHW flatten is channel order
        w, b, trans_b = _fc(seq["Gemm"] + seq["MatMul"], 512)
        tree["fc"] = {"w": (w if trans_b else w.T).T}
        if b is not None:
            tree["fc"]["b"] = b
        tree["features_bn"] = take.bn(FEATURE_DIM)
        take.exhausted()
        return _verified(tree, graph, input_size, resolve_device(device), verify)
    except _Mismatch:
        return None


def map_vit(path_or_graph, arch: str = "vit_t", input_size: int = 112,
            verify: bool = True, device="cuda") -> Optional[torch.nn.Module]:
    """A ViT recognizer .onnx (the decomposed-LN opset-9 graph that
    `onnx_export.emit_vit_onnx` writes) onto the port's ViT. `arch` is
    advisory: the width comes from the patch Conv. The contract of
    map_arcface.

    Weights are found by structure, not name: LayerNorm scales are the
    Mul operands shaped (D,) (the attention and GELU scalings are 0-d),
    each LN bias is the Add consuming that Mul's output, and each
    MatMul's bias the Add consuming the MatMul's output."""
    del arch
    graph = _graph(path_or_graph)
    init = graph.initializers
    by_dim = {dim: (name, depth) for name, (dim, depth, _) in VIT_SPECS.items()}
    try:
        convs = [n for n in graph.nodes if n.op_type == "Conv"]
        gemms = [n for n in graph.nodes if n.op_type == "Gemm"]
        bns = [n for n in graph.nodes if n.op_type == "BatchNormalization"]
        if len(convs) != 1 or len(gemms) != 1 or len(bns) != 1:
            return None
        wc = init.get(convs[0].inputs[1])
        if wc is None or wc.ndim != 4 or wc.shape[1] != 3:
            return None
        d, patch = wc.shape[0], wc.shape[2]
        if patch != PATCH or d not in by_dim:
            return None
        depth = by_dim[d][1]

        consumers: Dict[str, List[proto.Node]] = {}
        for n in graph.nodes:
            for i in n.inputs:
                consumers.setdefault(i, []).append(n)

        def bias_of(node):
            """The (single-initializer) Add consuming `node`'s output."""
            for c in consumers.get(node.outputs[0], []):
                if c.op_type == "Add":
                    for i in c.inputs:
                        if i in init:
                            return np.asarray(init[i], np.float32)
            return None

        # patch conv OIHW (D, 3, P, P) → the (py, px, c)-flat linear
        w_patch = np.transpose(np.asarray(wc, np.float32), (2, 3, 1, 0)).reshape(-1, d)
        b_patch = (np.asarray(init[convs[0].inputs[2]], np.float32)
                   if len(convs[0].inputs) > 2 else np.zeros(d, np.float32))

        pos = None  # the Add with a rank-2 (T, D) initializer
        for n in graph.nodes:
            if n.op_type == "Add":
                for i in n.inputs:
                    a = init.get(i)
                    if a is not None and a.ndim == 2 and a.shape[1] == d:
                        pos = np.asarray(a, np.float32)
        if pos is None or pos.shape != ((input_size // patch) ** 2, d):
            return None

        # weight MatMuls in forward order, depth x [qkv, proj, mlp1, mlp2]
        mms = [n for n in graph.nodes
               if n.op_type == "MatMul" and any(i in init for i in n.inputs)]
        if len(mms) != 4 * depth:
            return None

        def mm_weights(node, din, dout):
            w = next(np.asarray(init[i], np.float32) for i in node.inputs if i in init)
            if w.shape != (din, dout):
                raise _Mismatch(f"{w.shape} != {(din, dout)}")
            b = bias_of(node)
            if b is None or b.shape != (dout,):
                raise _Mismatch("missing bias")
            return {"w": w, "b": b}

        # LayerNorm scales, [block0 ln1, block0 ln2, ..., ln_f]
        ln_muls = []
        for n in graph.nodes:
            if n.op_type == "Mul":
                for i in n.inputs:
                    a = init.get(i)
                    if a is not None and a.shape == (d,):
                        ln_muls.append((n, np.asarray(a, np.float32)))
        if len(ln_muls) != 2 * depth + 1:
            return None

        def ln_params(idx):
            node, scale = ln_muls[idx]
            bias = bias_of(node)
            if bias is None or bias.shape != (d,):
                raise _Mismatch("ln bias")
            return {"scale": scale, "bias": bias}

        blocks = [{
            "ln1": ln_params(2 * b),
            "qkv": mm_weights(mms[4 * b], d, 3 * d),
            "proj": mm_weights(mms[4 * b + 1], d, d),
            "ln2": ln_params(2 * b + 1),
            "mlp1": mm_weights(mms[4 * b + 2], d, 4 * d),
            "mlp2": mm_weights(mms[4 * b + 3], 4 * d, d),
        } for b in range(depth)]

        gw = np.asarray(init[gemms[0].inputs[1]], np.float32)
        gw = gw.T if gemms[0].attrs.get("transB", 0) else gw  # → (D, out)
        if gw.shape[0] != d:
            return None
        bn = bns[0]
        tree = {
            "patch": {"w": w_patch, "b": b_patch},
            "pos_embed": pos,
            "blocks": blocks,
            "ln_f": ln_params(2 * depth),
            "fc": {"w": gw, "b": np.asarray(init[gemms[0].inputs[2]], np.float32)},
            "features_bn": {k: np.asarray(init[i], np.float32)
                            for k, i in zip(("scale", "bias", "mean", "var"), bn.inputs[1:5])},
        }
        return _verified(tree, graph, input_size, resolve_device(device), verify)
    except (_Mismatch, KeyError, StopIteration, IndexError):
        return None


def map_recognizer(path, arch: str, input_size: int = 112,
                   device="cuda") -> Optional[torch.nn.Module]:
    """Arch-directed mapping: the mapper of `arch`'s family first, then the
    other two (each self-verifies, so a wrong guess costs a failed walk,
    never wrong weights). `path`: a file or a parsed `proto.Graph`."""
    graph = _graph(path)
    if arch.startswith("mbf"):
        attempts = [(map_mobilefacenet, arch), (map_arcface, "iresnet50"), (map_vit, "vit_t")]
    elif arch.startswith("vit"):
        attempts = [(map_vit, arch), (map_arcface, "iresnet50"), (map_mobilefacenet, "mbf")]
    else:
        attempts = [(map_arcface, arch), (map_mobilefacenet, "mbf"), (map_vit, "vit_t")]
    for fn, a in attempts:
        mapped = fn(graph, arch=a, input_size=input_size, device=device)
        if mapped is not None:
            return mapped
    return None
