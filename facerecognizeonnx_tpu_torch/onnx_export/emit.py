"""Emit native model param trees as ONNX graphs (torch-export-shaped).

The port's copy of `facerecognizeonnx_tpu/onnx_export/emit.py`: the same
emitters over the same JAX-layout numpy trees (`bridge.tree_from_module`
makes one from a port module), so the same weights give the same bytes.
The inverse of onnx_import/native_map.py: forward-execution node order,
OIHW weights, CHW-flatten Gemm, as torch.onnx writes the InsightFace
w600k family, so an exported file loads back through the importer and
through stock ONNX Runtime.

Export UNFOLDED params (BNs intact): the graphs carry explicit
BatchNormalization nodes, as the published w600k files do.
"""

from __future__ import annotations

import numpy as np

from facerecognizeonnx_tpu_torch.models.arcface import IRESNET_SPECS
from facerecognizeonnx_tpu_torch.models.mobilefacenet import MBF_SPECS
from facerecognizeonnx_tpu_torch.models.mobilefacenet import body_plan as _body_plan
from facerecognizeonnx_tpu_torch.onnx_export import writer as W


class _Emitter:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self.n = 0

    def name(self, tag_):
        self.n += 1
        return f"{tag_}_{self.n}"

    def conv(self, x, p, stride, pad, groups=1):
        out = self.name("conv")
        w = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))  # HWIO→OIHW
        wn = out + "_w"
        self.inits.append(W.tensor(wn, np.ascontiguousarray(w)))
        inputs = [x, wn]
        if "b" in p:
            bn_ = out + "_b"
            self.inits.append(W.tensor(bn_, np.asarray(p["b"])))
            inputs.append(bn_)
        kh = w.shape[2]
        attrs = dict(strides=[stride, stride], pads=[pad] * 4,
                     kernel_shape=[kh, kh])
        if groups != 1:  # torch exports group=1 implicitly otherwise
            attrs["group"] = groups
        self.nodes.append(W.node("Conv", inputs, [out], **attrs))
        return out

    def bn(self, x, p):
        out = self.name("bn")
        names = []
        for suffix, key in (("_g", "scale"), ("_b", "bias"), ("_m", "mean"), ("_v", "var")):
            nm = out + suffix
            self.inits.append(W.tensor(nm, np.asarray(p[key])))
            names.append(nm)
        self.nodes.append(
            W.node("BatchNormalization", [x] + names, [out], epsilon=1e-5)
        )
        return out

    def prelu(self, x, p):
        out = self.name("prelu")
        nm = out + "_s"
        # torch exports slope as (C, 1, 1)
        self.inits.append(
            W.tensor(nm, np.asarray(p["alpha"]).reshape(-1, 1, 1))
        )
        self.nodes.append(W.node("PRelu", [x, nm], [out]))
        return out


def emit_iresnet_onnx(params, arch: str, input_size: int) -> bytes:
    blocks, widths = IRESNET_SPECS[arch]
    e = _Emitter()
    x = e.conv("input", params["conv1"], 1, 1)
    x = e.bn(x, params["bn1"])
    x = e.prelu(x, params["prelu1"])
    for s, n in enumerate(blocks, start=1):
        for b in range(n):
            blk = params[f"layer{s}"][b]
            stride = 2 if b == 0 else 1
            identity = x
            out = e.bn(x, blk["bn1"])
            out = e.conv(out, blk["conv1"], 1, 1)
            out = e.bn(out, blk["bn2"])
            out = e.prelu(out, blk["prelu"])
            out = e.conv(out, blk["conv2"], stride, 1)
            out = e.bn(out, blk["bn3"])
            if "down_conv" in blk:
                identity = e.conv(x, blk["down_conv"], stride, 0)
                identity = e.bn(identity, blk["down_bn"])
            summed = e.name("add")
            e.nodes.append(W.node("Add", [out, identity], [summed]))
            x = summed
    x = e.bn(x, params["bn2"])
    flat = e.name("flatten")
    e.nodes.append(W.node("Flatten", [x], [flat], axis=1))
    # native fc: (in_hwc, out) → onnx Gemm transB=1 weight (out, in_chw)
    spatial = input_size // 16
    c = widths[-1]
    w_native = np.asarray(params["fc"]["w"])  # (in_hwc, out)
    out_dim = w_native.shape[1]
    w = w_native.T.reshape(out_dim, spatial, spatial, c)
    w = np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, -1)
    e.inits.append(W.tensor("fc_w", np.ascontiguousarray(w)))
    e.inits.append(W.tensor("fc_b", np.asarray(params["fc"]["b"])))
    gemm_out = e.name("gemm")
    e.nodes.append(
        W.node("Gemm", [flat, "fc_w", "fc_b"], [gemm_out],
               alpha=1.0, beta=1.0, transB=1)
    )
    feat = e.bn(gemm_out, params["features_bn"])
    g = W.graph(
        e.nodes, e.inits,
        [("input", [1, 3, input_size, input_size])],
        [(feat, [1, out_dim])],
    )
    return W.model(g)


def emit_mobilefacenet_onnx(params, input_size: int = 112) -> bytes:
    blocks, scale = next(
        (b, s)
        for b, s in MBF_SPECS.values()
        if len(_body_plan(b, s)) == len(params["body"])
    )
    plan = _body_plan(blocks, scale)
    e = _Emitter()

    def cbp(x, p, stride=1, pad=0, groups=1):
        x = e.conv(x, p["conv"], stride, pad, groups=groups)
        x = e.bn(x, p["bn"])
        return e.prelu(x, p["prelu"])

    x = cbp("input", params["stem"], 2, 1)
    x = cbp(x, params["stem_dw"], 1, 1, groups=64)
    for (_cin, _cout, g, stride), blk in zip(plan, params["body"]):
        y = e.conv(x, blk["pw1"], 1, 0)
        y = e.bn(y, blk["pw1_bn"])
        y = e.prelu(y, blk["pw1_prelu"])
        y = e.conv(y, blk["dw"], stride, 1, groups=g)
        y = e.bn(y, blk["dw_bn"])
        y = e.prelu(y, blk["dw_prelu"])
        y = e.conv(y, blk["pw2"], 1, 0)
        y = e.bn(y, blk["pw2_bn"])
        if stride == 1:
            summed = e.name("add")
            e.nodes.append(W.node("Add", [x, y], [summed]))
            x = summed
        else:
            x = y
    x = cbp(x, params["conv_sep"], 1, 0)
    x = e.conv(x, params["gdc_dw"]["conv"], 1, 0, groups=512)
    x = e.bn(x, params["gdc_dw"]["bn"])

    flat = e.name("flatten")
    e.nodes.append(W.node("Flatten", [x], [flat], axis=1))
    # GDC output is (B, 512, 1, 1) → CHW flatten == channel order, so the
    # native (512, out) FC transposes directly to Gemm transB weight
    w_native = np.asarray(params["fc"]["w"])  # (512, out)
    out_dim = w_native.shape[1]
    e.inits.append(W.tensor("fc_w", np.ascontiguousarray(w_native.T)))
    gemm_out = e.name("gemm")
    e.nodes.append(
        W.node("Gemm", [flat, "fc_w"], [gemm_out], alpha=1.0, beta=1.0,
               transB=1)
    )
    feat = e.bn(gemm_out, params["features_bn"])
    g = W.graph(
        e.nodes, e.inits,
        [("input", [1, 3, input_size, input_size])],
        [(feat, [1, out_dim])],
    )
    return W.model(g)


def emit_scrfd_onnx(params, input_size: int = 640) -> bytes:
    """Emit the native SCRFD detector as a 9-output ONNX graph.

    Canonical det_* layout: NCHW input (1,3,S,S), outputs
    score_8..kps_32 shaped (1, H*W*A, {1,4,10}) with anchor index
    fastest and post-sigmoid scores — exactly the raw-output contract
    the importer's OnnxRunner classifies and detect/decode.py consumes
    (the contract the reference's det_500m.onnx has but the reference
    itself never decodes, SURVEY.md §2 quirk). Head weights are shared
    across strides in the native model; the graph re-emits them per
    stride (ONNX has no weight-tying; file grows ~2 x 150 KB).

    Export UNFOLDED params. s2d variants emit an ONNX SpaceToDepth
    stem (its channel order matches the native transform exactly).
    """
    from facerecognizeonnx_tpu_torch.models.scrfd import (
        NUM_ANCHORS,
        SCRFD_VARIANTS,
        STRIDES,
        infer_variant,
    )
    from facerecognizeonnx_tpu_torch.models.scrfd import variant_taps as _variant_taps

    variant = infer_variant(params)
    spec = SCRFD_VARIANTS[variant]
    if "bn" not in params["stem"]:
        raise ValueError("params look BN-folded: export needs UNFOLDED params")
    plan = spec["plan"]
    tap_names = _variant_taps(plan)

    e = _Emitter()

    def shape_init(vals):
        nm = e.name("shape")
        e.inits.append(W.tensor(nm, np.asarray(vals, np.int64), use_raw=False))
        return nm

    def scalar_init(v):
        nm = e.name("scalar")
        e.inits.append(W.tensor(nm, np.asarray(v, np.float32)))
        return nm

    p = params["stem"]
    s2d = int(spec.get("s2d", 0))
    stem_in = "input"
    if s2d:
        # ONNX SpaceToDepth's (block_y, block_x, channel) output order
        # matches models/scrfd._space_to_depth exactly, so the stem conv
        # weights transpose with NO channel permutation.
        stem_in = e.name("s2d")
        e.nodes.append(
            W.node("SpaceToDepth", ["input"], [stem_in], blocksize=s2d)
        )
    x = e.conv(stem_in, p["conv"], 1 if s2d else 2, 1)
    x = e.bn(x, p["bn"])
    x = e.prelu(x, p["prelu"])

    taps = {}
    cin = plan[0][0]
    for (cout, stride), blk in zip(plan[1:], params["backbone"]):
        if "conv" in blk:  # dense (TPU) block
            x = e.conv(x, blk["conv"], stride, 1)
            x = e.bn(x, blk["bn"])
            x = e.prelu(x, blk["prelu"])
        else:
            x = e.conv(x, blk["dw"], stride, 1, groups=cin)
            x = e.bn(x, blk["dw_bn"])
            x = e.prelu(x, blk["dw_prelu"])
            x = e.conv(x, blk["pw"], 1, 0)
            x = e.bn(x, blk["pw_bn"])
            x = e.prelu(x, blk["pw_prelu"])
        cin = cout
        if cout in tap_names and stride == 1:
            taps[tap_names[cout]] = x

    n = params["neck"]
    p5 = e.conv(taps["c5"], n["lat_c5"], 1, 0)
    p4 = e.conv(taps["c4"], n["lat_c4"], 1, 0)
    p3 = e.conv(taps["c3"], n["lat_c3"], 1, 0)

    def upsample2x(src):
        out = e.name("up")
        e.nodes.append(
            W.node("Upsample", [src], [out], mode=b"nearest",
                   scales=[1.0, 1.0, 2.0, 2.0])
        )
        return out

    def add(a, b):
        out = e.name("add")
        e.nodes.append(W.node("Add", [a, b], [out]))
        return out

    p4 = add(p4, upsample2x(p5))
    p3 = add(p3, upsample2x(p4))
    p3 = e.conv(p3, n["smooth_p3"], 1, 1)
    p4 = e.conv(p4, n["smooth_p4"], 1, 1)
    p5 = e.conv(p5, n["smooth_p5"], 1, 1)

    outputs = []
    for stride, feat in zip(STRIDES, (p3, p4, p5)):
        h = feat
        for cp in params["head"]["convs"]:
            h = e.conv(h, cp["conv"], 1, 1)
            h = e.bn(h, cp["bn"])
            h = e.prelu(h, cp["prelu"])
        side = input_size // stride
        rows = side * side * NUM_ANCHORS
        scale = float(np.asarray(params["scales"][f"s{stride}"]))

        def pred(conv_p, cols, act):
            y = e.conv(h, conv_p, 1, 1)
            if act == "sigmoid":
                out = e.name("sig")
                e.nodes.append(W.node("Sigmoid", [y], [out]))
                y = out
            else:  # per-stride learnable scale on the distance maps
                out = e.name("mul")
                e.nodes.append(W.node("Mul", [y, scalar_init(scale)], [out]))
                y = out
            t = e.name("tr")
            e.nodes.append(W.node("Transpose", [y], [t], perm=[0, 2, 3, 1]))
            r = e.name("out")
            # 0 = copy the batch dim (ONNX Reshape semantics): the graph
            # stays valid for any batch, not just the export batch of 1
            e.nodes.append(
                W.node("Reshape", [t, shape_init([0, rows, cols])], [r])
            )
            return (r, [None, rows, cols])

        outputs.append(
            {
                "score": pred(params["head"]["cls"], 1, "sigmoid"),
                "bbox": pred(params["head"]["bbox"], 4, "scale"),
                "kps": pred(params["head"]["kps"], 10, "scale"),
            }
        )

    # canonical det_* output order: all scores by stride, then bbox, then kps
    ordered = [outputs[s][kind] for kind in ("score", "bbox", "kps")
               for s in range(len(STRIDES))]
    g = W.graph(
        e.nodes,
        e.inits,
        # batch dim unknown (empty Dimension): the Reshape heads use
        # batch-copy semantics, so the graph accepts ANY batch — the
        # fused pipeline feeds 64-frame batches through OnnxRunner
        [("input", [None, 3, input_size, input_size])],
        ordered,
    )
    return W.model(g)


def emit_vit_onnx(params, input_size: int = 112) -> bytes:
    """ViT recognizer (models/vit.py) → ONNX, opset 9.

    Opset 9 because exact-erf GELU exports as an Erf node (opset ≥ 9);
    LayerNorm is DECOMPOSED (ReduceMean/Sub/Mul/Sqrt/Div) so the graph
    loads in any ONNX Runtime ≥ 1.0 — the ONNX LayerNormalization op
    only exists from opset 17. The patch GEMM exports as the stride-8
    Conv it is equivalent to (models/vit._patchify flattens (py, px, c),
    matching Conv's (c, ky, kx) contraction after the weight transpose
    below). Batch dim rides as ONNX Reshape '0' dims.
    """
    from facerecognizeonnx_tpu_torch.models.vit import PATCH, VIT_SPECS, arch_of_dim

    pos = np.asarray(params["pos_embed"], np.float32)
    d = pos.shape[1]
    heads = VIT_SPECS[arch_of_dim(d)][2]
    dh = d // heads
    t = (input_size // PATCH) ** 2
    if t != pos.shape[0]:
        raise ValueError(
            f"input_size {input_size} gives {t} tokens; params have "
            f"pos_embed for {pos.shape[0]}"
        )
    e = _Emitter()

    def init_(tag_, arr):
        nm = e.name(tag_)
        e.inits.append(
            W.tensor(nm, np.ascontiguousarray(np.asarray(arr, np.float32)))
        )
        return nm

    def shape_init(vals):
        nm = e.name("shape")
        e.inits.append(W.tensor(nm, np.asarray(vals, np.int64), use_raw=False))
        return nm

    def n_(op, inputs, **attrs):
        out = e.name(op.lower())
        e.nodes.append(W.node(op, inputs, [out], **attrs))
        return out

    def matmul_bias(x, p, tag_):
        mm = n_("MatMul", [x, init_(tag_ + "_w", p["w"])])
        if "b" in p:
            mm = n_("Add", [mm, init_(tag_ + "_b", p["b"])])
        return mm

    def layer_norm(x, p):
        mu = n_("ReduceMean", [x], axes=[2], keepdims=1)
        sub = n_("Sub", [x, mu])
        var = n_("ReduceMean", [n_("Mul", [sub, sub])], axes=[2], keepdims=1)
        den = n_("Sqrt", [n_("Add", [var, init_("ln_eps", 1e-6)])])
        nrm = n_("Div", [sub, den])
        return n_("Add", [n_("Mul", [nrm, init_("ln_s", p["scale"])]),
                          init_("ln_b", p["bias"])])

    # patch linear as a stride-PATCH Conv: w[(py,px,c) flat, D] → OIHW
    wp = np.asarray(params["patch"]["w"], np.float32)
    wc = wp.reshape(PATCH, PATCH, 3, d).transpose(3, 2, 0, 1)
    x = n_(
        "Conv",
        ["input", init_("patch_w", wc), init_("patch_b", params["patch"]["b"])],
        strides=[PATCH, PATCH], pads=[0] * 4, kernel_shape=[PATCH, PATCH],
    )  # (B, D, g, g)
    x = n_("Reshape", [x, shape_init([0, d, t])])
    x = n_("Transpose", [x], perm=[0, 2, 1])  # (B, T, D)
    x = n_("Add", [x, init_("pos_embed", pos)])

    inv_sqrt_dh = init_("inv_sqrt_dh", dh ** -0.5)
    half, one = init_("half", 0.5), init_("one", 1.0)
    sqrt2 = init_("sqrt2", float(np.sqrt(2.0)))
    heads_shape = shape_init([0, t, heads, dh])
    merge_shape = shape_init([0, t, d])

    for blk in params["blocks"]:
        h = layer_norm(x, blk["ln1"])
        qkv = matmul_bias(h, blk["qkv"], "qkv")  # (B, T, 3D)
        qn, kn, vn = e.name("q"), e.name("k"), e.name("v")
        e.nodes.append(
            W.node("Split", [qkv], [qn, kn, vn], axis=2, split=[d, d, d])
        )

        def to_heads(nm):
            r = n_("Reshape", [nm, heads_shape])
            return n_("Transpose", [r], perm=[0, 2, 1, 3])  # (B, H, T, dh)

        qh, kh, vh = to_heads(qn), to_heads(kn), to_heads(vn)
        scores = n_("Mul", [
            n_("MatMul", [qh, n_("Transpose", [kh], perm=[0, 1, 3, 2])]),
            inv_sqrt_dh,
        ])
        attn = n_("Softmax", [scores], axis=3)
        o = n_("Transpose", [n_("MatMul", [attn, vh])], perm=[0, 2, 1, 3])
        o = n_("Reshape", [o, merge_shape])
        x = n_("Add", [x, matmul_bias(o, blk["proj"], "proj")])

        h = layer_norm(x, blk["ln2"])
        m = matmul_bias(h, blk["mlp1"], "mlp1")
        # exact-erf GELU: 0.5 * m * (1 + erf(m / sqrt(2)))
        gel = n_("Mul", [
            n_("Mul", [m, n_("Add", [n_("Erf", [n_("Div", [m, sqrt2])]), one])]),
            half,
        ])
        x = n_("Add", [x, matmul_bias(gel, blk["mlp2"], "mlp2")])

    x = layer_norm(x, params["ln_f"])
    x = n_("ReduceMean", [x], axes=[1], keepdims=0)  # (B, D)
    wf = np.asarray(params["fc"]["w"], np.float32).T  # (out, D)
    e.inits.append(W.tensor("fc_w", np.ascontiguousarray(wf)))
    e.inits.append(W.tensor("fc_b", np.asarray(params["fc"]["b"], np.float32)))
    gm = n_("Gemm", [x, "fc_w", "fc_b"], alpha=1.0, beta=1.0, transB=1)
    feat = e.bn(gm, params["features_bn"])
    g = W.graph(
        e.nodes, e.inits,
        [("input", [1, 3, input_size, input_size])],
        [(feat, [1, wf.shape[0]])],
    )
    return W.model(g, opset_version=9)
