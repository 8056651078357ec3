"""Tensor-parallel (channel-sharded) recognizer inference.

Port of `facerecognizeonnx_tpu/parallel/tensor_parallel.py` on
`torch.distributed`: Megatron-style channel sharding of the recognizer
over a mesh "model" axis, each rank holding only its slice.

  * IResNet block conv1 is COLUMN-parallel (output channels shard, with
    the per-channel BN and PReLU after it); conv2 is ROW-parallel (input
    channels shard): each rank's partial sum goes through ONE
    `all_reduce(SUM)` per block, and the bias is added after the sum so
    it counts once. The stem, the residual / downsample path and the
    pre-conv BNs stay replicated.
  * ViT blocks: q, k, v (split from the fused qkv by `pack_tp_params`, so
    a contiguous column shard is a contiguous group of HEADS) and mlp1
    are column-parallel; proj and mlp2 row-parallel, each followed by
    one sum: two per block, the residual stream replicated.
  * The head FC is column-parallel, its features joined by an
    all-gather.

Param trees are the JAX layout (`bridge.tree_from_module` of a port
module, or the JAX package's numpy tree), so the specs are the JAX
specs: `recognizer_param_specs` gives a tree of the same structure whose
leaves are `Replicate()` or `Shard(dim)` placements of
`torch.distributed.tensor`, `dim` counted in the tree's layout. A rank
slices each sharded leaf and builds its own module from the slices
(`local_module`), so it never holds a whole sharded weight.

Composes with data parallelism on a ("data", "model") mesh: crops
split over "data", each data replica runs the sharded forward over its
"model" line. Inference only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.models.layers import conv2d, l2_normalize, linear
from facerecognizeonnx_tpu_torch.ops.image import normalize_to_rgb
from facerecognizeonnx_tpu_torch.parallel.mesh import (
    all_gather_into_tensor,
    axis_size,
    block,
    gather_rows,
    has_axis,
    in_mesh,
    make_mesh,
    mesh_device,
    pad_rows,
    share_with_outsiders,
)
from facerecognizeonnx_tpu_torch.parallel.sharded_ops import as_tensor

_REP = Replicate()


def _conv_spec(p, w_spec, b_spec):
    out = {"w": w_spec}
    if "b" in p:
        out["b"] = b_spec
    return out


def _bn_spec(spec):
    return {"scale": spec, "bias": spec, "mean": spec, "var": spec}


def _as_tree(params) -> Dict:
    if isinstance(params, dict):
        return params
    from facerecognizeonnx_tpu_torch.bridge import tree_from_module

    return tree_from_module(params)


def pack_tp_params(params: Dict) -> Dict:
    """Repack a param tree for tensor-parallel sharding.

    ViT: split each block's fused qkv into wq / wk / wv so a contiguous
    column shard of each is a contiguous group of heads (the fused
    [q|k|v] order would hand rank 0 "all of q and half of k"). Other
    trees pass through unchanged."""
    if "pos_embed" not in params:
        return params
    out = {k: v for k, v in params.items() if k != "blocks"}
    blocks = []
    for blk in params["blocks"]:
        d = np.shape(blk["qkv"]["w"])[0]
        nb = {k: v for k, v in blk.items() if k != "qkv"}
        w, b = blk["qkv"]["w"], blk["qkv"]["b"]
        nb["wq"] = {"w": w[:, :d], "b": b[:d]}
        nb["wk"] = {"w": w[:, d:2 * d], "b": b[d:2 * d]}
        nb["wv"] = {"w": w[:, 2 * d:], "b": b[2 * d:]}
        blocks.append(nb)
    out["blocks"] = blocks
    return out


def validate_tp_width(params: Dict, n_shards: int, axis: str = "model"):
    """Fail before any work when the arch cannot shard `n_shards` ways: a
    ViT whose head count does not divide the model axis."""
    if "pos_embed" in params:
        from facerecognizeonnx_tpu_torch.models.vit import VIT_SPECS, arch_of_dim

        heads = VIT_SPECS[arch_of_dim(np.shape(params["pos_embed"])[1])][2]
        if heads % n_shards:
            raise ValueError(
                f"vit tensor parallelism shards heads: {heads} heads do "
                f"not divide over {n_shards} '{axis}' shards"
            )


def recognizer_param_specs(params: Dict, axis: str = "model") -> Dict:
    """Placement tree (same structure as `params`) for tensor-parallel
    inference over `axis`: IResNet Megatron conv sharding, ViT (a
    `pack_tp_params` tree) textbook Megatron. Works on folded and
    unfolded trees; raises on MobileFaceNet (its depthwise body has no
    free channel axis worth sharding at 112 px; shard it over "data")."""
    if "pos_embed" in params:
        return _vit_param_specs(params, axis)
    if "layer1" not in params:
        raise ValueError(
            "tensor-parallel embed supports IResNet and ViT param trees "
            "only (MobileFaceNet shards over 'data' instead)"
        )
    col_w = Shard(3)  # HWIO: shard O
    row_w = Shard(2)  # HWIO: shard I
    vec = Shard(0)

    specs: Dict = {
        "conv1": _conv_spec(params["conv1"], _REP, _REP),
        "prelu1": {"alpha": _REP},
    }
    if "bn1" in params:
        specs["bn1"] = _bn_spec(_REP)
    for s in (1, 2, 3, 4):
        stage = []
        for blk in params[f"layer{s}"]:
            nb = {
                "bn1": _bn_spec(_REP),
                "conv1": _conv_spec(blk["conv1"], col_w, vec),
                "prelu": {"alpha": vec},
                "conv2": _conv_spec(blk["conv2"], row_w, _REP),
            }
            if "bn2" in blk:
                nb["bn2"] = _bn_spec(vec)
            if "bn3" in blk:
                nb["bn3"] = _bn_spec(_REP)
            if "down_conv" in blk:
                nb["down_conv"] = _conv_spec(blk["down_conv"], _REP, _REP)
            if "down_bn" in blk:
                nb["down_bn"] = _bn_spec(_REP)
            stage.append(nb)
        specs[f"layer{s}"] = stage
    specs["bn2"] = _bn_spec(_REP)
    specs["fc"] = {"w": Shard(1)}
    if "b" in params["fc"]:
        specs["fc"]["b"] = vec
    if "features_bn" in params:
        specs["features_bn"] = _bn_spec(_REP)
    return specs


def _vit_param_specs(params: Dict, axis: str = "model") -> Dict:
    if "blocks" in params and params["blocks"] and "qkv" in params["blocks"][0]:
        raise ValueError(
            "vit param tree still has fused qkv blocks — call "
            "pack_tp_params(params) before recognizer_param_specs"
        )
    col = {"w": Shard(1), "b": Shard(0)}
    row_w = Shard(0)
    ln = {"scale": _REP, "bias": _REP}
    specs: Dict = {
        "patch": {"w": _REP, "b": _REP},
        "pos_embed": _REP,
        "ln_f": ln,
        "fc": {"w": Shard(1)},
    }
    if "b" in params["fc"]:
        specs["fc"]["b"] = Shard(0)
    if "features_bn" in params:
        specs["features_bn"] = _bn_spec(_REP)
    specs["blocks"] = [
        {
            "ln1": ln,
            "wq": dict(col),
            "wk": dict(col),
            "wv": dict(col),
            "proj": {"w": row_w, "b": _REP},
            "ln2": ln,
            "mlp1": dict(col),
            "mlp2": {"w": row_w, "b": _REP},
        }
        for _ in params["blocks"]
    ]
    return specs


def _slice(tree, specs, idx: int, n: int):
    """This shard's leaves: a `Shard(d)` leaf split n ways along d."""
    if isinstance(tree, dict):
        return {k: _slice(tree[k], specs[k], idx, n) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_slice(t, s, idx, n) for t, s in zip(tree, specs)]
    if isinstance(specs, Shard):
        return np.split(np.asarray(tree), n, axis=specs.dim)[idx]
    return tree


def local_module(params: Dict, idx: int, n: int, axis: str = "model", device="cpu"):
    """Shard `idx` of `n` of a packed tree as a module of the port holding
    only its slices (a ViT's q / k / v slices join into its qkv)."""
    from facerecognizeonnx_tpu_torch.bridge import params_from_numpy

    local = _slice(params, recognizer_param_specs(params, axis), idx, n)
    if "pos_embed" in local:
        for blk in local["blocks"]:
            parts = [blk.pop(k) for k in ("wq", "wk", "wv")]
            blk["qkv"] = {
                "w": np.concatenate([p["w"] for p in parts], axis=1),
                "b": np.concatenate([p["b"] for p in parts]),
            }
    return params_from_numpy(local, device=device)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather_features(out: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, dout/n) per rank → (B, dout) in rank order."""
    out = out.t().contiguous()
    full = out.new_empty((n * out.shape[0], out.shape[1]))
    all_gather_into_tensor(full, out, group)
    return full.t().contiguous()


def _tp_block(blk, x, dt, group):
    """One IBasicBlock: column conv1 → row conv2 → sum, then the bias."""
    out = blk.unit1(blk.bn1(x), dt)
    u2 = blk.unit2
    out = _sum(conv2d(out, u2.conv.weight, None, u2.conv.stride, u2.conv.padding,
                      compute_dtype=dt), group)
    if u2.conv.bias is not None:
        out = (out.to(torch.float32) + u2.conv.bias.to(torch.float32)[:, None, None]).to(dt)
    if u2.bn is not None:
        out = u2.bn(out)
    identity = x if blk.down is None else blk.down(x, dt)
    return out + identity


def _tp_iresnet(m, x, dt, group):
    out = m.stem(x.to(dt).permute(0, 3, 1, 2), dt)
    for stage in m.stages:
        for blk in stage:
            out = _tp_block(blk, out, dt, group)
    out = m.bn2(out)
    out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
    return m.fc(out, dt), m.features_bn  # local dout/n columns


def _tp_vit(m, x, dt, group):
    from facerecognizeonnx_tpu_torch.models.vit import VIT_SPECS, arch_of_dim, patchify

    dim, _, heads = VIT_SPECS[arch_of_dim(m.pos_embed.shape[1])]
    dh = dim // heads  # from the arch spec, never assumed
    tokens = patchify(x.to(dt))
    b, t, pdim = tokens.shape
    h = m.patch(tokens.reshape(b * t, pdim), dt).to(dt)
    h = (h.reshape(b, t, -1) + m.pos_embed.to(dt)).reshape(b * t, -1)
    for blk in m.blocks:
        qkv = blk.qkv(blk.ln1(h), dt).to(dt)
        dloc = qkv.shape[-1] // 3
        hl = dloc // dh  # local heads

        def split(i):
            return qkv[:, i * dloc:(i + 1) * dloc].reshape(b, t, hl, dh).transpose(1, 2)

        q, k, v = split(0), split(1), split(2)
        scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) * (dh ** -0.5)
        attn = torch.softmax(scores, dim=-1).to(dt)
        out = (attn.to(torch.float32) @ v.to(torch.float32)).to(dt)
        out = _sum(linear(out.transpose(1, 2).reshape(b * t, dloc), blk.proj.weight, None, dt),
                   group)
        h = h + (out + blk.proj.bias).to(dt)
        mm = F.gelu(blk.mlp1(blk.ln2(h), dt).to(dt), approximate="none")
        mm = _sum(linear(mm, blk.mlp2.weight, None, dt), group)
        h = h + (mm + blk.mlp2.bias).to(dt)
    h = m.ln_f(h).reshape(b, t, -1).mean(dim=1)
    return m.fc(h, dt), m.features_bn


def tp_apply(local, x: torch.Tensor, group, n: int,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Channel-sharded recognizer forward on `local` (this rank's
    `local_module`) over the `n`-rank `group`. x: (B, S, S, 3) normalized
    RGB, the same on every rank of the group. Returns (B, 512) float32,
    the same on every rank: the model's forward up to the order of the
    summation over ranks."""
    fwd = _tp_vit if hasattr(local, "pos_embed") else _tp_iresnet
    out, features_bn = fwd(local, x, compute_dtype, group)
    out = _gather_features(out, group, n)
    if features_bn is not None:
        out = features_bn(out)
    return out.to(torch.float32)


def tp_embed_crops(
    params,
    crops_bgr,
    cfg: PipelineConfig,
    mesh=None,
    axis: str = "model",
    data_axis: str = "data",
    normalized: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Tensor-parallel `embed_crops`: (N, S, S, 3) crops → (N, 512)
    L2-normalized features, the recognizer (a module of the port or a
    JAX-layout tree) channel-sharded over `mesh[axis]`. With `data_axis`
    also in the mesh (size > 1) the crops split over it too (dp × tp); N
    is padded to the data shard count and stripped on return."""
    if mesh is None:
        mesh = make_mesh((axis,), device=device)
    params = pack_tp_params(_as_tree(params))
    n = axis_size(mesh, axis)
    validate_tp_width(params, n, axis)
    recognizer_param_specs(params, axis)  # raises on trees it cannot shard
    if not in_mesh(mesh):
        return share_with_outsiders(mesh, None)[0]
    dev = mesh_device(mesh)
    local = local_module(params, mesh.get_local_rank(axis), n, axis, device=dev)
    n_real = crops_bgr.shape[0]
    x = as_tensor(block(pad_rows(crops_bgr, axis_size(mesh, data_axis)), mesh, data_axis), dev)
    dt = cfg.torch_compute_dtype
    with torch.no_grad():
        xin = x.to(dt) if normalized else normalize_to_rgb(
            x, cfg.pixel_mean, cfg.pixel_scale, dtype=dt)
        feats = l2_normalize(tp_apply(local, xin, mesh.get_group(axis), n, dt))
    feats = gather_rows(feats, mesh, data_axis) if has_axis(mesh, data_axis) else feats
    return share_with_outsiders(mesh, [feats[:n_real]])[0]
