"""Vision-Transformer face embedding network (vit_t / vit_s / vit_b) as an
nn.Module.

Port of `facerecognizeonnx_tpu/models/vit.py` (pre-LN ViT):

  patch:  (B, S, S, 3) → (S/8)² non-overlapping 8x8 patches → (T, 192)
          → linear to D, + learned positional embedding
  blocks: depth x [LN → MHA(H heads of 128) → +res,
                   LN → MLP(D→4D→D, exact-erf GELU) → +res]
  head:   LN → token mean → FC(D→512) → BN1d

The rounding points of the JAX model are kept: LayerNorm in float32
(eps 1e-6) cast back, every linear f32-accumulated and cast back to the
compute dtype, attention scores and softmax in float32 with the
probabilities cast to the compute dtype before the value product. The
residual stream stays (B*T, D). The output is not L2-normalized here.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import BatchNorm, Linear

# arch → (embed dim, depth, heads); head width dh = dim / heads = 128
VIT_SPECS = {
    "vit_t": (256, 12, 2),
    "vit_s": (384, 12, 3),
    "vit_b": (512, 12, 4),
}
PATCH = 8
LN_EPS = 1e-6


def arch_of_dim(dim: int) -> str:
    """The family member of embed width `dim` (the JAX model reads it from
    pos_embed, which quantization never strips)."""
    for arch, (d, _, _) in VIT_SPECS.items():
        if d == dim:
            return arch
    raise ValueError(f"unrecognized ViT width {dim}")


def patchify(x: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) → (B, T, PATCH*PATCH*3), patches row-major, each
    patch's values (py, px, c)-ordered: the stride-8 patch conv as the
    reshape the JAX model writes."""
    b, s = x.shape[0], x.shape[1]
    g = s // PATCH
    x = x.reshape(b, g, PATCH, g, PATCH, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * g, PATCH * PATCH * 3)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim in float32, cast back to the input dtype."""

    def __init__(self, scale, bias):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + LN_EPS) * self.scale + self.bias
        return y.to(x.dtype)


class Block(nn.Module):
    def __init__(self, ln1: LayerNorm, qkv: Linear, proj: Linear, ln2: LayerNorm,
                 mlp1: Linear, mlp2: Linear, heads: int):
        super().__init__()
        self.ln1, self.qkv, self.proj = ln1, qkv, proj
        self.ln2, self.mlp1, self.mlp2 = ln2, mlp1, mlp2
        self.heads = heads

    def attention(self, x2: torch.Tensor, b: int, t: int, dt: torch.dtype):
        d = x2.shape[-1]
        dh = d // self.heads
        qkv = self.qkv(x2, dt).to(dt)

        def split(i):  # (B*T, D) column block → (B, H, T, dh)
            return qkv[:, i * d:(i + 1) * d].reshape(b, t, self.heads, dh).transpose(1, 2)

        q, k, v = split(0), split(1), split(2)
        scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) * (dh ** -0.5)
        attn = torch.softmax(scores, dim=-1).to(dt)
        out = (attn.to(torch.float32) @ v.to(torch.float32)).to(dt)
        return self.proj(out.transpose(1, 2).reshape(b * t, d), dt).to(dt)

    def forward(self, h, b, t, dt):
        h = h + self.attention(self.ln1(h), b, t, dt)
        m = self.mlp1(self.ln2(h), dt)
        m = F.gelu(m.to(dt), approximate="none")
        return h + self.mlp2(m, dt).to(dt)


class ViT(nn.Module):
    def __init__(
        self,
        patch: Linear,
        pos_embed: torch.Tensor,
        blocks: List[Block],
        ln_f: LayerNorm,
        fc: Linear,
        features_bn: Optional[BatchNorm] = None,
    ):
        super().__init__()
        self.patch = patch
        self.pos_embed = nn.Parameter(pos_embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.ln_f, self.fc, self.features_bn = ln_f, fc, features_bn

    def forward(
        self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """(B, S, S, 3) normalized RGB NHWC, S a multiple of 8 → (B, 512)
        float32."""
        dt = compute_dtype
        tokens = patchify(x.to(dt))
        b, t, pdim = tokens.shape
        h = self.patch(tokens.reshape(b * t, pdim), dt).to(dt)
        h = (h.reshape(b, t, -1) + self.pos_embed.to(dt)).reshape(b * t, -1)
        for blk in self.blocks:
            h = blk(h, b, t, dt)
        h = self.ln_f(h).reshape(b, t, -1).mean(dim=1)
        out = self.fc(h, dt)
        if self.features_bn is not None:
            out = self.features_bn(out)
        return out.to(torch.float32)

    @staticmethod
    def bn_path(name: str) -> str:
        """A BatchNorm's module name → its JAX param path (the head BN1d,
        "features_bn", is the only one)."""
        return name


def fold_inference_params(model: ViT) -> ViT:
    """A copy of `model` with the head BN1d folded into the FC (the
    LayerNorms cannot fold: their statistics depend on the data)."""
    out = copy.deepcopy(model)
    if out.features_bn is not None:
        out.fc = out.fc.folded(out.features_bn)
        out.features_bn = None
    return out
