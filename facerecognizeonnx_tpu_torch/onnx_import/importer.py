"""User-facing ONNX loaders.

Port of `facerecognizeonnx_tpu/onnx_import/importer.py`. `OnnxRunner`
wraps a parsed graph as an nn.Module with the port's model contract,
`forward(x_nhwc, compute_dtype)`, so FaceDetector / FaceRecognizer and
`frames_to_matches` run real buffalo_sc .onnx files unchanged:

  kind="scrfd":   {stride: (scores, bbox, kps)}, each (B, rows, C), with
                  post-sigmoid scores and stride-unit distances (the
                  contract of models/scrfd.py)
  kind="arcface": (B, 512) float32 features

SCRFD outputs are classified by shape, not name: per stride s there are
rows = A·(S/s)² anchors per frame with 1/4/10 columns. A 2-D output
(B·rows, C) is batch-folded — a torch export's Transpose(0, 2, 3, 1) then
Reshape(−1, C), batch-major — and is unfolded with the input's batch B
before its rows are counted. (The JAX runner reads a 2-D output as batch
1, so at B > 1 it raises, or at B = 4 — 4·side² being a square — decodes
every head on the wrong anchor grid.)
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facerecognizeonnx_tpu_torch.onnx_import import proto
from facerecognizeonnx_tpu_torch.onnx_import.executor import Executor


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


class OnnxRunner(nn.Module):
    def __init__(self, path, kind: Optional[str] = None, fast: bool = True,
                 device="cuda"):
        """`path`: an .onnx file or a parsed `proto.Graph`. fast=True runs
        the executor's fast mode (the JAX fast path's rounding at the
        compute dtype); fast=False the reference NCHW interpretation in
        float32. The weights go to `device` on the first call."""
        super().__init__()
        self.path = path if isinstance(path, str) else None
        self.graph = proto.load_model(path) if isinstance(path, str) else path
        self.executor = Executor(self.graph, nhwc=fast, device=device)
        self.fast = fast
        if not self.executor.input_names:
            raise ValueError(f"{path}: graph has no runtime inputs")
        self.input_name = self.executor.input_names[0]
        in_shape = dict(self.graph.inputs).get(self.input_name)
        self.input_size = None
        if in_shape and len(in_shape) == 4 and in_shape[2] and in_shape[2] > 0:
            self.input_size = int(in_shape[2])
        if kind is None:
            # 112 → recognizer; anything else (dynamic included) → detector
            kind = "arcface" if self.input_size == 112 else "scrfd"
        self.kind = kind

    @property
    def device(self) -> torch.device:
        return self.executor.device

    def forward(self, x_nhwc: torch.Tensor, compute_dtype=torch.float32):
        """(B, S, S, 3) normalized RGB → the kind's outputs (module docstring)."""
        x = x_nhwc.to(torch.float32)
        if self.fast:
            # NHWC straight in; convs at compute_dtype with float32 sums
            self.executor.compute_dtype = (
                None if compute_dtype in (torch.float32, None) else compute_dtype
            )
            outs = self.executor.run({self.input_name: x}, nhwc_inputs=True)
        else:
            outs = self.executor.run({self.input_name: x.permute(0, 3, 1, 2)})
        if self.kind == "arcface":
            feats = _tensor(outs[0], x.device)
            return feats.reshape(feats.shape[0], -1).to(torch.float32)
        return self.classify_scrfd(outs, int(x_nhwc.shape[1]), int(x_nhwc.shape[0]))

    def classify_scrfd(
        self, outs, input_size: int, batch: int, num_anchors: int = 2
    ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """The graph's outputs → {stride: (scores, bbox, kps)}, (B, rows, C)
        each; ValueError where an output's rows per frame are not
        A·(S/s)² for a stride s dividing S."""
        by_stride: Dict[int, dict] = {}
        for o in outs:
            o = _tensor(o, self.device)
            if o.dim() == 2:  # (B·rows, C), batch-major
                if o.shape[0] % batch:
                    raise ValueError(
                        f"cannot classify SCRFD output rows={o.shape[0]} at batch {batch}"
                    )
                o = o.reshape(batch, o.shape[0] // batch, o.shape[1])
            rows, cols = int(o.shape[1]), int(o.shape[2])
            hw = rows // num_anchors
            side = math.isqrt(hw)
            if rows % num_anchors or side * side != hw or input_size % side:
                raise ValueError(f"cannot classify SCRFD output rows={rows}")
            by_stride.setdefault(input_size // side, {})[cols] = o
        result = {}
        for stride, tensors in by_stride.items():
            if set(tensors) != {1, 4, 10}:
                raise ValueError(
                    f"stride {stride}: expected score/bbox/kps outputs, "
                    f"got columns {sorted(tensors)}"
                )
            result[stride] = (tensors[1], tensors[4], tensors[10])
        return result


def load_onnx_params(path, kind: Optional[str] = None, device="cuda") -> OnnxRunner:
    """The API's .onnx hook: a path (or parsed Graph) → pipeline-compatible
    runner."""
    return OnnxRunner(path, kind=kind, device=device)
