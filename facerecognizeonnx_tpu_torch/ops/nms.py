"""Fixed-shape greedy NMS over batched candidate sets.

Port of `facerecognizeonnx_tpu/ops/nms.py`, with the batch dimension
written out: candidates sorted by descending score (or taken as sorted),
and the greedy survivor mask, keep[i] = valid[i] and no kept
higher-scoring box overlaps i by IoU > threshold.

The mask comes from `nms_greedy`, a `torch.library` custom op
(`frt::nms_greedy`), so `torch.export` traces it as one node and an
exported program runs on either device:

  - CUDA tensors launch csrc/nms_greedy.cu (one block per frame, no host
    read, so a step that holds it can be captured in a CUDA graph),
    counted in `nms_greedy.launches`;
  - CPU tensors run the plain version `nms_greedy_reference`: the
    reference's fixpoint (its `lax.while_loop`), iterated until no frame's
    mask changes, with the host read once per `ITERS_PER_CHECK`
    iterations. Iterating past the fixpoint changes nothing, so the result
    is exact. `nms_fixed.iterations` counts its calls by the iterations
    the reference's loop would run (the changing ones plus the one that
    confirms the fixpoint).

`int_rects=True` computes IoU on integer-truncated rects, as a C int
cast does: x=trunc(x1), y=trunc(y1), w=trunc(x2-x1), h=trunc(y2-y1).
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch

from facerecognizeonnx_tpu_torch.errors import InvalidInputError, KernelError
from facerecognizeonnx_tpu_torch.ops import _nvcc

# fixpoint iterations of the plain version between two host reads; the
# reference puts real face layouts at 2-4, so a call reads the host once
ITERS_PER_CHECK = 4
# candidates per frame the kernel takes (one 32-bit word of its mask rows
# per lane of the scanning warp); the default pre_nms_topk is 512
MAX_K = 1024
_iterations_lock = threading.Lock()


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) x1,y1,x2,y2 boxes
    → (..., N, M)."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = torch.clamp_min(ix2 - ix1, 0.0) * torch.clamp_min(iy2 - iy1, 0.0)
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def _int_rects(boxes: torch.Tensor) -> torch.Tensor:
    """Integer-truncated rects: (int)x1, (int)y1, (int)(x2-x1), (int)(y2-y1)."""
    x1 = torch.trunc(boxes[..., 0])
    y1 = torch.trunc(boxes[..., 1])
    w = torch.trunc(boxes[..., 2] - boxes[..., 0])
    h = torch.trunc(boxes[..., 3] - boxes[..., 1])
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) indexed along dim 1 by idx (B, K')."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# ---------------------------------------------------------------- plain version


def nms_greedy_reference(
    boxes_s: torch.Tensor,
    valid_s: torch.Tensor,
    iou_threshold: float,
    int_rects: bool = False,
) -> torch.Tensor:
    """Plain version of `nms_greedy`, on any device: the reference's
    fixpoint over score-sorted boxes (B, K, 4) and valid (B, K) bool →
    keep (B, K) bool. Reads the host once per ITERS_PER_CHECK iterations
    and counts the call in `nms_fixed.iterations`."""
    iou_boxes = _int_rects(boxes_s) if int_rects else boxes_s
    iou = iou_matrix(iou_boxes, iou_boxes)
    # suppressor[b, j, i]: j ranks strictly above i and overlaps it
    suppressor = torch.triu(iou > iou_threshold, diagonal=1)

    keep, n_changed = valid_s, 0
    while True:
        changed = []
        for _ in range(ITERS_PER_CHECK):
            new_keep = valid_s & ~(suppressor & keep[:, :, None]).any(dim=1)
            changed.append((new_keep != keep).any())
            keep = new_keep
        # the changing iterations come first; once one changes nothing,
        # none after it does
        batch_changed = int(torch.stack(changed).sum())
        n_changed += batch_changed
        if batch_changed < ITERS_PER_CHECK:
            break
    with _iterations_lock:
        nms_fixed.iterations[n_changed + 1] += 1
    return keep


# ---------------------------------------------------------------- the kernel


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nms_greedy_launch.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, ptr]
    lib.nms_greedy_launch.restype = i32
    lib.nms_greedy_launch_count.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.nms_greedy_launch_count.restype = i32
    lib.nms_greedy_error_string.argtypes = [i32]
    lib.nms_greedy_error_string.restype = ctypes.c_char_p


def build_library() -> Tuple[ctypes.CDLL, str]:
    """Compile csrc/nms_greedy.cu with nvcc for sm_90a (once per source and
    flags) and load it. Returns (library, nvcc's -Xptxas -v output)."""
    return _nvcc.build_library("nms_greedy.cu", _bind)


def device_launches() -> int:
    """The kernel's launches on the current device so far, as the kernel
    counts them (CUDA-graph replays included); waits for the device."""
    lib, _ = build_library()
    out = ctypes.c_ulonglong(0)
    rc = lib.nms_greedy_launch_count(ctypes.byref(out))
    if rc != 0:
        raise KernelError(f"nms_greedy count read failed: {lib.nms_greedy_error_string(rc).decode()}")
    return int(out.value)


def _check(boxes_s: torch.Tensor, valid_s: torch.Tensor) -> None:
    if boxes_s.dim() != 3 or boxes_s.shape[-1] != 4:
        raise InvalidInputError(f"boxes must be (B, K, 4), got {tuple(boxes_s.shape)}")
    if tuple(valid_s.shape) != tuple(boxes_s.shape[:2]) or valid_s.dtype != torch.bool:
        raise InvalidInputError(
            f"valid must be bool {tuple(boxes_s.shape[:2])}, got {valid_s.dtype} "
            f"{tuple(valid_s.shape)}"
        )
    if valid_s.device != boxes_s.device:
        raise InvalidInputError("boxes and valid must lie on one device")


def _launch(boxes_s, valid_s, iou_threshold, int_rects):
    """csrc/nms_greedy.cu on CUDA tensors; counted in `nms_greedy.launches`."""
    _check(boxes_s, valid_s)
    B, K = valid_s.shape
    if boxes_s.dtype != torch.float32:
        raise InvalidInputError(f"the NMS kernel takes float32 boxes, got {boxes_s.dtype}")
    if K > MAX_K:
        raise InvalidInputError(f"the NMS kernel takes at most {MAX_K} candidates, got {K}")
    dev = boxes_s.device
    boxes_s, valid_s = boxes_s.contiguous(), valid_s.contiguous()
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return keep
    lib, _ = build_library()
    with torch.cuda.device(dev):
        rc = lib.nms_greedy_launch(
            boxes_s.data_ptr(), valid_s.data_ptr(), keep.data_ptr(), B, K,
            float(iou_threshold), int(bool(int_rects)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"nms_greedy launch failed: {lib.nms_greedy_error_string(rc).decode()}")
    nms_greedy.launches += 1
    return keep


def _plain(boxes_s, valid_s, iou_threshold, int_rects):
    _check(boxes_s, valid_s)
    return nms_greedy_reference(boxes_s, valid_s, iou_threshold, int_rects)


def _fake(boxes_s, valid_s, iou_threshold, int_rects):
    return torch.empty(tuple(valid_s.shape), dtype=torch.bool, device=valid_s.device)


_op = torch.library.custom_op(
    "frt::nms_greedy", _plain, mutates_args=(), device_types="cpu",
    schema="(Tensor boxes_s, Tensor valid_s, float iou_threshold, bool int_rects) -> Tensor",
)
_op.register_kernel("cuda")(_launch)
_op.register_fake(_fake)


def nms_greedy(
    boxes_s: torch.Tensor,
    valid_s: torch.Tensor,
    iou_threshold: float,
    int_rects: bool = False,
) -> torch.Tensor:
    """The greedy survivor mask of score-sorted candidates: boxes (B, K, 4)
    x1,y1,x2,y2 and valid (B, K) bool, in descending score order → keep
    (B, K) bool.

    CUDA tensors launch csrc/nms_greedy.cu (float32 boxes, K ≤ MAX_K;
    counted) or raise; CPU tensors run `nms_greedy_reference`."""
    return torch.ops.frt.nms_greedy(boxes_s, valid_s, float(iou_threshold), bool(int_rects))


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    assume_sorted: bool = False,
    int_rects: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over fixed-size candidate sets.

    boxes: (B, K, 4); scores: (B, K); valid: optional (B, K) bool.
    assume_sorted=True skips the re-sort when
    the caller provides descending-score order. Returns (boxes, scores,
    keep, order): boxes/scores sorted by descending score (invalid
    scores are -inf), keep the survivor mask in that order, order the
    original indices.
    """
    B, K = scores.shape
    if valid is None:
        valid = torch.ones((B, K), dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    if assume_sorted:
        order = torch.arange(K, device=scores.device).expand(B, K)
        boxes_s, scores_s, valid_s = boxes, masked, valid
    else:
        order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
        boxes_s = gather_rows(boxes, order)
        scores_s = gather_rows(masked, order)
        valid_s = gather_rows(valid, order)
    keep = nms_greedy(boxes_s, valid_s, iou_threshold, int_rects)
    return boxes_s, scores_s, keep, order


nms_fixed.iterations = collections.Counter()
nms_greedy.launches = 0
