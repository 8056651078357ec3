"""Gallery similarity top-k on the GPU: a hand-written CUDA kernel
(csrc/gallery_topk.cu) and the plain-torch paths.

Port of `facerecognizeonnx_tpu/ops/pallas_gallery.py`. The function, for
(Q, D) queries and (G, D) gallery rows (L2-normalized features): sims =
(q · g + 1) / 2 in float32, and per query the k best rows by value
descending, equal values by index ascending (`lax.top_k`'s order). It
returns ((Q, k) float32 sims, (Q, k) int32 row indices).

  gallery_topk_cuda       the kernel for CUDA tensors (counted in
                          `gallery_topk_cuda.launches`); for CPU tensors
                          its plain version, `gallery_topk_reference`
  gallery_topk_reference  materialize (Q, G), then the stable top-k;
                          storage_dtype reads both operands at that type
                          (products and sums stay float32)
  gallery_topk_tiled      exact two-stage top-k (per-tile, then of the
                          winners); k <= tile
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from facerecognizeonnx_tpu_torch.errors import InvalidInputError, KernelError
from facerecognizeonnx_tpu_torch.ops import _nvcc
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable

MAX_K = 512  # the kernel's register lists; method="tiled" has the same cap
ROWS_PER_TILE = 128  # gallery rows per step of the kernel's block loop
DIMS_PER_CHUNK = 32  # feature dims per TMA box (one 128-byte swizzle row)


def _sims(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    dots = queries.to(torch.float32) @ gallery.to(torch.float32).t()
    return (dots + 1.0) * 0.5


def gallery_topk_reference(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int,
    storage_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the (Q, G) sims in full, then the stable top-k.

    storage_dtype=torch.bfloat16 rounds both operands to it first (the
    bank at rest at half width); the products and sums stay float32."""
    if storage_dtype is not None:
        queries = queries.to(storage_dtype)
        gallery = gallery.to(storage_dtype)
    s, i = topk_stable(_sims(queries, gallery), k)
    return s, i.to(torch.int32)


def gallery_topk_tiled(
    queries: torch.Tensor, gallery: torch.Tensor, k: int, tile: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact hierarchical top-k: per-tile top-k of the sims, then the
    top-k of the winners (the true top-k lie in at most k tiles' own
    top-k sets). Requires k <= tile."""
    if k > tile:
        raise ValueError(f"gallery_topk_tiled needs k <= tile, got k={k}, tile={tile}")
    sims = _sims(queries, gallery)
    qn, n_real = sims.shape
    pad = (-n_real) % tile
    if pad:
        sims = torch.cat(
            [sims, torch.full((qn, pad), float("-inf"), device=sims.device)], dim=1
        )
    nt = sims.shape[1] // tile
    v1, i1 = topk_stable(sims.reshape(qn, nt, tile), k)
    flat_i = i1 + (torch.arange(nt, device=sims.device) * tile)[None, :, None]
    v2, sel = topk_stable(v1.reshape(qn, nt * k), k)
    idx = torch.gather(flat_i.reshape(qn, nt * k), 1, sel)
    return v2, idx.to(torch.int32)


# ---------------------------------------------------------------- the kernel


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gallery_topk_query_tile.argtypes = [i32]
    lib.gallery_topk_query_tile.restype = i32
    lib.gallery_topk_launch.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.gallery_topk_launch.restype = i32
    lib.gallery_topk_error_string.argtypes = [i32]
    lib.gallery_topk_error_string.restype = ctypes.c_char_p


def build_library() -> Tuple[ctypes.CDLL, str]:
    """Compile csrc/gallery_topk.cu with nvcc for sm_90a (once per source
    and flags) and load it. Returns (library, nvcc's -Xptxas -v output)."""
    return _nvcc.build_library("gallery_topk.cu", _bind)


def split_plan(Q: int, G: int, query_tile: int, sm_count: int) -> Tuple[int, int]:
    """(rows_per_split, splits) for the kernel's grid of query tiles x
    gallery splits: about one block per SM (a block takes most of an
    SM's shared memory), each split a multiple of the 128-row tile."""
    n_qt = -(-Q // query_tile)
    max_splits = -(-G // ROWS_PER_TILE)
    splits = min(max_splits, max(1, -(-sm_count // n_qt)))
    rows = -(-G // splits)
    rows = -(-rows // ROWS_PER_TILE) * ROWS_PER_TILE
    return rows, -(-G // rows)


def _check(queries, gallery, k):
    if queries.dim() != 2 or gallery.dim() != 2 or queries.shape[1] != gallery.shape[1]:
        raise InvalidInputError(
            f"queries (Q, D) and gallery (G, D) needed, got {tuple(queries.shape)} "
            f"and {tuple(gallery.shape)}"
        )
    if queries.device != gallery.device:
        raise InvalidInputError("queries and gallery must lie on one device")


def gallery_topk_cuda(
    queries: torch.Tensor, gallery: torch.Tensor, k: int, tile: int = 2048
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) x (G, D) → ((Q, k) sims on the (cos+1)/2 scale, (Q, k)
    int32 row indices), without materializing (Q, G).

    CUDA tensors launch csrc/gallery_topk.cu (float32 operands,
    float32-accurate 3xTF32 tensor-core products; counted in
    `gallery_topk_cuda.launches`); CPU tensors run
    `gallery_topk_reference`. k must lie in [1, min(512, G)]: the caller
    clamps it to the real rows, as `GalleryBank.search` does. `tile` is
    the TPU kernel's grid step and changes nothing here; the kernel
    splits the gallery by the card's SM count."""
    _check(queries, gallery, k)
    Q, D = queries.shape
    G = gallery.shape[0]
    if not 1 <= k <= MAX_K:
        raise KernelError(f"the gallery top-k kernel takes 1 <= k <= {MAX_K}, got k={k}")
    if k > G:
        raise KernelError(f"k={k} exceeds the gallery's {G} rows")
    if int(tile) < 1:
        raise InvalidInputError(f"tile must be >= 1, got {tile}")
    if queries.device.type == "cpu":
        return gallery_topk_reference(queries, gallery, k)
    dev = queries.device
    out_v = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_v, out_i
    lib, _ = build_library()
    q_tile = lib.gallery_topk_query_tile(k)
    # the kernel reads (rows, D) matrices in (rows, 32)-float TMA boxes: D a
    # multiple of 4 (16-byte row strides), at least 32; a gallery of fewer
    # than 128 rows is padded with zero rows (they lie past G and never win)
    d_pad = max(DIMS_PER_CHUNK, -(-D // 4) * 4)
    g = gallery.to(torch.float32)
    if d_pad != D or G < ROWS_PER_TILE:
        g = torch.nn.functional.pad(g, (0, d_pad - D, 0, max(0, ROWS_PER_TILE - G)))
    g = g.contiguous()
    q = queries.to(torch.float32)
    if d_pad != D:
        q = torch.nn.functional.pad(q, (0, d_pad - D))
    q = q.contiguous()
    q_rows = max(Q, q_tile)  # the split launch zeroes the rows past Q
    q_hi = torch.empty((q_rows, d_pad), dtype=torch.float32, device=dev)
    q_lo = torch.empty_like(q_hi)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, splits = split_plan(Q, G, q_tile, sms)
    part_v = torch.empty((Q, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, splits, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gallery_topk_launch(
            q.data_ptr(), q_hi.data_ptr(), q_lo.data_ptr(), g.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            Q, q_rows, G, d_pad, k, rows, splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise KernelError(
            f"gallery_topk launch failed: {lib.gallery_topk_error_string(rc).decode()}"
        )
    gallery_topk_cuda.launches += 1
    return out_v, out_i


gallery_topk_cuda.launches = 0
