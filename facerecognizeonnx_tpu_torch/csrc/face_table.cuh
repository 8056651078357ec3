// The part of the per-face table that both warp layouts share: the inverse
// affine, the pyramid level chosen from its source extent, the inverse at
// that level and the minimum corner of its source window. Included by
// csrc/warp_xm.cu and csrc/warp_ym.cu; ops/_nvcc.py hashes every csrc/*.cuh
// with each source, so an edit here rebuilds both.
//
// The float32 operations of ops/warp.py::invert_affine and
// ops/warp_cuda.py::_scaled_inverse, in the same order, as torch runs them
// on CUDA: _rn intrinsics (no FMA contraction), log2f / exp2f / ceilf without
// fast math, and NaN kept where torch.maximum / minimum / clamp keep it.

#pragma once

#include <float.h>

namespace face_table {

constexpr float OUT_M1 = 111.0f;  // output side - 1
constexpr float COVER = 110.0f;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
// torch.maximum / torch.minimum / torch.clamp propagate NaN
__device__ __forceinline__ float nan_max(float x, float y) {
  return (isnan(x) || isnan(y)) ? qnan() : fmaxf(x, y);
}
__device__ __forceinline__ float nan_min(float x, float y) {
  return (isnan(x) || isnan(y)) ? qnan() : fminf(x, y);
}
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// a float table entry as the kernels use it: NaN reads 0, then clipped
__device__ __forceinline__ int to_int(float v, int lo, int hi) {
  return min(max(isnan(v) ? 0 : static_cast<int>(v), lo), hi);
}

struct Scaled {
  float level;            // 0..3 (NaN for a NaN inverse)
  float a, b, c, d;       // the inverse at the level
  float tx, ty;           // its translation at the level
  float x_min, y_min;     // the source window's minimum corner, clipped to ±1e7
};

// M: the forward (2, 3) affine, row-major
__device__ __forceinline__ Scaled scaled_inverse(const float* M) {
  const float a = M[0], b = M[1], tx = M[2], c = M[3], d = M[4], ty = M[5];
  float det = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  const float inv = __fdiv_rn(1.0f, det);
  const float ia = __fmul_rn(d, inv), ib = __fmul_rn(-b, inv);
  const float ic = __fmul_rn(-c, inv), id = __fmul_rn(a, inv);
  const float itx = -__fadd_rn(__fmul_rn(ia, tx), __fmul_rn(ib, ty));
  const float ity = -__fadd_rn(__fmul_rn(ic, tx), __fmul_rn(id, ty));

  const float span_x = __fadd_rn(__fmul_rn(OUT_M1, __fadd_rn(fabsf(ia), fabsf(ib))), 2.0f);
  const float span_y = __fadd_rn(__fmul_rn(OUT_M1, __fadd_rn(fabsf(ic), fabsf(id))), 2.0f);
  const float extent = nan_max(span_x, span_y);
  float ratio = __fmul_rn(extent, 1.0f / COVER);
  ratio = isnan(ratio) ? ratio : fmaxf(ratio, 1e-6f);
  Scaled s;
  s.level = nan_clamp(ceilf(log2f(ratio)), 0.0f, 3.0f);
  const float factor = exp2f(s.level);
  s.a = __fdiv_rn(ia, factor);
  s.b = __fdiv_rn(ib, factor);
  s.c = __fdiv_rn(ic, factor);
  s.d = __fdiv_rn(id, factor);
  s.tx = __fsub_rn(__fdiv_rn(__fadd_rn(itx, 0.5f), factor), 0.5f);
  s.ty = __fsub_rn(__fdiv_rn(__fadd_rn(ity, 0.5f), factor), 0.5f);
  s.x_min = nan_clamp(
      __fadd_rn(__fadd_rn(nan_min(__fmul_rn(s.a, OUT_M1), 0.0f),
                          nan_min(__fmul_rn(s.b, OUT_M1), 0.0f)), s.tx), -1e7f, 1e7f);
  s.y_min = nan_clamp(
      __fadd_rn(__fadd_rn(nan_min(__fmul_rn(s.c, OUT_M1), 0.0f),
                          nan_min(__fmul_rn(s.d, OUT_M1), 0.0f)), s.ty), -1e7f, 1e7f);
  return s;
}

// floor(v / align) * align clipped to [0, hi], as torch computes it (the
// quotient by a power of two is exact, as a product or a division)
__device__ __forceinline__ float origin(float v, float align, float hi) {
  return nan_clamp(__fmul_rn(floorf(__fmul_rn(v, 1.0f / align)), align), 0.0f, hi);
}

}  // namespace face_table
