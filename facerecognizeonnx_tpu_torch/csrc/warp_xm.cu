// Face-alignment warp for Hopper (sm_90a): per-face bilinear resample of a
// mip pyramid to 112x112x3 crops, with a fused normalize epilogue and a
// skip for empty face slots.
//
// Replaces the TPU kernel facerecognizeonnx_tpu/ops/warp_pallas.py::_kernel_xm
// (x-major layout, launched by _warp_affine_pallas_xm). The plain-torch version of
// the same function is ops/warp_cuda.py::warp_affine_xm_reference.
//
// What bounds it on this card: bytes and latency, not arithmetic. Each of the
// N x 112^2 x 3 outputs reads at most 2x2 taps of a uint8 window (<= 96 KB per
// face, L2-resident) and writes 4 (f32) or 2 (bf16) bytes; there are a few
// dozen flops per output pixel.
//
// What the design does about it:
//   - a direct 4-tap gather per pixel instead of the TPU's dense hat-weight
//     matmul (3*128 x 256 @ 256 x 1792 per chunk): the hat weights have at
//     most two non-zeros per axis, so the gather computes the same sums with
//     ~100x fewer operations;
//   - a uint8 pyramid (every level is stored rounded, so uint8 is exact): half
//     the bytes of the TPU's bf16 canvas, and levels stored at their own size
//     with no zero canvas — a read past a level's edge is a zero, as on the
//     canvas;
//   - one thread per output pixel computing all 3 channels; blocks tile the
//     pixels of one face (grid.y = face), so per-face parameters are read
//     once per block and the launch fills the card at a few dozen faces.
//   Windows are read straight from global memory; staging them in shared
//   memory (cp.async / TMA) is left for a later change.
//
// Numerics follow the TPU kernel exactly: window-local coordinates
// lx = a*j + b*i + tx, ly = c*j + d*i + ty (no FMA contraction: the _rn
// intrinsics), clipped to [-2, 129] x [-2, 257]; y hat weights rounded to bf16,
// x hat weights in f32; taps outside the 128(x) x 256(y) window read zero;
// out = sum_x xw * (sum_y yw * pix), f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT = 112;
constexpr int PIX = OUT * OUT;
constexpr int WIN_X = 128;
constexpr int WIN_Y = 256;
constexpr int N_PARAMS = 9;
constexpr int THREADS = 128;

__device__ __forceinline__ float hat(float l, float x) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(l, x))));
}

template <bool kEpilogue>
__global__ void __launch_bounds__(THREADS)
warp_xm_kernel(const uint8_t* __restrict__ pyr,
               const float* __restrict__ params,
               const uint8_t* __restrict__ valid,
               void* __restrict__ out,
               int K, int H, int W, float mean, float inv_scale) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= PIX) return;
  const size_t o = (static_cast<size_t>(n) * PIX + p) * 3;

  float s[3] = {0.0f, 0.0f, 0.0f};
  if (valid == nullptr || valid[n] != 0) {
    const float* prm = params + static_cast<size_t>(n) * N_PARAMS;
    const int level = static_cast<int>(prm[0]);
    const int x_lo = static_cast<int>(prm[1]);
    const int y_lo = static_cast<int>(prm[2]);
    const float a = prm[3], b = prm[4], c = prm[5], d = prm[6];
    const float tx = prm[7], ty = prm[8];

    // pyramid geometry: levels (H>>l, W>>l, 3) back to back per frame
    size_t frame_bytes = 0, level_off = 0;
    for (int l = 0; l < 4; ++l) {
      const size_t bytes = static_cast<size_t>(H >> l) * (W >> l) * 3;
      if (l < level) level_off += bytes;
      frame_bytes += bytes;
    }
    const int hl = H >> level, wl = W >> level;
    const uint8_t* base = pyr + static_cast<size_t>(n / K) * frame_bytes + level_off;

    const float fi = static_cast<float>(p / OUT);
    const float fj = static_cast<float>(p % OUT);
    float lx = __fadd_rn(__fadd_rn(__fmul_rn(a, fj), __fmul_rn(b, fi)), tx);
    float ly = __fadd_rn(__fadd_rn(__fmul_rn(c, fj), __fmul_rn(d, fi)), ty);
    lx = fminf(fmaxf(lx, -2.0f), WIN_X + 1.0f);
    ly = fminf(fmaxf(ly, -2.0f), WIN_Y + 1.0f);
    const int x0 = static_cast<int>(floorf(lx));
    const int y0 = static_cast<int>(floorf(ly));

#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xw = x0 + dx;
      const int gx = x_lo + xw;
      if (xw < 0 || xw >= WIN_X || gx >= wl) continue;
      const float wx = hat(lx, static_cast<float>(xw));
      float t[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int yw = y0 + dy;
        const int gy = y_lo + yw;
        if (yw < 0 || yw >= WIN_Y || gy >= hl) continue;
        const float wy =
            __bfloat162float(__float2bfloat16_rn(hat(ly, static_cast<float>(yw))));
        const uint8_t* px = base + (static_cast<size_t>(gy) * wl + gx) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          t[ch] = __fadd_rn(t[ch], __fmul_rn(wy, static_cast<float>(px[ch])));
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s[ch] = __fadd_rn(s[ch], __fmul_rn(t[ch], wx));
    }
  }

  if (kEpilogue) {
    // embed-ready RGB: channel 2-c, (s - mean) / scale, bf16
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out) + o;
    const bool live = valid == nullptr || valid[n] != 0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = __fmul_rn(__fsub_rn(s[ch], mean), inv_scale);
      y[2 - ch] = __float2bfloat16_rn(live ? v : 0.0f);
    }
  } else {
    float* y = static_cast<float*>(out) + o;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) y[ch] = s[ch];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int warp_xm_launch(const void* pyr, const void* params, const void* valid, void* out,
                   int n_faces, int K, int H, int W, int epilogue, float mean,
                   float inv_scale, void* stream) {
  const dim3 grid((PIX + THREADS - 1) / THREADS, n_faces);
  const dim3 block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* pyr8 = static_cast<const uint8_t*>(pyr);
  const float* prm = static_cast<const float*>(params);
  const uint8_t* val = static_cast<const uint8_t*>(valid);
  if (epilogue)
    warp_xm_kernel<true><<<grid, block, 0, st>>>(pyr8, prm, val, out, K, H, W, mean,
                                                 inv_scale);
  else
    warp_xm_kernel<false><<<grid, block, 0, st>>>(pyr8, prm, val, out, K, H, W, mean,
                                                  inv_scale);
  return static_cast<int>(cudaGetLastError());
}

const char* warp_xm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
