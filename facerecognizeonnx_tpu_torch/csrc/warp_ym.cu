// Face-alignment warp for Hopper (sm_90a), y-major window: per-face bilinear
// resample of a mip pyramid to 112x112x3 raw BGR crops (float32). Level 0 is
// read from the frames, levels 1-3 from the pyramid launch of csrc/warp_xm.cu,
// which both layouts share.
//
// Replaces the TPU kernel facerecognizeonnx_tpu/ops/warp_pallas.py::_kernel
// (the y-major v3a layout, launched by warp_affine_pallas(layout="ymajor")).
// The plain-torch version of the same function is
// ops/warp_cuda.py::warp_affine_ym_reference.
//
// What bounds it on this card: bytes and latency, not arithmetic. Each of the
// N x 112^2 x 3 outputs reads at most 2x2 taps of a uint8 window (<= 96 KB per
// face, L2-resident) and writes 4 bytes; there are a few dozen flops per pixel.
//
// What the design does about it: the same as csrc/warp_xm.cu. The TPU kernel's
// dense hat-weight matmul over a DMA'd (128 y, 256 x) window has at most two
// non-zero weights per axis, so one thread per output pixel gathers its 2x2
// taps directly (3 channels each) from the uint8 pyramid that both layouts
// share; blocks tile the pixels of one face (grid.y = face).
//
// Numerics follow the TPU kernel (run by the JAX package in interpret mode on
// the CPU), with no FMA contraction (the _rn intrinsics):
//   - parameters: the six float32 values of the driver (no fixed point; the
//     x-major kernel's 2^20 / 2^16 table does not apply here);
//   - lx = a*j + b*i + tx, ly = c*j + d*i + ty, clipped to [-2, 257] (x) and
//     [-2, 129] (y); taps outside the 256(x) x 128(y) window, or past the
//     level's edge, read zero. The window origin, x_lo = floor(x_min/128)*128
//     and y_lo = floor(y_min/16)*16, is part of the result;
//   - y-pass: hat weights rounded to bf16, t = sum_y wy * pix in float32 (the
//     products are exact; one rounding per add);
//   - x-pass, float32 (xpass_bf16 = 0): out = sum_x t * wx, hat weights in
//     float32;
//   - x-pass, bf16 (xpass_bf16 = 1): t rounded to bf16, wx rounded to bf16, each
//     product rounded to bf16 (the type of `t_c * xw` in the TPU kernel); the
//     products are summed in float32 and the sum is rounded to bf16, then
//     widened to float32: jnp.sum over a bf16 array upcasts to float32 for the
//     reduction (upcast_f16_for_computation) and casts the result back to bf16.
//     With at most two non-zero products per pixel the float32 sum is one
//     rounding. XLA on the CPU, where the JAX package runs the TPU kernel in
//     interpret mode, goes further: it allows excess precision and keeps the
//     exact bf16 x bf16 products in float32 before that sum, so the
//     interpret-mode result differs from this kernel by one bf16 ulp of the sum
//     on ~7% of values (at most 2.0; tests/test_torch_warp_ymajor.py).
// The TPU kernel's `unroll` option changes its schedule only, not its result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT = 112;
constexpr int PIX = OUT * OUT;
constexpr int WIN_X = 256;
constexpr int WIN_Y = 128;
constexpr int N_PARAMS = 9;
constexpr int THREADS = 128;

__device__ __forceinline__ float hat(float l, float x) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(l, x))));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kXpassBf16>
__global__ void __launch_bounds__(THREADS)
warp_ym_kernel(const uint8_t* __restrict__ frames,
               const uint8_t* __restrict__ upper,
               const float* __restrict__ params,
               float* __restrict__ out,
               int K, int H, int W) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= PIX) return;

  const float* prm = params + static_cast<size_t>(n) * N_PARAMS;
  const int level = static_cast<int>(prm[0]);
  const int x_lo = static_cast<int>(prm[1]);
  const int y_lo = static_cast<int>(prm[2]);
  const float a = prm[3], b = prm[4], c = prm[5], d = prm[6];
  const float tx = prm[7], ty = prm[8];

  // level 0 is the frame; levels 1-3 lie back to back per frame in `upper`
  size_t upper_bytes = 0, level_off = 0;
  for (int l = 1; l < 4; ++l) {
    const size_t bytes = static_cast<size_t>(H >> l) * (W >> l) * 3;
    if (l < level) level_off += bytes;
    upper_bytes += bytes;
  }
  const int hl = H >> level, wl = W >> level;
  const size_t frame = static_cast<size_t>(n / K);
  const uint8_t* base =
      level == 0 ? frames + frame * H * W * 3 : upper + frame * upper_bytes + level_off;

  const float fi = static_cast<float>(p / OUT);
  const float fj = static_cast<float>(p % OUT);
  float lx = __fadd_rn(__fadd_rn(__fmul_rn(a, fj), __fmul_rn(b, fi)), tx);
  float ly = __fadd_rn(__fadd_rn(__fmul_rn(c, fj), __fmul_rn(d, fi)), ty);
  lx = fminf(fmaxf(lx, -2.0f), WIN_X + 1.0f);
  ly = fminf(fmaxf(ly, -2.0f), WIN_Y + 1.0f);
  const int x0 = static_cast<int>(floorf(lx));
  const int y0 = static_cast<int>(floorf(ly));

  float s[3] = {0.0f, 0.0f, 0.0f};
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
      const float wy = bf16_round(hat(ly, static_cast<float>(yw)));
      const uint8_t* px = base + (static_cast<size_t>(gy) * wl + gx) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        t[ch] = __fadd_rn(t[ch], __fmul_rn(wy, static_cast<float>(px[ch])));
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (kXpassBf16)
        s[ch] = __fadd_rn(s[ch], bf16_round(__fmul_rn(bf16_round(t[ch]), bf16_round(wx))));
      else
        s[ch] = __fadd_rn(s[ch], __fmul_rn(t[ch], wx));
    }
  }

  float* y = out + (static_cast<size_t>(n) * PIX + p) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) y[ch] = kXpassBf16 ? bf16_round(s[ch]) : s[ch];
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// frames (level 0), upper (levels 1-3, as warp_xm.cu's pyramid_launch writes
// them), params (n_faces, 9) → out (n_faces, 112, 112, 3) f32.
int warp_ym_launch(const void* frames, const void* upper, const void* params, void* out,
                   int n_faces, int K, int H, int W, int xpass_bf16, void* stream) {
  const dim3 grid((PIX + THREADS - 1) / THREADS, n_faces);
  const dim3 block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* fr = static_cast<const uint8_t*>(frames);
  const uint8_t* up = static_cast<const uint8_t*>(upper);
  const float* prm = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (xpass_bf16)
    warp_ym_kernel<true><<<grid, block, 0, st>>>(fr, up, prm, o, K, H, W);
  else
    warp_ym_kernel<false><<<grid, block, 0, st>>>(fr, up, prm, o, K, H, W);
  return static_cast<int>(cudaGetLastError());
}

const char* warp_ym_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
