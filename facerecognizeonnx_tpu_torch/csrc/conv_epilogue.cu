// The epilogue between the convolutions of a folded bfloat16 IResNet, for
// Hopper (sm_90a): one pass over a convolution's float32 output that applies
// everything the eager path runs as separate full-tensor passes between two
// convolutions.
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions and the
// elementwise work around them to XLA, which fuses them. The port's eager path
// (models/layers.py: conv2d's bias add and cast, prelu, the residual add,
// batch_norm's cast, sub, mul, add and cast, and the next conv's operand cast)
// runs about ten float32 passes over each activation between two convolutions;
// this kernel reads the convolution's output once and writes only what the
// next convolutions read.
//
// What it computes, per element of y (the convolution's output, channels-last,
// C a multiple of 8), in the configuration's rounding points (models/layers.py):
//   t = bf16(y + bias)                          conv2d: f32 bias, one rounding
//   t = t >= 0 ? t : bf16(t * alpha)            prelu in bf16 (if alpha)
//   t = bf16(t + res)                           the residual add in bf16 (if res)
//   t = bf16(t + bf16(yd + bd))                 ... or the down-sampling conv's
//                                               output as its own epilogue (if yd)
// and writes, each where asked:
//   out_f32[i]  = f32(t)                        the next conv's operand
//   out_bf16[i] = t                             the next block's residual
//   out_bn[i]   = f32(bf16((f32(t) - mean) * inv + beta))
//                                               the next BatchNorm, as the next
//                                               conv's operand
// The three forms of the IResNet: after the stem (alpha, out_bn and one of
// out_f32 / out_bf16), after a block's conv1 (alpha, out_f32), after its conv2
// (res or yd, out_bn and at most one of out_f32 / out_bf16).
//
// Bits: every float operation is one of the eager path's, in its order, each
// rounded alone: the _rn intrinsics, which nvcc never contracts into an FMA
// (the eager path runs the sub, the mul and the add as separate kernels). The
// float -> bf16 rounding is __float2bfloat16, which c10::BFloat16 uses on
// sm_80 and later; prelu's test is torch's (x >= 0 keeps -0.0, a NaN takes the
// product). `inv` = rsqrt(var + eps) * scale comes from the wrapper, computed
// with the eager path's torch ops on the device.
//
// What bounds it: bytes. It reads 4 bytes of y (8 with yd, 6 with res) and
// writes 4 to 10 bytes an element, a few float operations each. The design:
// each thread takes 8 consecutive channels of one pixel per step (two 16-byte
// loads of y, one of res), in a grid-stride loop whose stride is a multiple of
// C/8, so a thread keeps the same 8 channels in every step and loads its
// per-channel tables (bias, alpha, bd, mean, inv, beta) into registers once.
// One kernel serves every form: an instantiation per form (30 to 76 registers)
// took 11.64 ms against its 10.70 over the 49 launches of one IResNet-50
// forward at B=512 on an H100 (700 W).
// The grid is 8 blocks of 256 threads per SM; the loads and stores stream
// (.cs), since no activation of these sizes stays in L2 until its next read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // channels a thread takes per step
constexpr int BLOCKS_PER_SM = 8;

struct Params {
  const float* y;
  const float* bias;
  const float* alpha;           // bf16-exact float32, or null: no prelu
  const __nv_bfloat16* res;     // or null
  const float* yd;              // or null
  const float* bd;              // with yd
  const float* mean;            // or null: no out_bn
  const float* inv;
  const float* beta;
  float* out_f32;               // each output may be null
  __nv_bfloat16* out_bf16;
  float* out_bn;
  long long n_vec;              // elements / 8
  long long stride;             // active threads: a multiple of groups
  int groups;                   // C / 8
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void table8(const float* p, int c0, float (&v)[VEC]) {
#pragma unroll
  for (int f = 0; f < VEC; ++f) v[f] = p ? p[c0 + f] : 0.f;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  // lo, hi are bf16-exact: their upper halves are the bf16 bits
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

__global__ void __launch_bounds__(THREADS) conv_epilogue_kernel(Params p) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (tid >= p.stride) return;
  const int c0 = static_cast<int>(tid % p.groups) * VEC;

  float b[VEC], a[VEC], bd[VEC], mu[VEC], iv[VEC], be[VEC];
  table8(p.bias, c0, b);
  table8(p.alpha, c0, a);
  table8(p.bd, c0, bd);
  table8(p.mean, c0, mu);
  table8(p.inv, c0, iv);
  table8(p.beta, c0, be);

  for (long long v = tid; v < p.n_vec; v += p.stride) {
    const long long off = v * VEC;
    float t[VEC];
    load8(p.y + off, t);
#pragma unroll
    for (int f = 0; f < VEC; ++f) t[f] = round_bf16(__fadd_rn(t[f], b[f]));
    if (p.alpha) {
#pragma unroll
      for (int f = 0; f < VEC; ++f) t[f] = t[f] >= 0.f ? t[f] : round_bf16(__fmul_rn(t[f], a[f]));
    }
    if (p.res) {
      const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p.res + off));
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int f = 0; f < VEC; ++f) {
        const float id = __uint_as_float(f & 1 ? w[f >> 1] & 0xffff0000u : w[f >> 1] << 16);
        t[f] = round_bf16(__fadd_rn(t[f], id));
      }
    } else if (p.yd) {
      float d[VEC];
      load8(p.yd + off, d);
#pragma unroll
      for (int f = 0; f < VEC; ++f) t[f] = round_bf16(__fadd_rn(t[f], round_bf16(__fadd_rn(d[f], bd[f]))));
    }
    if (p.out_f32) store8(p.out_f32 + off, t);
    if (p.out_bf16) {
      __stcs(reinterpret_cast<uint4*>(p.out_bf16 + off),
             make_uint4(pack2(t[0], t[1]), pack2(t[2], t[3]), pack2(t[4], t[5]), pack2(t[6], t[7])));
    }
    if (p.mean) {
      float o[VEC];
#pragma unroll
      for (int f = 0; f < VEC; ++f) {
        o[f] = round_bf16(__fadd_rn(__fmul_rn(__fsub_rn(t[f], mu[f]), iv[f]), be[f]));
      }
      store8(p.out_bn + off, o);
    }
  }
}

}  // namespace

extern "C" {

// One epilogue pass over y (n elements, channels-last, C channels innermost)
// on `stream`. y, res, yd and the outputs are 16-byte aligned; n and C are
// multiples of 8; null marks an input or output that is not used (bd with yd;
// inv, beta and out_bn with mean). Returns a cudaError_t (0 = ok).
int conv_epilogue_launch(const void* y, const void* bias, const void* alpha, const void* res,
                         const void* yd, const void* bd, const void* mean, const void* inv,
                         const void* beta, void* out_f32, void* out_bf16, void* out_bn,
                         long long n, int C, void* stream) {
  if (n <= 0 || C <= 0 || n % VEC || C % VEC || n % C || !y || !bias)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((yd && !bd) || (mean && !(inv && beta && out_bn)))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms[64] = {};  // per device: the SM count, read once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) sms[dev] = n_sm;
  }
  Params p;
  p.y = static_cast<const float*>(y);
  p.bias = static_cast<const float*>(bias);
  p.alpha = static_cast<const float*>(alpha);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.yd = static_cast<const float*>(yd);
  p.bd = static_cast<const float*>(bd);
  p.mean = static_cast<const float*>(mean);
  p.inv = static_cast<const float*>(inv);
  p.beta = static_cast<const float*>(beta);
  p.out_f32 = static_cast<float*>(out_f32);
  p.out_bf16 = static_cast<__nv_bfloat16*>(out_bf16);
  p.out_bn = static_cast<float*>(out_bn);
  p.n_vec = n / VEC;
  p.groups = C / VEC;
  // enough threads for every vector, at most BLOCKS_PER_SM blocks an SM, and
  // at least one thread per channel group
  const long long want = (p.n_vec + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(n_sm) * BLOCKS_PER_SM;
  long long blocks = want < cap ? want : cap;
  const long long min_blocks = (p.groups + THREADS - 1) / THREADS;
  if (blocks < min_blocks) blocks = min_blocks;
  const long long total = blocks * THREADS;
  p.stride = total - total % p.groups;
  conv_epilogue_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
