// Greedy NMS for Hopper (sm_90a): the survivor mask of score-sorted candidate
// sets, one frame per block, with no host read.
//
// Replaces no Pallas kernel: the JAX package computes this mask on the TPU as a
// lax.while_loop of masked (K, K) matvecs (facerecognizeonnx_tpu/ops/nms.py::
// nms_fixed, :100-112). Its plain-torch version, ops/nms.py::
// nms_greedy_reference, iterates the same fixpoint with a host read every few
// iterations; that read is what kept the detector step out of a CUDA graph.
//
// What it computes, per frame b of B (candidates already in descending score
// order, K of them): keep[i] = valid[i] and no kept j < i has
// iou(j, i) > threshold, i.e. the fixpoint the reference iterates, which is
// exactly the greedy result (row i is final once rows < i are).
//
// What bounds it on this card: neither bytes (18 per candidate) nor operations
// (14 float ops per pair, at most B·K²/2 pairs): latency. An IoU is a chain of
// dependent operations (the IEEE division among them), the greedy scan is a
// chain of dependent steps, one per kept candidate, and a frame has few
// candidates to spread over threads.
//
// The design: one block of 1,024 threads per frame.
//   1. The block loads the frame's boxes into shared memory as five arrays
//      (x1, y1, x2, y2, area), first truncated to integer rects when asked, as
//      ops/nms.py::_int_rects does: x = trunc(x1), y = trunc(y1),
//      w = trunc(x2 - x1), h = trunc(y2 - y1), rect (x, y, x + w, y + h).
//   2. It writes the suppression bitmask: bit i - 32w of word w of row j is set
//      when i > j and iou(j, i) > threshold. A warp takes one word: lane l
//      computes iou(j, 32w + l) and a ballot forms the word, so the block's 32
//      warps compute 1,024 IoUs at once with no dependence between them. Only
//      the rows of valid candidates are computed (only a kept candidate's row
//      is read), up to the last valid one (the valid candidates come first on
//      the main path: score order). The IoU is ops/nms.py::iou_matrix's, in
//      torch's order and roundings:
//        inter = max(min(x2j, x2i) - max(x1j, x1i), 0)
//              * max(min(y2j, y2i) - max(y1j, y1i), 0)
//        union = (area_j + area_i) - inter
//        iou   = inter / max(union, 1e-12f)
//      written with _rn intrinsics, because nvcc's default --fmad=true would
//      contract a product and a sum into an FMA and flip decisions that torch's
//      separately rounded operations take the other way; max and min carry NaN
//      as torch.maximum / minimum / clamp_min do. The threshold is compared as
//      a float, as torch and JAX compare a float32 tensor with a Python float.
//   3. One warp scans the candidates in order, word by word. Lane l holds word
//      l of the removed bits. In word w, the valid candidates not yet removed
//      are taken lowest first: each is kept, and every lane ORs in its word of
//      that candidate's row (which only marks later candidates). Steps: one per
//      kept candidate plus one per word.
//   4. The block writes keep as bytes (torch.bool).
// Each launch adds one to a device counter (read by nms_greedy_launch_count),
// so a run can see launches that a CUDA-graph replay makes without Python.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 1024;  // 32 words a row: one per lane of the scanning warp
constexpr unsigned FULL = 0xffffffffu;

__device__ unsigned long long g_launches = 0;

__device__ __forceinline__ bool isnan_(float v) { return v != v; }

__device__ __forceinline__ float tmax(float a, float b) {
  if (isnan_(a) || isnan_(b)) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__device__ __forceinline__ float tmin(float a, float b) {
  if (isnan_(a) || isnan_(b)) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

__host__ __device__ constexpr int row_words(int K) { return (K + 31) / 32; }

// shared bytes for K candidates: five float arrays, the mask rows (W + 1
// words each, so that the writes of consecutive rows fall in distinct
// banks), the valid bytes and the keep words
__host__ __device__ constexpr size_t smem_bytes(int K) {
  return static_cast<size_t>(K) * 5 * sizeof(float) +
         static_cast<size_t>(K) * (row_words(K) + 1) * sizeof(uint32_t) + 32 * sizeof(uint32_t) +
         static_cast<size_t>(K);
}

__global__ void __launch_bounds__(THREADS)
nms_greedy_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, int K, float threshold, int int_rects) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = row_words(K), WP = W + 1;
  float* x1 = reinterpret_cast<float*>(smem);
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* area = y2 + K;
  uint32_t* mask = reinterpret_cast<uint32_t*>(area + K);
  uint32_t* keepw = mask + static_cast<size_t>(K) * WP;
  uint8_t* ok = reinterpret_cast<uint8_t*>(keepw + 32);

  __shared__ int n_rows;  // 1 + the last valid candidate
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    n_rows = 0;
    if (b == 0) atomicAdd(&g_launches, 1ULL);
  }
  __syncthreads();
  const float* bx = boxes + static_cast<size_t>(b) * K * 4;
  const uint8_t* vb = valid + static_cast<size_t>(b) * K;

  // 1. boxes (integer rects when asked) and their areas
  for (int i = threadIdx.x; i < K; i += THREADS) {
    float a0 = bx[4 * i], a1 = bx[4 * i + 1], a2 = bx[4 * i + 2], a3 = bx[4 * i + 3];
    if (int_rects) {
      const float w = truncf(__fsub_rn(a2, a0)), h = truncf(__fsub_rn(a3, a1));
      a0 = truncf(a0);
      a1 = truncf(a1);
      a2 = __fadd_rn(a0, w);
      a3 = __fadd_rn(a1, h);
    }
    x1[i] = a0;
    y1[i] = a1;
    x2[i] = a2;
    y2[i] = a3;
    area[i] = __fmul_rn(__fsub_rn(a2, a0), __fsub_rn(a3, a1));
    ok[i] = vb[i] != 0;
    if (ok[i]) atomicMax(&n_rows, i + 1);
  }
  if (threadIdx.x < 32) keepw[threadIdx.x] = 0;
  __syncthreads();

  // 2. the suppression rows of the valid candidates: word w of row j per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < n_rows * W; q += WARPS) {
    const int j = q / W, w = q - j * W;
    if (!ok[j]) continue;  // warp-uniform
    const int i = 32 * w + lane;
    bool hit = false;
    if (i > j && i < K) {
      const float iw = tmax(__fsub_rn(tmin(x2[j], x2[i]), tmax(x1[j], x1[i])), 0.0f);
      const float ih = tmax(__fsub_rn(tmin(y2[j], y2[i]), tmax(y1[j], y1[i])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area[j], area[i]), inter);
      hit = __fdiv_rn(inter, tmax(uni, 1e-12f)) > threshold;
    }
    const uint32_t bits = __ballot_sync(FULL, hit);
    if (lane == 0) mask[static_cast<size_t>(j) * WP + w] = bits;
  }
  __syncthreads();

  // 3. the greedy scan, one warp
  if (warp == 0) {
    uint32_t removed = 0;  // word `lane` of the removed bits
    uint32_t valid_w = 0;  // word `lane` of the valid bits
    for (int w = 0; w < W; ++w) {
      const int i = 32 * w + lane;
      const uint32_t v = __ballot_sync(FULL, i < K && ok[i]);
      if (lane == w) valid_w = v;
    }
    for (int w = 0; w < W; ++w) {
      const uint32_t vw = __shfl_sync(FULL, valid_w, w);
      uint32_t pending = vw & ~__shfl_sync(FULL, removed, w);
      uint32_t kept = 0;
      while (pending) {
        const int bit = __ffs(pending) - 1;
        const int i = 32 * w + bit;
        kept |= 1u << bit;
        if (lane < W) removed |= mask[static_cast<size_t>(i) * WP + lane];
        // row i marks only later candidates: bits above `bit` in this word
        pending &= ~(1u << bit);
        pending &= ~__shfl_sync(FULL, removed, w);
      }
      if (lane == 0) keepw[w] = kept;
    }
  }
  __syncthreads();

  // 4. the mask as bytes
  uint8_t* kb = keep + static_cast<size_t>(b) * K;
  for (int i = threadIdx.x; i < K; i += THREADS) kb[i] = (keepw[i >> 5] >> (i & 31)) & 1u;
}

}  // namespace

extern "C" {

// keep (B, K) uint8 of boxes (B, K, 4) float32 x1,y1,x2,y2 and valid (B, K)
// uint8, both in descending score order, on `stream`; 0 < K <= 1024. Returns a
// cudaError_t (0 = ok).
int nms_greedy_launch(const void* boxes, const void* valid, void* keep, int B, int K,
                      float threshold, int int_rects, void* stream) {
  if (K <= 0 || K > MAX_K || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[64] = {};  // per device: the shared-memory budget, raised once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !configured[dev]) {
    e = cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(MAX_K)));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) configured[dev] = true;
  }
  nms_greedy_kernel<<<B, THREADS, smem_bytes(K), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, threshold, int_rects);
  return static_cast<int>(cudaGetLastError());
}

// The launches of nms_greedy_kernel on the current device so far (a
// synchronous copy: for checks outside timed work). Returns a cudaError_t.
int nms_greedy_launch_count(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches)));
}

const char* nms_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
