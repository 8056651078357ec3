// Streaming gallery similarity + top-k for Hopper (sm_90a): (Q, D) queries x
// (G, D) gallery rows → the k best rows per query by (q . g + 1) / 2, without
// writing the (Q, G) similarity matrix to device memory.
//
// Replaces the TPU kernel facerecognizeonnx_tpu/ops/pallas_gallery.py::_kernel
// (with its merge _merge_topk, launched by gallery_topk_pallas). The plain-torch
// version of the same function is ops/gallery_cuda.py::gallery_topk_reference.
//
// Semantics kept from the TPU kernel: float32 operands, float32 accumulation,
// then (s + 1) * 0.5; rows past the gallery never win; the result is ordered
// by value descending and, on equal values, by index ascending (the order of
// lax.top_k and of _merge_topk's first-maximum argmax), so duplicate rows come
// out lowest index first. The products use the CUDA cores' float32 FMA, never
// TF32 or bf16 tensor cores, which would move the sims by ~1e-3.
//
// What bounds it on this card: operations. At Q=128, G=100,000, D=512 it does
// 13.1 GFLOP of float32 FMA (0.20 ms at 67 TFLOP/s) and reads 205 MB of gallery
// (0.06 ms at 3.35 TB/s).
//
// What the design does about it (a simple first form):
//   - kernel A, grid (query tile x gallery split): each block owns QT queries
//     and a contiguous range of gallery rows. Per 128-row tile it stages the
//     queries and the rows through shared memory in 32-dim chunks (rows stored
//     transposed, so the 32 lanes of a warp read 32 consecutive rows without
//     bank conflicts; query values are warp-wide broadcasts) and keeps a QPW x 4
//     register tile of dot products per lane;
//   - each warp keeps, for each of its QPW queries, a sorted candidate list of
//     32*KL >= k entries in registers (lane l holds entries l*KL .. l*KL+KL-1).
//     A tile's sims are filtered against the list's k-th entry with one ballot;
//     each survivor is inserted by a warp-wide count of better entries and a
//     one-place shift through a shuffle. Most rows are rejected by the ballot
//     once the list is full, so for small k the product dominates;
//   - kernel A writes (Q, splits, k) partial lists; kernel B merges them per
//     query (one warp each) with the same lists, stopping on a split as soon as
//     32 of its sorted entries in a row fail the threshold.
// Staging through shared memory is synchronous (no cp.async/TMA pipeline) and
// the products use no register blocking beyond QPW x 4: later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GT = 128;  // gallery rows per tile: 4 per lane
constexpr int DK = 32;   // feature dims per shared-memory chunk
constexpr int MERGE_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;
constexpr int MAX_K = 512;

// (v, i) ranks before (w, j): larger value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <int KL>
struct List {
  float v[KL];
  int i[KL];
  float kth_v;  // the k-th entry, warp-uniform
  int kth_i;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      v[s] = -CUDART_INF_F;
      i[s] = NO_ROW;
    }
    kth_v = -CUDART_INF_F;
    kth_i = NO_ROW;
  }

  // insert (cv, ci), which ranks before the k-th entry; every lane calls it
  __device__ __forceinline__ void insert(float cv, int ci, int k, int lane) {
    int n_before = 0;
#pragma unroll
    for (int s = 0; s < KL; ++s) n_before += better(v[s], i[s], cv, ci) ? 1 : 0;
    const int pos = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(n_before)));
    // entries at and after pos move one place on; the last one drops out
    float prev_v = __shfl_up_sync(FULL, v[KL - 1], 1);
    int prev_i = __shfl_up_sync(FULL, i[KL - 1], 1);
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      const float cur_v = v[s];
      const int cur_i = i[s];
      const int g = lane * KL + s;
      if (g > pos) {
        v[s] = prev_v;
        i[s] = prev_i;
      } else if (g == pos) {
        v[s] = cv;
        i[s] = ci;
      }
      prev_v = cur_v;
      prev_i = cur_i;
    }
    const int owner = (k - 1) / KL, slot = (k - 1) % KL;
    float mv = v[0];
    int mi = i[0];
#pragma unroll
    for (int s = 1; s < KL; ++s)
      if (s == slot) {
        mv = v[s];
        mi = i[s];
      }
    kth_v = __shfl_sync(FULL, mv, owner);
    kth_i = __shfl_sync(FULL, mi, owner);
  }

  // offer one candidate per lane (ok = it exists); survivors go in lane order
  __device__ __forceinline__ void offer(float cv, int ci, bool ok, int k, int lane) {
    unsigned mask = __ballot_sync(FULL, ok && better(cv, ci, kth_v, kth_i));
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float sv = __shfl_sync(FULL, cv, src);
      const int si = __shfl_sync(FULL, ci, src);
      if (better(sv, si, kth_v, kth_i)) insert(sv, si, k, lane);
    }
  }

  __device__ __forceinline__ void store(float* out_v, int* out_i, int k, int lane) const {
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      const int g = lane * KL + s;
      if (g < k) {
        out_v[g] = v[s];
        out_i[g] = i[s];
      }
    }
  }
};

template <int KL, int QPW>
__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ g,
                    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int G,
                    int D, int k, int rows_per_split, int splits) {
  constexpr int QT = WARPS * QPW;
  __shared__ float qs[QT][DK];      // read as warp-wide broadcasts
  __shared__ float gs[DK][GT + 1];  // transposed; +1 keeps the stores conflict-free
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(G, row_begin + rows_per_split);

  List<KL> lists[QPW];
#pragma unroll
  for (int j = 0; j < QPW; ++j) lists[j].init();

  for (int base = row_begin; base < row_end; base += GT) {
    float acc[QPW][4];
#pragma unroll
    for (int j = 0; j < QPW; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[j][m] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < QT * DK; e += THREADS) {
        const int r = e / DK, dd = e % DK;
        const int qi = q0 + r, di = d0 + dd;
        qs[r][dd] = (qi < Q && di < D) ? q[static_cast<size_t>(qi) * D + di] : 0.0f;
      }
      for (int e = threadIdx.x; e < GT * DK; e += THREADS) {
        const int r = e / DK, dd = e % DK;
        const int gi = base + r, di = d0 + dd;
        gs[dd][r] = (gi < row_end && di < D) ? g[static_cast<size_t>(gi) * D + di] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DK; ++dd) {
        float gv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) gv[m] = gs[dd][lane + 32 * m];
#pragma unroll
        for (int j = 0; j < QPW; ++j) {
          const float qv = qs[warp * QPW + j][dd];
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[j][m] = fmaf(qv, gv[m], acc[j][m]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      if (q0 + warp * QPW + j >= Q) continue;  // warp-uniform
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int row = base + lane + 32 * m;
        const float sim = __fmul_rn(__fadd_rn(acc[j][m], 1.0f), 0.5f);
        lists[j].offer(sim, row, row < row_end, k, lane);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int qi = q0 + warp * QPW + j;
    if (qi >= Q) continue;
    const size_t off = (static_cast<size_t>(qi) * splits + split) * k;
    lists[j].store(part_v + off, part_i + off, k, lane);
  }
}

template <int KL>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  float* __restrict__ out_v, int* __restrict__ out_i, int Q, int splits,
                  int k) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (qi >= Q) return;  // warp-uniform
  List<KL> list;
  list.init();
  for (int sp = 0; sp < splits; ++sp) {
    const size_t off = (static_cast<size_t>(qi) * splits + sp) * k;
    for (int e0 = 0; e0 < k; e0 += 32) {
      const int e = e0 + lane;
      const bool ok = e < k;
      const float v = ok ? part_v[off + e] : -CUDART_INF_F;
      const int i = ok ? part_i[off + e] : NO_ROW;
      // a partial list is sorted: once 32 entries in a row fail, the rest do
      if (!__any_sync(FULL, ok && better(v, i, list.kth_v, list.kth_i))) break;
      list.offer(v, i, ok, k, lane);
    }
  }
  list.store(out_v + static_cast<size_t>(qi) * k, out_i + static_cast<size_t>(qi) * k, k,
             lane);
}

template <int KL, int QPW>
int launch(const float* q, const float* g, float* pv, int* pi, float* ov, int* oi, int Q,
           int G, int D, int k, int rows_per_split, int splits, cudaStream_t st) {
  constexpr int QT = WARPS * QPW;
  const dim3 grid_a((Q + QT - 1) / QT, splits);
  topk_partial_kernel<KL, QPW><<<grid_a, THREADS, 0, st>>>(q, g, pv, pi, Q, G, D, k,
                                                          rows_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((Q + MERGE_WARPS - 1) / MERGE_WARPS);
  topk_merge_kernel<KL><<<grid_b, MERGE_WARPS * 32, 0, st>>>(pv, pi, ov, oi, Q, splits, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Queries per block of kernel A for this k (the register lists take
// 2 * 32 * KL registers per query, so larger k takes fewer queries).
int gallery_topk_query_tile(int k) {
  if (k <= 64) return WARPS * 8;
  if (k <= 256) return WARPS * 4;
  return WARPS * 2;
}

// Launches kernels A and B on `stream`. part_v / part_i hold Q * splits * k
// entries; rows_per_split is a multiple of 128 and splits * rows_per_split
// covers G. Returns a cudaError_t (0 = ok).
int gallery_topk_launch(const void* queries, const void* gallery, void* part_v,
                        void* part_i, void* out_v, void* out_i, int Q, int G, int D,
                        int k, int rows_per_split, int splits, void* stream) {
  if (k < 1 || k > MAX_K || k > G || D < 1 || rows_per_split % GT != 0 ||
      static_cast<long long>(splits) * rows_per_split < G)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(queries);
  const float* g = static_cast<const float*>(gallery);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch<1, 8>(q, g, pv, pi, ov, oi, Q, G, D, k, rows_per_split, splits, st);
  if (k <= 64) return launch<2, 8>(q, g, pv, pi, ov, oi, Q, G, D, k, rows_per_split, splits, st);
  if (k <= 128) return launch<4, 4>(q, g, pv, pi, ov, oi, Q, G, D, k, rows_per_split, splits, st);
  if (k <= 256) return launch<8, 4>(q, g, pv, pi, ov, oi, Q, G, D, k, rows_per_split, splits, st);
  return launch<16, 2>(q, g, pv, pi, ov, oi, Q, G, D, k, rows_per_split, splits, st);
}

const char* gallery_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
