// Streaming gallery similarity + top-k for Hopper (sm_90a): (Q, D) queries x
// (G, D) gallery rows → the k best rows per query by (q . g + 1) / 2, without
// writing the (Q, G) similarity matrix to device memory.
//
// Replaces the TPU kernel facerecognizeonnx_tpu/ops/pallas_gallery.py::_kernel
// (with its merge _merge_topk, launched by gallery_topk_pallas). The plain-torch
// version of the same function is ops/gallery_cuda.py::gallery_topk_reference.
//
// Semantics kept from the TPU kernel: float32-accurate sims, then
// (s + 1) * 0.5; rows past the gallery never win; the result is ordered by
// value descending and, on equal values, by index ascending (the order of
// lax.top_k and of _merge_topk's first-maximum argmax), so duplicate rows come
// out lowest index first.
//
// What bounds it on this card: operations. Float32-accurate products on the
// tensor cores take three TF32 passes (3xTF32: hi*hi + hi*lo + lo*hi, with
// hi = tf32(x), lo = tf32(x - hi), summed in f32). At Q=128, G=100,000, D=512
// that is 3 x 13.1 GFLOP at 495 TFLOP/s = 0.079 ms, against 205 MB of
// gallery read once at 3.35 TB/s = 0.061 ms. (On the CUDA cores' float32 FMA
// the same products would take 0.196 ms.) The error of 3xTF32 on unit-norm
// rows at D=512 is ~2^-21 per sim, far inside the 1e-5 bar; identical rows
// give identical sums, since every output element is accumulated in the same
// order, so ties stay exact.
//
// What the design does about it:
//   - kernel S splits the queries once into their TF32 hi and lo parts
//     (cvt.rna.tf32.f32), float32 storage in device memory (they stay in L2).
//   - kernel A, grid (query tile x gallery split), about one block per SM.
//     A block holds N queries (128 for k <= 16, 64 for k <= 128, 32 up to
//     k = 512: the sorted per-query lists live in shared memory) against a
//     stream of 128-row gallery tiles, so at Q=128 and k <= 16 the gallery
//     is read once. One producer warp keeps a ring of two stages in flight
//     with TMA (cp.async.bulk.tensor, mbarrier completion): per stage a
//     128-row x 32-dim gallery chunk and the same 32 dims of the queries'
//     hi and lo parts, 128-byte swizzled. TMA fills rows past G and dims
//     past D with zeros.
//   - two consumer warpgroups, 64 gallery rows each, split their rows of the
//     landed chunk into hi and lo in shared memory, then run wgmma.m64nNk8
//     TF32 from shared memory (K-major, as TMA wrote it) into two f32
//     accumulators: hi*hi, and hi*lo + lo*hi; the small one is added to the
//     large one at the end of the tile.
//   - selection: the tile's sims go to shared memory query-major, and one
//     warp per query takes its 128 sims, 32 at a time, against the list's
//     k-th entry (value, index). For k <= 32 the list sits one entry per
//     lane: a few survivors are inserted by a ballot and a shuffle, more are
//     selected with the list in k rounds of a warp-wide best. For larger k a
//     few survivors are inserted by a binary search and a shift, a larger
//     batch is merged at once (rank of each survivor in the batch and in the
//     list, rank of each list entry among the sorted batch). Every step
//     follows the total order (value desc, index asc), so arrival order
//     changes nothing.
//   - kernel B merges the splits' sorted partial lists per query with the
//     batch merge (one warp per query, 32 entries at a time, stopping on a
//     split once a batch holds no entry that beats the k-th).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;
constexpr int MAX_K = 512;
constexpr int GT = 128;          // gallery rows per tile (two warpgroups of 64)
constexpr int DK = 32;           // dims per stage: one 128-byte swizzle row
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int SIMS_STRIDE = GT + 4;  // floats per query row of a tile's sims
constexpr int MERGE_WARPS = 4;

// (v, i) ranks before (w, j): larger value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ------------------------------------------------------------ barriers, TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------ wgmma

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the layout TMA writes for a 32-float box row)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk8 TF32 x TF32 → f32, both operands from shared memory
__device__ __forceinline__ void wgmma_tf32_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 128) wgmma_tf32_n128(d, da, db);
  else if constexpr (N == 64) wgmma_tf32_n64(d, da, db);
  else wgmma_tf32_n32(d, da, db);
}

// ------------------------------------------------------------ the batched merge

// Merge the lanes' candidates (cv, ci) where ok into the list (lv, li) of k
// entries in shared memory, sorted by the total order with empty entries
// (-inf, NO_ROW) last; tv / ti: 32 entries of the warp's scratch. Every lane
// of the warp calls it. KL: list entries per lane (k <= 32 * KL).
template <int KL>
__device__ void warp_merge(float* lv, int* li, int k, float cv, int ci, bool ok, float* tv,
                           int* ti, int lane) {
  const unsigned okm = __ballot_sync(FULL, ok);
  if (!okm) return;
  const int nc = __popc(okm);
  int r = 0;  // rank among the batch
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const float vj = __shfl_sync(FULL, cv, j);
    const int ij = __shfl_sync(FULL, ci, j);
    r += ((okm >> j) & 1u) && better(vj, ij, cv, ci);
  }
  int pos = k;
  if (ok) {
    int lo = 0, hi = k;  // list entries that rank before the candidate
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(lv[mid], li[mid], cv, ci)) lo = mid + 1;
      else hi = mid;
    }
    pos = r + lo;
    tv[r] = cv;
    ti[r] = ci;
  }
  __syncwarp();
  float ev[KL];
  int ei[KL], np[KL];
#pragma unroll
  for (int t = 0; t < KL; ++t) {
    const int e = lane + 32 * t;
    np[t] = k;
    if (e < k) {
      ev[t] = lv[e];
      ei[t] = li[e];
      int a = 0, b = nc;  // batch entries that rank before the list entry
      while (a < b) {
        const int m = (a + b) >> 1;
        if (better(tv[m], ti[m], ev[t], ei[t])) a = m + 1;
        else b = m;
      }
      np[t] = e + a;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KL; ++t)
    if (np[t] < k) {
      lv[np[t]] = ev[t];
      li[np[t]] = ei[t];
    }
  if (pos < k) {
    lv[pos] = cv;
    li[pos] = ci;
  }
  __syncwarp();
}

constexpr int FEW = 4;  // survivors of a batch inserted one by one

// k <= 32: a query's list is one entry per lane (lane < k), in registers
// while the warp works on the query.
struct Lane1 {
  float v;
  int i;
};

__device__ __forceinline__ Lane1 warp_best(Lane1 x) {  // the best of 32, in every lane
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, x.v, off);
    const int oi = __shfl_xor_sync(FULL, x.i, off);
    if (better(ov, oi, x.v, x.i)) x = {ov, oi};
  }
  return x;
}

// insert (cv, ci) into the lanes' list e if it beats the k-th entry
__device__ __forceinline__ void insert1(Lane1& e, float cv, int ci, int k, int lane) {
  const float kv = __shfl_sync(FULL, e.v, k - 1);
  const int ki = __shfl_sync(FULL, e.i, k - 1);
  if (!better(cv, ci, kv, ki)) return;  // warp-uniform
  const int pos = __popc(__ballot_sync(FULL, lane < k && better(e.v, e.i, cv, ci)));
  const float uv = __shfl_up_sync(FULL, e.v, 1);
  const int ui = __shfl_up_sync(FULL, e.i, 1);
  if (lane > pos) e = {uv, ui};
  else if (lane == pos) e = {cv, ci};
}

// One tile's 4 x 32 sims of one query (v, row; ok: valid and beating the
// k-th entry) into its list (lq, iq) in shared memory, k <= 32. A few
// survivors are inserted one by one; more are selected with the list in k
// rounds: each lane offers the best of its list entry and its 4 sims, the
// warp keeps the best offer, its lane drops it.
__device__ void select_tile1(float* lq, int* iq, int k, const float (&v)[4],
                             const int (&row)[4], const bool (&ok)[4], int n, int lane) {
  Lane1 e = lane < k ? Lane1{lq[lane], iq[lane]} : Lane1{-CUDART_INF_F, NO_ROW};
  if (n <= FEW) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      unsigned mask = __ballot_sync(FULL, ok[m]);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        insert1(e, __shfl_sync(FULL, v[m], src), __shfl_sync(FULL, row[m], src), k, lane);
      }
    }
  } else {
    Lane1 pool[5] = {e, {-CUDART_INF_F, NO_ROW}, {-CUDART_INF_F, NO_ROW},
                     {-CUDART_INF_F, NO_ROW}, {-CUDART_INF_F, NO_ROW}};
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // insertion into the sorted pool
      Lane1 x = ok[m] ? Lane1{v[m], row[m]} : Lane1{-CUDART_INF_F, NO_ROW};
#pragma unroll
      for (int s = 0; s < 5; ++s)
        if (better(x.v, x.i, pool[s].v, pool[s].i)) {
          const Lane1 t = pool[s];
          pool[s] = x;
          x = t;
        }
    }
    Lane1 out = {-CUDART_INF_F, NO_ROW};
    for (int t = 0; t < k; ++t) {
      const Lane1 best = warp_best(pool[0]);
      if (lane == t) out = best;
      if (pool[0].i == best.i && pool[0].v == best.v) {
#pragma unroll
        for (int s = 0; s < 4; ++s) pool[s] = pool[s + 1];
        pool[4] = {-CUDART_INF_F, NO_ROW};
      }
    }
    e = out;
  }
  __syncwarp();
  if (lane < k) {
    lq[lane] = e.v;
    iq[lane] = e.i;
  }
  __syncwarp();
}

// insert (cv, ci) into a sorted list of k > 32 entries in shared memory
template <int KL>
__device__ void insert_smem(float* lv, int* li, int k, float cv, int ci, int lane) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(lv[mid], li[mid], cv, ci)) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= k) return;  // warp-uniform
  float ev[KL];
  int ei[KL];
#pragma unroll
  for (int t = 0; t < KL; ++t) {
    const int e = lane + 32 * t;
    if (e >= lo && e < k - 1) {
      ev[t] = lv[e];
      ei[t] = li[e];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KL; ++t) {
    const int e = lane + 32 * t;
    if (e >= lo && e < k - 1) {
      lv[e + 1] = ev[t];
      li[e + 1] = ei[t];
    }
  }
  if (lane == 0) {
    lv[lo] = cv;
    li[lo] = ci;
  }
  __syncwarp();
}

// a batch of survivors (one per lane where ok) into a list of k > 32
template <int KL>
__device__ void select_batch(float* lv, int* li, int k, float cv, int ci, bool ok, float* tv,
                             int* ti, int lane) {
  unsigned mask = __ballot_sync(FULL, ok);
  if (__popc(mask) > FEW) {
    warp_merge<KL>(lv, li, k, cv, ci, ok, tv, ti, lane);
    return;
  }
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    insert_smem<KL>(lv, li, k, __shfl_sync(FULL, cv, src), __shfl_sync(FULL, ci, src), lane);
  }
}

// ------------------------------------------------------------ kernel S

// queries → their TF32 hi and lo parts (float32 storage); zeros from
// element n_valid to n (the rows past Q that a query tile's box covers)
__global__ void split_kernel(const float* __restrict__ q, float* __restrict__ hi,
                             float* __restrict__ lo, size_t n_valid, size_t n) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float x = e < n_valid ? q[e] : 0.0f;
    const float h = tf32_rna(x);
    hi[e] = h;
    lo[e] = tf32_rna(x - h);
  }
}

// ------------------------------------------------------------ kernel A

template <int N>
struct Smem {
  static constexpr int G_BYTES = GT * DK * 4;  // one stage's gallery chunk
  static constexpr int Q_BYTES = N * DK * 4;   // one stage's query chunk (hi or lo)
  static constexpr int STAGE = 2 * G_BYTES + 2 * Q_BYTES;  // g (→ hi), g lo, q hi, q lo
  static size_t bytes(int k) {  // stages, sims, lists, merge scratch, barriers
    return static_cast<size_t>(STAGES) * STAGE + 4ull * N * SIMS_STRIDE + 8ull * N * k +
           8ull * (CONSUMERS / 32) * 32 + 16ull * STAGES;
  }
};

template <int N, int KL>
__global__ void __launch_bounds__(THREADS, 1)
topk_partial_kernel(const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap qhmap,
                    const __grid_constant__ CUtensorMap qlmap, float* __restrict__ part_v,
                    int* __restrict__ part_i, int Q, int G, int D, int k, int rows_per_split,
                    int splits) {
  using L = Smem<N>;
  extern __shared__ __align__(1024) uint8_t smem[];  // 128-byte swizzle wants 1024
  float* sims = reinterpret_cast<float*>(smem + STAGES * L::STAGE);  // (N, SIMS_STRIDE)
  float* lv = sims + N * SIMS_STRIDE;  // (N, k) sorted lists
  int* li = reinterpret_cast<int*>(lv + N * k);
  float* tmp_v = reinterpret_cast<float*>(li + N * k);  // 32 per consumer warp
  int* tmp_i = reinterpret_cast<int*>(tmp_v + (CONSUMERS / 32) * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(tmp_i + (CONSUMERS / 32) * 32);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * N, split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(G, row_begin + rows_per_split);
  const int n_tiles = (row_end - row_begin + GT - 1) / GT;
  const int n_chunks = (D + DK - 1) / DK;

  for (int e = tid; e < N * k; e += THREADS) {
    lv[e] = -CUDART_INF_F;
    li[e] = NO_ROW;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the TMA ring full
    if (lane == 0) {
      const int total = n_tiles * n_chunks;
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * L::STAGE;
        const int t = it / n_chunks, c = it % n_chunks;
        mbar_expect_tx(&full[s], L::G_BYTES + 2 * L::Q_BYTES);
        tma_load_2d(st, &gmap, &full[s], c * DK, row_begin + t * GT);
        tma_load_2d(st + 2 * L::G_BYTES, &qhmap, &full[s], c * DK, q0);
        tma_load_2d(st + 2 * L::G_BYTES + L::Q_BYTES, &qlmap, &full[s], c * DK, q0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes gallery rows wg*64 .. wg*64+63 of a tile
  const int wg = warp >> 2, wq = warp & 3;
  constexpr int R = N / 2;  // accumulator registers per thread
  float big[R], small[R];
  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int i = 0; i < R; ++i) big[i] = small[i] = 0.0f;
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      uint8_t* st = smem + s * L::STAGE;
      uint8_t* g_hi = st + wg * (L::G_BYTES / 2);
      uint8_t* g_lo = st + L::G_BYTES + wg * (L::G_BYTES / 2);
      // split this warpgroup's 64 rows into TF32 hi (in place) and lo
      float4* h4 = reinterpret_cast<float4*>(g_hi);
      float4* l4 = reinterpret_cast<float4*>(g_lo);
      for (int e = tid & 127; e < L::G_BYTES / 2 / 16; e += 128) {
        const float4 x = h4[e];
        float4 h, l;
        h.x = tf32_rna(x.x); l.x = tf32_rna(x.x - h.x);
        h.y = tf32_rna(x.y); l.y = tf32_rna(x.y - h.y);
        h.z = tf32_rna(x.z); l.z = tf32_rna(x.z - h.z);
        h.w = tf32_rna(x.w); l.w = tf32_rna(x.w - h.w);
        h4[e] = h;
        l4[e] = l;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(2 + wg, 128);
      const uint64_t a_hi = desc_sw128(g_hi), a_lo = desc_sw128(g_lo);
      const uint64_t b_hi = desc_sw128(st + 2 * L::G_BYTES);
      const uint64_t b_lo = desc_sw128(st + 2 * L::G_BYTES + L::Q_BYTES);
      fence_regs<R>(big);
      fence_regs<R>(small);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {  // k8 steps: 32 bytes along the row
        wgmma_tf32<N>(big, a_hi + 2 * kk, b_hi + 2 * kk);
        wgmma_tf32<N>(small, a_hi + 2 * kk, b_lo + 2 * kk);
        wgmma_tf32<N>(small, a_lo + 2 * kk, b_hi + 2 * kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs<R>(big);
      fence_regs<R>(small);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // ---- selection: accumulator i holds row rl + 8*h of the tile, query
    // 8*j + 2*(lane%4) + e. The tile's sims go to shared memory query-major;
    // then one warp per query takes its 128 sims 32 at a time, keeps those
    // that beat the k-th entry, and merges them into the list at once.
    const int rl = wg * 64 + wq * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      sims[q * SIMS_STRIDE + rl + 8 * ((i >> 1) & 1)] =
          __fmul_rn(__fadd_rn(__fadd_rn(big[i], small[i]), 1.0f), 0.5f);
    }
    named_sync(1, CONSUMERS);
    const int base = row_begin + t * GT;
    for (int q = warp; q < N && q0 + q < Q; q += CONSUMERS / 32) {
      float* lq = lv + q * k;
      int* iq = li + q * k;
      if constexpr (KL == 1) {
        const float kv = lq[k - 1];
        const int ki = iq[k - 1];
        float v[4];
        int row[4], n = 0;
        bool ok[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          row[m] = base + 32 * m + lane;
          v[m] = sims[q * SIMS_STRIDE + 32 * m + lane];
          ok[m] = row[m] < row_end && better(v[m], row[m], kv, ki);
          n += __popc(__ballot_sync(FULL, ok[m]));
        }
        if (n) select_tile1(lq, iq, k, v, row, ok, n, lane);
      } else {
#pragma unroll
        for (int m = 0; m < GT / 32; ++m) {
          const int row = base + 32 * m + lane;
          const float v = sims[q * SIMS_STRIDE + 32 * m + lane];
          const bool ok = row < row_end && better(v, row, lq[k - 1], iq[k - 1]);
          if (__any_sync(FULL, ok))
            select_batch<KL>(lq, iq, k, v, row, ok, tmp_v + warp * 32, tmp_i + warp * 32, lane);
        }
      }
    }
    named_sync(1, CONSUMERS);  // the sims buffer is free for the next tile
  }

  for (int q = warp; q < N; q += CONSUMERS / 32) {
    if (q0 + q >= Q) break;
    const size_t off = (static_cast<size_t>(q0 + q) * splits + split) * k;
    for (int e = lane; e < k; e += 32) {
      part_v[off + e] = lv[q * k + e];
      part_i[off + e] = li[q * k + e];
    }
  }
}

// ------------------------------------------------------------ kernel B

template <int KL>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  float* __restrict__ out_v, int* __restrict__ out_i, int Q, int splits,
                  int k) {
  __shared__ float list_v[MERGE_WARPS][32 * KL];
  __shared__ int list_i[MERGE_WARPS][32 * KL];
  __shared__ float tmp_v[MERGE_WARPS][32];
  __shared__ int tmp_i[MERGE_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int qi = blockIdx.x * MERGE_WARPS + w;
  if (qi >= Q) return;  // warp-uniform; no block-wide barrier below
  float* lv = list_v[w];
  int* li = list_i[w];
  for (int e = lane; e < k; e += 32) {
    lv[e] = -CUDART_INF_F;
    li[e] = NO_ROW;
  }
  __syncwarp();
  for (int sp = 0; sp < splits; ++sp) {
    const size_t off = (static_cast<size_t>(qi) * splits + sp) * k;
    for (int e0 = 0; e0 < k; e0 += 32) {
      const int e = e0 + lane;
      bool ok = e < k;
      const float v = ok ? part_v[off + e] : -CUDART_INF_F;
      const int i = ok ? part_i[off + e] : NO_ROW;
      ok = ok && better(v, i, lv[k - 1], li[k - 1]);
      // a partial list is sorted: once a batch holds no survivor, the rest hold none
      if (!__any_sync(FULL, ok)) break;
      warp_merge<KL>(lv, li, k, v, i, ok, tmp_v[w], tmp_i[w], lane);
    }
  }
  for (int e = lane; e < k; e += 32) {
    out_v[static_cast<size_t>(qi) * k + e] = lv[e];
    out_i[static_cast<size_t>(qi) * k + e] = li[e];
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (rows, D) float32 row-major matrix read in (box_rows, 32) boxes,
// 128-byte swizzled, zeros past its edges
bool make_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {DK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int N, int KL>
int launch_partial(const CUtensorMap& g, const CUtensorMap& qh, const CUtensorMap& ql,
                   float* pv, int* pi, int Q, int G, int D, int k, int rows_per_split,
                   int splits, cudaStream_t st) {
  const size_t bytes = Smem<N>::bytes(k);
  static size_t allowed[64] = {};  // per device: the block's shared memory, raised once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(topk_partial_kernel<N, KL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev] = bytes;
  }
  const dim3 grid((Q + N - 1) / N, splits);
  topk_partial_kernel<N, KL><<<grid, THREADS, bytes, st>>>(g, qh, ql, pv, pi, Q, G, D, k,
                                                           rows_per_split, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int KL>
int launch_merge(const float* pv, const int* pi, float* ov, int* oi, int Q, int splits, int k,
                 cudaStream_t st) {
  topk_merge_kernel<KL><<<(Q + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, st>>>(
      pv, pi, ov, oi, Q, splits, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Queries per block of kernel A for this k (the lists live in shared memory).
int gallery_topk_query_tile(int k) { return k <= 16 ? 128 : k <= 128 ? 64 : 32; }

// Launches kernels S, A and B on `stream`. q_hi / q_lo: scratch of Q_rows * D
// floats each, Q_rows >= max(Q, the query tile); part_v / part_i:
// Q * splits * k entries; rows_per_split is a multiple of 128 and splits *
// rows_per_split covers G. D % 4 == 0, D >= 32; the gallery holds max(G, 128)
// rows (rows past G are never read as results). Returns a cudaError_t (0 = ok).
int gallery_topk_launch(const void* queries, void* q_hi, void* q_lo, const void* gallery,
                        void* part_v, void* part_i, void* out_v, void* out_i, int Q,
                        int Q_rows, int G, int D, int k, int rows_per_split, int splits,
                        void* stream) {
  const int N = gallery_topk_query_tile(k);
  if (k < 1 || k > MAX_K || k > G || D < DK || D % 4 != 0 || Q_rows < N ||
      Q_rows < Q || rows_per_split % GT != 0 ||
      static_cast<long long>(splits) * rows_per_split < G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(Q_rows) * D;
  const int split_blocks = static_cast<int>((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  split_kernel<<<split_blocks, 256, 0, st>>>(static_cast<const float*>(queries),
                                             static_cast<float*>(q_hi), static_cast<float*>(q_lo),
                                             static_cast<size_t>(Q) * D, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap gmap, qhmap, qlmap;
  if (!make_map(&gmap, gallery, G < GT ? GT : G, D, GT) || !make_map(&qhmap, q_hi, Q_rows, D, N) ||
      !make_map(&qlmap, q_lo, Q_rows, D, N))
    return static_cast<int>(cudaErrorInvalidResourceHandle);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  int rc;
  if (k <= 16)
    rc = launch_partial<128, 1>(gmap, qhmap, qlmap, pv, pi, Q, G, D, k, rows_per_split, splits, st);
  else if (k <= 32)
    rc = launch_partial<64, 1>(gmap, qhmap, qlmap, pv, pi, Q, G, D, k, rows_per_split, splits, st);
  else if (k <= 128)
    rc = launch_partial<64, 4>(gmap, qhmap, qlmap, pv, pi, Q, G, D, k, rows_per_split, splits, st);
  else
    rc = launch_partial<32, 16>(gmap, qhmap, qlmap, pv, pi, Q, G, D, k, rows_per_split, splits, st);
  if (rc != 0) return rc;
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  if (k <= 32) return launch_merge<1>(pv, pi, ov, oi, Q, splits, k, st);
  if (k <= 128) return launch_merge<4>(pv, pi, ov, oi, Q, splits, k, st);
  return launch_merge<16>(pv, pi, ov, oi, Q, splits, k, st);
}

const char* gallery_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
