// Face-alignment warp for Hopper (sm_90a), x-major window: the mip pyramid of
// each frame, then per face its table and a bilinear resample to 112x112x3
// crops, with a fused normalize epilogue and a skip for empty face slots.
//
// Replaces the TPU kernel facerecognizeonnx_tpu/ops/warp_pallas.py::_kernel_xm
// together with the device work of _warp_affine_pallas_xm that precedes it (the
// pyramid build_pyramid_xm and the per-face level / window / fixed-point
// table). Plain-torch versions of the same functions, in
// ops/warp_cuda.py: build_pyramid_reference, face_params_xm and
// resample_xm_reference (warp_affine_xm_reference for the whole).
//
// What bounds it on this card: bytes. The pyramid reads each frame once and
// writes levels 1-3 (a quarter of that again); the resample reads at most
// the 2x2 taps of each output pixel inside a uint8 window and writes 4 (f32)
// or 2 (bf16) bytes per output value; both do a few dozen flops per byte.
// Before this design the launches around the kernel cost most: the table was
// ~50 eager torch launches and the pyramid ~15, 20-30x the kernel itself.
//
// What the design does about it: two launches per call.
//   - pyramid_kernel: one block per 64x64 level-0 tile of one frame. The tile
//     comes into shared memory with 16-byte loads where the rows are 16-byte
//     aligned (byte loads otherwise); the block reduces it to its 32x32, 16x16
//     and 8x8 tiles of levels 1-3 in shared memory (exact float sums of the
//     unrounded level below, rintf for the stored uint8) and writes levels
//     1-3 only. Level 0 is never copied: the resample reads the frames.
//   - warp_xm_kernel: one block per face x band of 16 output rows. Thread 0
//     computes the face's table from its forward affine in the float32
//     operations of face_params_xm, in the same order (_rn intrinsics, so no
//     FMA contraction; log2f, ceilf, exp2f, floorf, rintf; NaN kept or
//     mapped as torch does), and the first band writes it out so that the
//     card can hold it against face_params_xm bit for bit. The block then
//     bounds the band's taps (the source coordinates are monotone in the
//     pixel index, so the four corners bound them), stages that box of the
//     window into shared memory with 16-byte cp.async copies, gathers the
//     2x2 taps from there, and writes 8 consecutive pixels per thread with
//     16-byte stores. A box larger than the shared-memory budget (only for
//     faces far beyond level-3 coverage) is gathered from device memory
//     instead, with the same arithmetic.
//   The staging copies whole aligned 16-byte chunks, so they may read up to
//   15 bytes either side of a window row: always inside the tensor's
//   allocation, whose base and size the allocator aligns to 512 bytes.
//
// Numerics follow the TPU kernel exactly: window-local coordinates
// lx = a*j + b*i + tx, ly = c*j + d*i + ty clipped to [-2, 129] x [-2, 257];
// y hat weights rounded to bf16, x hat weights in f32; taps outside the
// 128(x) x 256(y) window or past the level's edge read zero;
// out = sum_x xw * (sum_y yw * pix), f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "face_table.cuh"

namespace {

constexpr int OUT = 112;
constexpr int PIX = OUT * OUT;
constexpr int WIN_X = 128;
constexpr int WIN_Y = 256;
constexpr int N_PARAMS = 9;
constexpr int BAND = 16;                  // output rows per block
constexpr int N_BANDS = OUT / BAND;       // 7
constexpr int PX_PER_THREAD = 8;          // consecutive pixels of one row
constexpr int GROUPS_PER_ROW = OUT / PX_PER_THREAD;  // 14
constexpr int WARP_THREADS = BAND * GROUPS_PER_ROW;  // 224
constexpr int STAGE_BYTES = 64 * 1024;    // window box budget in shared memory
constexpr int PYR_TILE = 64;
constexpr int PYR_THREADS = 256;
// launches so far of pyramid_kernel [0] and warp_xm_kernel [1], each counted
// once by its first block (read by warp_xm_launch_counts), so a run can see
// the launches that a CUDA-graph replay makes without Python
__device__ unsigned long long g_launches[2];

// ------------------------------------------------------------ the face table

using face_table::nan_clamp;

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}
// the fixed point of face_params_xm: every step is exact in f32
__device__ __forceinline__ float fixed(float v, float scale, float lim) {
  v = nan_clamp(nan_to_num(v), -lim, lim);
  return __fmul_rn(rintf(__fmul_rn(v, scale)), 1.0f / scale);
}

// ops/warp_cuda.py::face_params_xm on one face: M is the forward (2, 3)
// affine, row-major (the shared part in face_table.cuh).
__device__ void face_table(const float* M, float* t) {
  const face_table::Scaled f = face_table::scaled_inverse(M);
  const float x_lo = face_table::origin(f.x_min, 16.0f, 528.0f);
  const float y_lo = face_table::origin(f.y_min, 128.0f, 512.0f);
  t[0] = f.level;
  t[1] = x_lo;
  t[2] = y_lo;
  t[3] = fixed(f.a, 1048576.0f, 2000.0f);
  t[4] = fixed(f.b, 1048576.0f, 2000.0f);
  t[5] = fixed(f.c, 1048576.0f, 2000.0f);
  t[6] = fixed(f.d, 1048576.0f, 2000.0f);
  t[7] = fixed(__fsub_rn(f.tx, x_lo), 65536.0f, 30000.0f);
  t[8] = fixed(__fsub_rn(f.ty, y_lo), 65536.0f, 30000.0f);
}

// ------------------------------------------------------------ the pyramid

// one block: the 64x64 level-0 tile (blockIdx.x, blockIdx.y) of frame
// blockIdx.z → its 32x32, 16x16 and 8x8 tiles of levels 1-3
__global__ void __launch_bounds__(PYR_THREADS)
pyramid_kernel(const uint8_t* __restrict__ frames, uint8_t* __restrict__ upper, int H,
               int W, size_t upper_bytes, int aligned16) {
  __shared__ __align__(16) uint8_t l0[PYR_TILE][PYR_TILE * 3];
  __shared__ float l1[32][32 * 3];
  __shared__ float l2[16][16 * 3];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * PYR_TILE, x0 = blockIdx.x * PYR_TILE;
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && b == 0)
    atomicAdd(&g_launches[0], 1ULL);
  const int rows = min(PYR_TILE, H - y0), cols = min(PYR_TILE, W - x0);
  const uint8_t* src = frames + (static_cast<size_t>(b) * H + y0) * W * 3 + x0 * 3;
  const int row_bytes = cols * 3;
  if (aligned16) {  // W % 16 == 0: every tile row starts and ends 16-byte aligned
    const int chunks = row_bytes / 16;
    for (int e = threadIdx.x; e < rows * chunks; e += PYR_THREADS) {
      const int r = e / chunks, k = e % chunks;
      *reinterpret_cast<uint4*>(&l0[r][k * 16]) =
          __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * W * 3) + k);
    }
  } else {
    for (int e = threadIdx.x; e < rows * row_bytes; e += PYR_THREADS) {
      const int r = e / row_bytes, k = e % row_bytes;
      l0[r][k] = src[static_cast<size_t>(r) * W * 3 + k];
    }
  }
  __syncthreads();

  uint8_t* dst = upper + static_cast<size_t>(b) * upper_bytes;
  // level l: (H >> l) x (W >> l); this tile's part starts at (y0 >> l, x0 >> l)
  int h1 = H >> 1, w1 = W >> 1, h2 = H >> 2, w2 = W >> 2, h3 = H >> 3, w3 = W >> 3;
  const size_t off2 = static_cast<size_t>(h1) * w1 * 3;
  const size_t off3 = off2 + static_cast<size_t>(h2) * w2 * 3;

  for (int e = threadIdx.x; e < 32 * 32 * 3; e += PYR_THREADS) {
    const int i = e / 96, r = e % 96, j = r / 3, ch = r % 3;
    const float s = (static_cast<float>(l0[2 * i][6 * j + ch]) + l0[2 * i][6 * j + 3 + ch]) +
                    (static_cast<float>(l0[2 * i + 1][6 * j + ch]) + l0[2 * i + 1][6 * j + 3 + ch]);
    const float v = s * 0.25f;  // exact
    l1[i][r] = v;
    const int gi = (y0 >> 1) + i, gj = (x0 >> 1) + j;
    if (gi < h1 && gj < w1)
      dst[(static_cast<size_t>(gi) * w1 + gj) * 3 + ch] = static_cast<uint8_t>(rintf(v));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * 16 * 3; e += PYR_THREADS) {
    const int i = e / 48, r = e % 48, j = r / 3, ch = r % 3;
    const float v = ((l1[2 * i][6 * j + ch] + l1[2 * i][6 * j + 3 + ch]) +
                     (l1[2 * i + 1][6 * j + ch] + l1[2 * i + 1][6 * j + 3 + ch])) * 0.25f;
    l2[i][r] = v;
    const int gi = (y0 >> 2) + i, gj = (x0 >> 2) + j;
    if (gi < h2 && gj < w2)
      dst[off2 + (static_cast<size_t>(gi) * w2 + gj) * 3 + ch] = static_cast<uint8_t>(rintf(v));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 8 * 8 * 3; e += PYR_THREADS) {
    const int i = e / 24, r = e % 24, j = r / 3, ch = r % 3;
    const float v = ((l2[2 * i][6 * j + ch] + l2[2 * i][6 * j + 3 + ch]) +
                     (l2[2 * i + 1][6 * j + ch] + l2[2 * i + 1][6 * j + 3 + ch])) * 0.25f;
    const int gi = (y0 >> 3) + i, gj = (x0 >> 3) + j;
    if (gi < h3 && gj < w3)
      dst[off3 + (static_cast<size_t>(gi) * w3 + gj) * 3 + ch] = static_cast<uint8_t>(rintf(v));
  }
}

// ------------------------------------------------------------ the resample

__device__ __forceinline__ float hat(float l, float x) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(l, x))));
}

__device__ __forceinline__ float coord(float p, float q, float j, float i, float t) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p, j), __fmul_rn(q, i)), t);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

struct Face {
  float a, b, c, d, tx, ty;
  int x_lo, y_lo, hl, wl;
  const uint8_t* base;  // the face's level in device memory
};

template <bool kEpilogue>
__global__ void __launch_bounds__(WARP_THREADS)
warp_xm_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ upper,
               const float* __restrict__ Ms, const uint8_t* __restrict__ valid,
               void* __restrict__ out, float* __restrict__ table, int K, int H, int W,
               float mean, float inv_scale) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ float prm[N_PARAMS];
  __shared__ int box[6];  // x0, y0, row stride, rows, staged (0/1), row bytes
  __shared__ int rowoff[WIN_Y];
  const int n = blockIdx.y;
  const int band = blockIdx.x;
  const bool live = valid == nullptr || valid[n] != 0;

  if (threadIdx.x == 0) {
    if (n == 0 && band == 0) atomicAdd(&g_launches[1], 1ULL);
    float t[N_PARAMS];
    face_table(Ms + static_cast<size_t>(n) * 6, t);
#pragma unroll
    for (int k = 0; k < N_PARAMS; ++k) prm[k] = t[k];
    if (band == 0) {
#pragma unroll
      for (int k = 0; k < N_PARAMS; ++k) table[static_cast<size_t>(n) * N_PARAMS + k] = t[k];
    }
  }
  __syncthreads();

  Face f;
  f.a = prm[3]; f.b = prm[4]; f.c = prm[5]; f.d = prm[6]; f.tx = prm[7]; f.ty = prm[8];
  const int level = face_table::to_int(prm[0], 0, 3);
  f.x_lo = face_table::to_int(prm[1], 0, 528);
  f.y_lo = face_table::to_int(prm[2], 0, 512);
  f.hl = H >> level;
  f.wl = W >> level;
  size_t off = 0;
  for (int l = 1; l < level; ++l) off += static_cast<size_t>(H >> l) * (W >> l) * 3;
  size_t upper_bytes = 0;
  for (int l = 1; l < 4; ++l) upper_bytes += static_cast<size_t>(H >> l) * (W >> l) * 3;
  const int b = n / K;
  f.base = level == 0 ? frames + static_cast<size_t>(b) * H * W * 3
                      : upper + static_cast<size_t>(b) * upper_bytes + off;
  const int i0 = band * BAND;

  if (live) {
    if (threadIdx.x == 0) {
      // the band's taps lie in the box spanned by its four corners
      float lx_lo = 1e30f, lx_hi = -1e30f, ly_lo = 1e30f, ly_hi = -1e30f;
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int cj = 0; cj < 2; ++cj) {
          const float fi = static_cast<float>(i0 + ci * (BAND - 1));
          const float fj = static_cast<float>(cj * (OUT - 1));
          const float lx = fminf(fmaxf(coord(f.a, f.b, fj, fi, f.tx), -2.0f), WIN_X + 1.0f);
          const float ly = fminf(fmaxf(coord(f.c, f.d, fj, fi, f.ty), -2.0f), WIN_Y + 1.0f);
          lx_lo = fminf(lx_lo, lx); lx_hi = fmaxf(lx_hi, lx);
          ly_lo = fminf(ly_lo, ly); ly_hi = fmaxf(ly_hi, ly);
        }
      const int x0 = max(0, static_cast<int>(floorf(lx_lo)));
      const int x1 = min(min(WIN_X - 1, f.wl - 1 - f.x_lo), static_cast<int>(floorf(lx_hi)) + 1);
      const int y0 = max(0, static_cast<int>(floorf(ly_lo)));
      const int y1 = min(min(WIN_Y - 1, f.hl - 1 - f.y_lo), static_cast<int>(floorf(ly_hi)) + 1);
      const int rows = y1 >= y0 && x1 >= x0 ? y1 - y0 + 1 : 0;
      const int stride = ((x1 - x0 + 1) * 3 + 15 + 15) / 16 * 16;
      box[0] = x0; box[1] = y0; box[2] = stride; box[3] = rows;
      box[4] = rows * stride <= STAGE_BYTES;
      box[5] = (x1 - x0 + 1) * 3;
    }
    __syncthreads();
    const int x0 = box[0], y0 = box[1], stride = box[2], rows = box[3];
    if (box[4] && rows > 0) {
      const int chunks = stride / 16;
      const int row_bytes = box[5];
      for (int r = threadIdx.x; r < rows; r += WARP_THREADS) {
        const uint8_t* g = f.base + (static_cast<size_t>(f.y_lo + y0 + r) * f.wl + f.x_lo + x0) * 3;
        rowoff[r] = r * stride + static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15) - x0 * 3;
      }
      for (int e = threadIdx.x; e < rows * chunks; e += WARP_THREADS) {
        const int r = e / chunks, k = e % chunks;
        const uint8_t* g = f.base + (static_cast<size_t>(f.y_lo + y0 + r) * f.wl + f.x_lo + x0) * 3;
        const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
        if (16 * k < phase + row_bytes)  // the chunk holds a byte of the row
          cp_async16(stage + r * stride + 16 * k, g - phase + 16 * k);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
  }

  // this thread: 8 consecutive pixels of one row of the band
  const int i = i0 + threadIdx.x / GROUPS_PER_ROW;
  const int j0 = (threadIdx.x % GROUPS_PER_ROW) * PX_PER_THREAD;
  float s[PX_PER_THREAD][3];
#pragma unroll
  for (int p = 0; p < PX_PER_THREAD; ++p) s[p][0] = s[p][1] = s[p][2] = 0.0f;

  if (live) {
    const bool staged = box[4] != 0;
    const int y0 = box[1];
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p) {
      const float fj = static_cast<float>(j0 + p);
      const float lx = fminf(fmaxf(coord(f.a, f.b, fj, fi, f.tx), -2.0f), WIN_X + 1.0f);
      const float ly = fminf(fmaxf(coord(f.c, f.d, fj, fi, f.ty), -2.0f), WIN_Y + 1.0f);
      const int xf = static_cast<int>(floorf(lx));
      const int yf = static_cast<int>(floorf(ly));
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xw = xf + dx;
        if (xw < 0 || xw >= WIN_X || f.x_lo + xw >= f.wl) continue;
        const float wx = hat(lx, static_cast<float>(xw));
        float t[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int yw = yf + dy;
          if (yw < 0 || yw >= WIN_Y || f.y_lo + yw >= f.hl) continue;
          const float wy =
              __bfloat162float(__float2bfloat16_rn(hat(ly, static_cast<float>(yw))));
          const uint8_t* px =
              staged ? stage + rowoff[yw - y0] + xw * 3
                     : f.base + (static_cast<size_t>(f.y_lo + yw) * f.wl + f.x_lo + xw) * 3;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            t[ch] = __fadd_rn(t[ch], __fmul_rn(wy, static_cast<float>(px[ch])));
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) s[p][ch] = __fadd_rn(s[p][ch], __fmul_rn(t[ch], wx));
      }
    }
  }

  const size_t o = (static_cast<size_t>(n) * PIX + static_cast<size_t>(i) * OUT + j0) * 3;
  if (kEpilogue) {
    // embed-ready RGB: channel 2-c, (s - mean) / scale, bf16; 48 bytes
    __align__(16) __nv_bfloat16 y[PX_PER_THREAD * 3];
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = __fmul_rn(__fsub_rn(s[p][ch], mean), inv_scale);
        y[p * 3 + 2 - ch] = __float2bfloat16_rn(live ? v : 0.0f);
      }
    uint4* dst = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o);
    const uint4* v = reinterpret_cast<const uint4*>(y);
#pragma unroll
    for (int q = 0; q < 3; ++q) dst[q] = v[q];
  } else {
    __align__(16) float y[PX_PER_THREAD * 3];  // 96 bytes
#pragma unroll
    for (int p = 0; p < PX_PER_THREAD; ++p)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) y[p * 3 + ch] = s[p][ch];
    uint4* dst = reinterpret_cast<uint4*>(static_cast<float*>(out) + o);
    const uint4* v = reinterpret_cast<const uint4*>(y);
#pragma unroll
    for (int q = 0; q < 6; ++q) dst[q] = v[q];
  }
}

}  // namespace

extern "C" {

// Levels 1-3 of B frames of H x W into `upper` ((B, P) uint8, P the bytes of
// levels 1-3 per frame), on `stream`. Returns a cudaError_t (0 = ok).
int pyramid_launch(const void* frames, void* upper, int B, int H, int W, void* stream) {
  size_t upper_bytes = 0;
  for (int l = 1; l < 4; ++l) upper_bytes += static_cast<size_t>(H >> l) * (W >> l) * 3;
  const dim3 grid((W + PYR_TILE - 1) / PYR_TILE, (H + PYR_TILE - 1) / PYR_TILE, B);
  const int aligned16 = (W % 16 == 0) && (reinterpret_cast<uintptr_t>(frames) % 16 == 0);
  pyramid_kernel<<<grid, PYR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<uint8_t*>(upper), H, W, upper_bytes,
      aligned16);
  return static_cast<int>(cudaGetLastError());
}

// The resample of n_faces = B * K faces: frames (level 0), upper (levels
// 1-3, as pyramid_launch writes them), Ms (n_faces, 2, 3) forward affines,
// valid (n_faces uint8 or null) → out (n_faces, 112, 112, 3) f32, or bf16
// with the epilogue, and table (n_faces, 9) f32. Returns a cudaError_t.
int warp_xm_launch(const void* frames, const void* upper, const void* Ms, const void* valid,
                   void* out, void* table, int n_faces, int K, int H, int W, int epilogue,
                   float mean, float inv_scale, void* stream) {
  static bool configured[64] = {};  // per device: the staging budget, raised once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !configured[dev]) {
    e = cudaFuncSetAttribute(warp_xm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STAGE_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(warp_xm_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid(N_BANDS, n_faces);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* fr = static_cast<const uint8_t*>(frames);
  const uint8_t* up = static_cast<const uint8_t*>(upper);
  const float* ms = static_cast<const float*>(Ms);
  const uint8_t* val = static_cast<const uint8_t*>(valid);
  float* tab = static_cast<float*>(table);
  if (epilogue)
    warp_xm_kernel<true><<<grid, WARP_THREADS, STAGE_BYTES, st>>>(fr, up, ms, val, out, tab, K,
                                                                   H, W, mean, inv_scale);
  else
    warp_xm_kernel<false><<<grid, WARP_THREADS, STAGE_BYTES, st>>>(fr, up, ms, val, out, tab, K,
                                                                    H, W, mean, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

// out[0], out[1]: the launches of pyramid_kernel and warp_xm_kernel on the
// current device so far (a synchronous copy: for checks outside timed work).
// Returns a cudaError_t.
int warp_xm_launch_counts(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches)));
}

const char* warp_xm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
