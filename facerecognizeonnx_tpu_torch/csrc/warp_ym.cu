// Face-alignment warp for Hopper (sm_90a), y-major window: per face its table
// from the forward affine, then a bilinear resample of the mip pyramid to
// 112x112x3 raw BGR crops (float32). Level 0 is read from the frames, levels
// 1-3 from the pyramid launch of csrc/warp_xm.cu, which both layouts share.
//
// Replaces the TPU kernel facerecognizeonnx_tpu/ops/warp_pallas.py::_kernel
// (the y-major v3a layout) together with the device work of its driver
// warp_affine_pallas(layout="ymajor") that precedes it (the inverse affine,
// the level, the window origin and the float32 table). Plain-torch versions
// of the same functions, in ops/warp_cuda.py: face_params_ym and
// resample_ym_reference (warp_affine_ym_reference for the whole).
//
// What bounds it on this card: bytes, then the instructions of one face. The
// output is 112^2 x 3 float32 per face (147 KB, 19.3 MB at B=16, K=8), the
// distinct taps about a tenth of that; ~120 instructions per output pixel.
// Before this design the launches around the kernel cost most: the table was
// ~50 eager torch launches before every resample launch. A face's table is
// computed once, so a face stays on one block and one SM: at B=16, K=8, 128
// faces on 132 SMs, each SM resamples one face, and the time is that of the
// slowest face.
//
// What the design does about it: one launch, table included.
//   - Grid: max(min(N, SMs), ceil(N / 32)) blocks of 896 threads, one block
//     per SM; block g owns the faces g, g + grid, ... (at most 32). Lane s of
//     warp 0 computes the table of the block's face s, all lanes at once, in
//     the float32 operations of face_params_ym (face_table.cuh, then the
//     128 (x) / 16 (y) origin), and writes it out once, so that the card can
//     hold it against face_params_ym bit for bit; then warp w computes the
//     box of band w of every owned face, lane s face s.
//   - A face is 14 bands of 8 output rows; a block walks its faces' bands as
//     one sequence of units, dealt to 4 teams of 224 threads (team m takes
//     units m, m + 4, ...; each team syncs on its own named barrier). A unit's
//     taps lie in the box spanned by its band's four corners (the source
//     coordinates are monotone in the pixel index). The box is staged into
//     shared memory with 16-byte cp.async copies from 16-byte-aligned starts,
//     sized to the box, in a ring of three 16 KB buffers per team: the team's
//     next unit is in flight while this one is gathered and stored (the next
//     face's first band included), and one barrier per unit suffices. At its
//     level a face spans at most 110 px, so an 8-row band's box is at most
//     ~61 x 61 px for a similarity (~11 KB with its alignment slack), ~113 x
//     10 px upright (~4 KB). A box over 16 KB (faces far beyond level-3
//     coverage, strong shears) is gathered from device memory instead, with
//     the same arithmetic.
//   - Thread (r, g) of a unit computes the 4 consecutive pixels 4g..4g+3 of
//     the band's row r and writes them as three aligned 16-byte stores (48
//     bytes; a 112-pixel row is 28 such groups). A tap row (both x taps, 6
//     bytes) is three aligned 32-bit shared loads and two funnel shifts; a
//     byte becomes 2^23 + byte by one byte permute, and one FMA with -w * 2^23
//     gives w * byte exactly, so the y products cost no conversion.
//   - Bytes in flight: 4 teams x a 2-11 KB box in flight, beside 4 x 10.5 KB
//     of stores per unit, per SM; across 128 SMs ~3-7 MB, above the ~1.6 MB
//     that ~1 us of latency needs at 1.6 TB/s. Registers (<= 72 a thread at
//     896 threads) and the ring (192 KB) allow one block per SM.
//   The staging copies whole aligned 16-byte chunks, so they may read up to
//   15 bytes either side of a window row: always inside the tensor's
//   allocation, whose base and size the allocator aligns to 512 bytes. The
//   word loads of an edge tap may read up to 12 bytes past a staged row, or 8
//   before it: into the row's slack, the next buffer, or the 16 bytes of
//   slack at either end of the ring; a byte that is not a tap of the box is
//   never used.
//
// Numerics follow the TPU kernel (run by the JAX package in interpret mode on
// the CPU), with no FMA contraction (the _rn intrinsics):
//   - the table: face_params_ym's nine columns (level, x_lo, y_lo, a, b, c,
//     d, tx - x_lo, ty - y_lo), float32, no fixed point, NaN kept as torch
//     keeps it; x_lo = clip(floor(x_min/128)*128, 0, 512), y_lo =
//     clip(floor(y_min/16)*16, 0, 528). The origin is part of the result:
//     taps outside the window read zero;
//   - lx = a*j + b*i + tx, ly = c*j + d*i + ty, clipped to [-2, 257] (x) and
//     [-2, 129] (y); taps outside the 256(x) x 128(y) window, or past the
//     level's edge, read zero (a zero tap adds an exact +0, and the first
//     add of each sum, to 0, is left out: it is exact);
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

#include "face_table.cuh"

namespace {

constexpr int OUT = 112;
constexpr int PIX = OUT * OUT;
constexpr int WIN_X = 256;
constexpr int WIN_Y = 128;
constexpr int N_PARAMS = 9;
constexpr int BAND = 8;                       // output rows per unit
constexpr int N_BANDS = OUT / BAND;           // 14
constexpr int PX = 4;                         // consecutive pixels per thread: 48 bytes
constexpr int PER_ROW = OUT / PX;             // 28 threads per row
constexpr int TEAM = BAND * PER_ROW;          // 224 threads: one unit
constexpr int TEAMS = 4;                      // units in flight per block
constexpr int THREADS = TEAM * TEAMS;         // 896
constexpr int MAX_FACES = 32;                 // per block: one lane each
constexpr int STAGE_BYTES = 16 * 1024;        // one unit's box
constexpr int RING = 3;                       // boxes per team: computed, landed, in flight
constexpr int SLACK = 16;                     // word loads of an edge tap
constexpr int SMEM_BYTES = SLACK + TEAMS * RING * STAGE_BYTES + SLACK;
constexpr float STAGE_COEF_MAX = 1e30f;       // larger coefficients: not staged

struct Face {
  float a, b, c, d, tx, ty;
  int x_lo, y_lo, hl, wl;
  int stageable;          // coordinates finite and monotone (no inf, no NaN)
  const uint8_t* base;    // the face's level in device memory
};

struct Box {
  int x0, y0, rows, stride, row_bytes, staged;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The hat weights of the taps floor(l) and floor(l) + 1, as the reference
// computes max(0, 1 - |l - x|): f = l - floor(l) (exact but for l in (-1, 0),
// where 1 - f is exact), h0 = 1 - f, and 1 - |round(f - 1)| = 1 - h0 (both
// >= 0, so the max is left out).
__device__ __forceinline__ void hats(float l, float fl, float& h0, float& h1) {
  h0 = __fsub_rn(1.0f, __fsub_rn(l, fl));
  h1 = __fsub_rn(1.0f, h0);
}

// 2^23 + byte k of w, as float32 (exact)
__device__ __forceinline__ float biased(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | k));
}

// w * byte, exactly: w * (2^23 + byte) - w * 2^23 (nw = -w * 2^23) is exact,
// and the FMA rounds it once; the product of a bf16 weight and a byte fits
// float32, so this is the reference's w * float(byte)
__device__ __forceinline__ float tap(float w, float nw, float b) { return __fmaf_rn(w, b, nw); }

// an integral float in (-2^22, 2^22) as int, on the FMA pipe (no F2I)
__device__ __forceinline__ int int_of(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

__device__ __forceinline__ float coord(float p, float q, float j, float i, float t) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p, j), __fmul_rn(q, i)), t);
}

// one 16-byte store (p 16-byte aligned)
__device__ __forceinline__ void store16(float* p, float a, float b, float c, float d) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(a), "f"(b), "f"(c),
               "f"(d) : "memory");
}

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(TEAM) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// ops/warp_cuda.py::face_params_ym on one face (its table row), and the
// face's geometry as the resample uses it
__device__ Face fill_face(const float* M, float* row, const uint8_t* frames,
                          const uint8_t* upper, int frame, int H, int W) {
  const face_table::Scaled s = face_table::scaled_inverse(M);
  const float x_lo = face_table::origin(s.x_min, 128.0f, 512.0f);
  const float y_lo = face_table::origin(s.y_min, 16.0f, 528.0f);
  const float t[N_PARAMS] = {s.level, x_lo, y_lo, s.a, s.b, s.c, s.d,
                             __fsub_rn(s.tx, x_lo), __fsub_rn(s.ty, y_lo)};
#pragma unroll
  for (int k = 0; k < N_PARAMS; ++k) row[k] = t[k];

  Face f;
  f.a = t[3]; f.b = t[4]; f.c = t[5]; f.d = t[6]; f.tx = t[7]; f.ty = t[8];
  f.stageable = 1;
#pragma unroll
  for (int k = 3; k < N_PARAMS; ++k) f.stageable &= fabsf(t[k]) < STAGE_COEF_MAX;
  const int level = face_table::to_int(t[0], 0, 3);
  f.x_lo = face_table::to_int(t[1], 0, 512);
  f.y_lo = face_table::to_int(t[2], 0, 528);
  f.hl = H >> level;
  f.wl = W >> level;
  size_t off = 0, upper_bytes = 0;
  for (int l = 1; l < 4; ++l) {
    const size_t bytes = static_cast<size_t>(H >> l) * (W >> l) * 3;
    if (l < level) off += bytes;
    upper_bytes += bytes;
  }
  f.base = level == 0 ? frames + static_cast<size_t>(frame) * H * W * 3
                      : upper + static_cast<size_t>(frame) * upper_bytes + off;
  return f;
}

// the window box that holds every tap of the band's rows i0..i0+15
__device__ Box band_box(const Face& f, int i0) {
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
  Box bx;
  bx.x0 = max(0, static_cast<int>(floorf(lx_lo)));
  const int x1 = min(min(WIN_X - 1, f.wl - 1 - f.x_lo), static_cast<int>(floorf(lx_hi)) + 1);
  bx.y0 = max(0, static_cast<int>(floorf(ly_lo)));
  const int y1 = min(min(WIN_Y - 1, f.hl - 1 - f.y_lo), static_cast<int>(floorf(ly_hi)) + 1);
  bx.rows = y1 >= bx.y0 && x1 >= bx.x0 ? y1 - bx.y0 + 1 : 0;
  bx.row_bytes = (x1 - bx.x0 + 1) * 3;
  bx.stride = (bx.row_bytes + 15 + 15) / 16 * 16;  // the row and its phase
  bx.staged = f.stageable && bx.rows * bx.stride <= STAGE_BYTES;
  return bx;
}

// start the copies of a unit's box into stage[buf..] (one commit group per
// thread of the team; t: the thread's index in its team)
__device__ __forceinline__ void stage_box(const Face& f, const Box& bx, uint8_t* stage, int buf,
                                          int* rowoff, int t) {
  if (bx.staged && bx.rows > 0) {
    const int chunks = bx.stride / 16;
    for (int r = t; r < bx.rows; r += TEAM) {
      const uint8_t* g =
          f.base + (static_cast<size_t>(f.y_lo + bx.y0 + r) * f.wl + f.x_lo + bx.x0) * 3;
      rowoff[r] = buf + r * bx.stride + static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15) -
                  bx.x0 * 3;
    }
    for (int e = t; e < bx.rows * chunks; e += TEAM) {
      const int r = e / chunks, k = e % chunks;
      const uint8_t* g =
          f.base + (static_cast<size_t>(f.y_lo + bx.y0 + r) * f.wl + f.x_lo + bx.x0) * 3;
      const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
      if (16 * k < phase + bx.row_bytes)  // the chunk holds a byte of the row
        cp_async16(stage + buf + r * bx.stride + 16 * k, g - phase + 16 * k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the two x taps (xw, xw + 1) of one tap row, 3 channels each, as biased
// floats (2^23 + byte); a tap that is not ok reads 0. Staged: `o` is the byte
// offset of tap xw in `stage` (any offset inside it when neither tap is ok);
// three aligned words hold both taps. Else `g` is the tap in memory.
template <bool kStaged>
__device__ __forceinline__ void row_taps(const uint8_t* stage, int o, const uint8_t* g,
                                         bool ok0, bool ok1, float v[6]) {
  uint32_t lo0 = 0, lo1 = 0, hi1 = 0;
  if (kStaged) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(stage + (o & ~3));
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
    const uint32_t sh = (o & 3) * 8;
    const uint32_t lo = __funnelshift_r(w0, w1, sh), hi = __funnelshift_r(w1, w2, sh);
    lo0 = ok0 ? lo : 0u;
    lo1 = ok1 ? lo : 0u;
    hi1 = ok1 ? hi : 0u;
  } else {
    if (ok0) lo0 = g[0] | (g[1] << 8) | (g[2] << 16);
    if (ok1) {
      lo1 = static_cast<uint32_t>(g[3]) << 24;
      hi1 = g[4] | (g[5] << 8);
    }
  }
  v[0] = biased(lo0, 0); v[1] = biased(lo0, 1); v[2] = biased(lo0, 2);
  v[3] = biased(lo1, 3); v[4] = biased(hi1, 0); v[5] = biased(hi1, 1);
}

// this thread's 4 pixels of a unit (face f, band rows i0..): gather, x-pass,
// three 16-byte stores. t: the thread's index in its team.
template <bool kBf16, bool kStaged>
__device__ __forceinline__ void gather_band(const Face& f, const Box& bx, const uint8_t* stage,
                                            const int* rowoff, int i0, float* out, int t) {
  const int i = i0 + t / PER_ROW;
  const int j0 = (t % PER_ROW) * PX;
  const float fi = static_cast<float>(i), fj0 = static_cast<float>(j0);
  const float bi = __fmul_rn(f.b, fi), di = __fmul_rn(f.d, fi);  // shared by the row
  const uint32_t x_max = max(0, min(WIN_X, f.wl - f.x_lo));       // taps xw < x_max are in
  const uint32_t y_max = max(0, min(WIN_Y, f.hl - f.y_lo));
  float y[PX * 3];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const float fj = fj0 + static_cast<float>(p);
    const float lx =
        fminf(fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(f.a, fj), bi), f.tx), -2.0f), WIN_X + 1.0f);
    const float ly =
        fminf(fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(f.c, fj), di), f.ty), -2.0f), WIN_Y + 1.0f);
    const float xl = floorf(lx), yl = floorf(ly);
    const int xf = int_of(xl), yf = int_of(yl);
    const bool ok0 = static_cast<uint32_t>(xf) < x_max;
    const bool ok1 = static_cast<uint32_t>(xf + 1) < x_max;
    float v[2][6];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yw = yf + dy;
      const bool yok = static_cast<uint32_t>(yw) < y_max;
      if (kStaged) {
        const int o = yok && (ok0 || ok1) ? rowoff[yw - bx.y0] + xf * 3 : 0;
        row_taps<true>(stage, o, nullptr, ok0 && yok, ok1 && yok, v[dy]);
      } else {
        const uint8_t* g =
            f.base + (static_cast<size_t>(f.y_lo + (yok ? yw : 0)) * f.wl + f.x_lo + xf) * 3;
        row_taps<false>(nullptr, 0, g, ok0 && yok, ok1 && yok, v[dy]);
      }
    }
    float wx0, wx1, hy0, hy1;
    hats(lx, xl, wx0, wx1);
    hats(ly, yl, hy0, hy1);
    const float wy0 = bf16_round(hy0), wy1 = bf16_round(hy1);
    const float nwy0 = __fmul_rn(wy0, -8388608.0f), nwy1 = __fmul_rn(wy1, -8388608.0f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // t = 0 + wy0 * p + wy1 * p' and s = 0 + x-tap + x-tap: each first add of
      // 0 to a product >= +0 is exact, so it is left out
      const float t0 = __fadd_rn(tap(wy0, nwy0, v[0][ch]), tap(wy1, nwy1, v[1][ch]));
      const float t1 = __fadd_rn(tap(wy0, nwy0, v[0][3 + ch]), tap(wy1, nwy1, v[1][3 + ch]));
      float s;
      if (kBf16) {
        s = __fadd_rn(bf16_round(__fmul_rn(bf16_round(t0), bf16_round(wx0))),
                      bf16_round(__fmul_rn(bf16_round(t1), bf16_round(wx1))));
        s = bf16_round(s);
      } else {
        s = __fadd_rn(__fmul_rn(t0, wx0), __fmul_rn(t1, wx1));
      }
      y[p * 3 + ch] = s;
    }
  }
  float* dst = out + (static_cast<size_t>(i) * OUT + j0) * 3;
  store16(dst, y[0], y[1], y[2], y[3]);
  store16(dst + 4, y[4], y[5], y[6], y[7]);
  store16(dst + 8, y[8], y[9], y[10], y[11]);
}

template <bool kBf16>
__global__ void __launch_bounds__(THREADS, 1)
warp_ym_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ upper,
               const float* __restrict__ Ms, float* __restrict__ out,
               float* __restrict__ table, int n_faces, int K, int H, int W) {
  extern __shared__ __align__(16) uint8_t smem[];  // SLACK, TEAMS x 2 buffers, SLACK
  __shared__ Face faces[MAX_FACES];
  __shared__ Box boxes[MAX_FACES][N_BANDS];
  __shared__ int rowoff[TEAMS][RING][WIN_Y];
  uint8_t* stage = smem + SLACK;
  const int tid = threadIdx.x;
  const int grid = static_cast<int>(gridDim.x);
  const int owned = (n_faces - static_cast<int>(blockIdx.x) + grid - 1) / grid;

  // the tables of this block's faces, one lane each; then the boxes of their
  // bands, warp w band w
  if (tid < owned) {
    const int n = blockIdx.x + tid * grid;
    faces[tid] = fill_face(Ms + static_cast<size_t>(n) * 6,
                           table + static_cast<size_t>(n) * N_PARAMS, frames, upper, n / K, H,
                           W);
  }
  __syncthreads();
  if (tid / 32 < N_BANDS && tid % 32 < owned)
    boxes[tid % 32][tid / 32] = band_box(faces[tid % 32], (tid / 32) * BAND);
  __syncthreads();

  // units u = (face u / 14, band u % 14); team m takes u = m, m + 4, ...; its
  // next unit stages while u is computed, into the ring buffer of its unit
  // before last, which every team thread left before it passed the previous
  // iteration's barrier
  const int units = owned * N_BANDS;
  const int team = tid / TEAM, t = tid % TEAM;
  const int base = team * RING * STAGE_BYTES;
  stage_box(faces[0], boxes[0][team], stage, base, rowoff[team][0], t);
  for (int k = 0, u = team; u < units; ++k, u += TEAMS) {
    const int nu = u + TEAMS;
    if (nu < units) {
      const int b = (k + 1) % RING;
      stage_box(faces[nu / N_BANDS], boxes[nu / N_BANDS][nu % N_BANDS], stage,
                base + b * STAGE_BYTES, rowoff[team][b], t);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    team_sync(team);  // unit u's box has landed, from every team thread's copies

    const int slot = u / N_BANDS;
    const Face f = faces[slot];
    const Box bx = boxes[slot][u % N_BANDS];
    float* dst = out + static_cast<size_t>(blockIdx.x + slot * grid) * PIX * 3;
    const int i0 = (u % N_BANDS) * BAND;
    if (bx.staged)
      gather_band<kBf16, true>(f, bx, stage, rowoff[team][k % RING], i0, dst, t);
    else
      gather_band<kBf16, false>(f, bx, nullptr, nullptr, i0, dst, t);
  }
}

}  // namespace

extern "C" {

// The y-major warp of n_faces = B * K faces: frames (level 0), upper (levels
// 1-3, as warp_xm.cu's pyramid_launch writes them), Ms (n_faces, 2, 3)
// forward affines → out (n_faces, 112, 112, 3) f32 and table (n_faces, 9) f32,
// on `stream`. Returns a cudaError_t (0 = ok).
int warp_ym_launch(const void* frames, const void* upper, const void* Ms, void* out,
                   void* table, int n_faces, int K, int H, int W, int xpass_bf16,
                   void* stream) {
  static int sms[64] = {};  // per device: its SM count, and the shared memory raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int n_sms = dev < 64 ? sms[dev] : 0;
  if (n_sms == 0) {
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(warp_ym_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(warp_ym_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) sms[dev] = n_sms;
  }
  const int grid = max(min(n_faces, n_sms), (n_faces + MAX_FACES - 1) / MAX_FACES);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* fr = static_cast<const uint8_t*>(frames);
  const uint8_t* up = static_cast<const uint8_t*>(upper);
  const float* ms = static_cast<const float*>(Ms);
  float* o = static_cast<float*>(out);
  float* tab = static_cast<float*>(table);
  if (xpass_bf16)
    warp_ym_kernel<true><<<grid, THREADS, SMEM_BYTES, st>>>(fr, up, ms, o, tab, n_faces, K, H,
                                                            W);
  else
    warp_ym_kernel<false><<<grid, THREADS, SMEM_BYTES, st>>>(fr, up, ms, o, tab, n_faces, K, H,
                                                             W);
  return static_cast<int>(cudaGetLastError());
}

const char* warp_ym_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
