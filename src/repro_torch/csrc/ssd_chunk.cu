// Mamba2 SSD, intra-chunk part: per (batch, head, chunk) cell, the
// inclusive cumsum of dt * a, the chunk's output y_intra = (C B^T o decay)
// (dt x) and its state contribution state_c = (tail o dt x)^T B.  Built for
// sm_90a.
//
// Replaces: src/repro/kernels/ssd_chunk.py · ssd_chunk (_ssd_kernel); the
//   inter-chunk carry stays outside, as in the JAX package.  y_intra is
//   written in fp32 (the Pallas kernel writes x.dtype), because the path it
//   serves, ssd_chunked, keeps it in fp32 until its one final cast.
//
// What bounds it on the H100: bytes.  At Mamba2-2.7B's prefill (B 4, L 512,
//   80 heads of P 64, N 128, chunk 128, one group) one launch reads x, B
//   and C (bf16) and dt and writes y, state_c and cum in fp32, about 107
//   MB (84 of them written), against 5.3 MFLOP a cell over the causal
//   triangle (6.7 GFLOP a launch): 0.032 ms of bytes and 0.007 ms of bf16
//   tensor-core work.
//
// bf16 x, b and c (the main path): the tensor-core kernel ssd_tc_kernel.
//   A block of sixteen warps (enough to hide the latencies of its short
//   dependent phases) takes one (batch, chunk) and a run of its heads, the
//   run's length chosen so that the grid is about one wave.  C and B arrive
//   once a block; each head's x and dt arrive by 16-byte cp.async (element
//   loads where a pointer or stride is off 16 bytes) in a ring of two
//   stages, so the next head's tiles land during this head's products.
//   Tiles are zero-padded to 16 in shared memory.  cum is a warp scan, four
//   values a lane.  The products run on mma.sync m16n8k16 (bf16 in, fp32
//   accumulate):
//   * S = C B^T: C and B are exact bf16, so one product is at fp32
//     accuracy; only the 16 x 16 blocks on or below the diagonal, kept in
//     shared memory in fp32 as the accumulators hold them.  Where b's and
//     c's head strides are both 0 (one group) S does not depend on the
//     head and is computed once for the run; otherwise once a head, after
//     C and B of that head are loaded.  The sums are the same either way.
//   * y = W x with W_ij = S_ij (exp(cum_i - cum_j) dt_j) (j <= i): W is
//     built in fp32 a block and lane at a time, in the accumulators' order
//     (so a lane's values are its A fragment), split into bf16 terms (each
//     the residual rounded to nearest; two from chunk 64, three below) and
//     stored over C; x stays exact bf16 (B fragments by ldmatrix.trans).
//     Warp w takes row blocks r = w % 4 and R - 1 - r (R = chunk / 16), so
//     the causal triangle is balanced, over a quarter of P's columns.
//   * state_c = x'^T B with x'_j = tail_j dt_j x_j in fp32, split into
//     three bf16 terms staged in shared memory; B stays exact.  A warp
//     takes a tile of 16 rows of P by 32 columns of N.
//   The CPU emulation of this arithmetic (tests/test_torch_ssd_tc.py) at
//   Mamba2-2.7B's whole prefill shape lies within 0.11 (y) and 0.47
//   (state_c) of ref.ssd_chunk_limit, most of it the two sides' cum; two
//   terms of x' put state_c at 0.60 there (2.4x at chunk 16), two of W put
//   y at 0.77 at chunk 16, and one term of either lies far beyond the
//   limit.  expf as the plain version (the limit budgets exp's ulps, not
//   exp2f's error in |cum_i - cum_j|).  Outputs leave in fp32 by 16-byte
//   stores (lanes pair their accumulators by one shuffle) where the width
//   allows.  No atomics and no sum split across blocks: two calls give the
//   same bits.
//
// fp32 x, b and c (reduced configs and tests; no main path): the first
//   kernel, one block of 256 threads (a 16 x 16 grid) per cell.  The
//   block stages C and B (K x N), dt x (transposed, P x K) and dt / cum /
//   tail in shared memory as fp32, 166.5 KiB at the shapes above (199.5 KiB
//   at P = 128), so it opts in to more than 48 KB.  cum is a sequential
//   scan by one thread (K <= 128).  The three products are one routine:
//   each thread keeps an up-to 8 x 8 register tile of rows {ty + 16 r} and
//   columns {tx + 16 c} and walks the reduction axis four at a time with
//   float4 loads; both operands are stored reduction-axis innermost with a
//   row stride of an odd number of float4s, so a warp's float4 loads fall
//   in distinct bank groups.  C B^T is computed in registers for the tiles
//   on or below the diagonal (c <= r) only; after a barrier the
//   decay-masked G = C B^T o exp(cum_i - cum_j) [j <= i] overwrites B, and
//   B scaled by tail_j = exp(cum_last - cum_j) is re-read from device
//   memory (L2: all heads of a group share it) transposed over C.  Then y =
//   G (dt x) walks, for row tile r, only the reduction blocks j < 16 (r +
//   1), so the causal products cover j <= i and skip 28 of the 64 tiles
//   above the diagonal; state_c = (dt x)^T (tail B) is the full product.
//   The skipped terms are exact zeros of G, so the sums are those of the
//   full product.
//
// Both read b and c through (batch, position, head) strides, so a stride-0
// expand of the groups over the heads is never materialized.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "device_helpers.h"
#include "launch_args.h"

namespace {

constexpr int kTile = 16;                  // threads per side of the grid
constexpr int kThreads = kTile * kTile;
constexpr int kMaxDim = 128;               // chunk, P and N
constexpr int kMaxT = kMaxDim / kTile;     // register tile extent
constexpr size_t kMaxSmem = 232448;        // per block, H100

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
// Row stride of an operand whose rows hold `cols` (a multiple of 16) floats:
// cols / 4 + 1 float4s, an odd count, so neighbouring rows start in
// different 16-byte bank groups.
__host__ __device__ inline int row_stride(int cols) { return cols + 4; }

struct Layout {
  int kp, np, pp, sk, sn;
  size_t cum, tail, dts, r1, r2, xt, total;  // offsets / size, in floats
};

__host__ __device__ inline Layout make_layout(int k, int n, int p) {
  Layout s;
  s.kp = round16(k);
  s.np = round16(n);
  s.pp = round16(p);
  s.sk = row_stride(s.kp);
  s.sn = row_stride(s.np);
  const size_t c_rows = (size_t)s.kp * s.sn;        // C or B, (K, N)
  const size_t bt_rows = (size_t)s.np * s.sk;       // tail B^T, (N, K)
  const size_t g_rows = (size_t)s.kp * s.sk;        // G, (K, K)
  const size_t r1 = c_rows > bt_rows ? c_rows : bt_rows;   // C, then tail B^T
  const size_t r2 = c_rows > g_rows ? c_rows : g_rows;     // B, then G
  s.cum = 0;
  s.tail = s.kp;
  s.dts = 2 * s.kp;
  s.r1 = 3 * s.kp;
  s.r2 = s.r1 + r1;
  s.xt = s.r2 + r2;
  s.total = s.xt + (size_t)s.pp * s.sk;
  return s;
}

// Which (row tile r, column tile c, reduction block kb) terms a product
// takes: all of them, only c <= r (C B^T, whose tiles above the diagonal
// hold j > i), or only kb <= r (G (dt x), whose reduction blocks past the
// row tile meet G's zeros above the diagonal).
enum class Part { kFull, kLowerTiles, kCausalReduction };

// acc[r][c] = sum_k A[(ty + 16 r) * sa + k] * B[(tx + 16 c) * sb + k] over
// k in [0, kred), kred a multiple of 16, for r < mt and c < nt, restricted
// to the terms `P` names (the others are left 0).
template <Part P>
__device__ __forceinline__ void tile_gemm(const float* A, int sa, const float* B,
                                          int sb, int kred, int ty, int tx,
                                          int mt, int nt,
                                          float (&acc)[kMaxT][kMaxT]) {
#pragma unroll
  for (int r = 0; r < kMaxT; ++r)
#pragma unroll
    for (int c = 0; c < kMaxT; ++c) acc[r][c] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < kred; k += 4) {
    const int kb = k / kTile;            // 16-wide block of the reduction
    float4 av[kMaxT], bv[kMaxT];
#pragma unroll
    for (int r = 0; r < kMaxT; ++r)
      av[r] = (r < mt && (P != Part::kCausalReduction || kb <= r))
                  ? *reinterpret_cast<const float4*>(A + (ty + kTile * r) * sa + k)
                  : zero;
#pragma unroll
    for (int c = 0; c < kMaxT; ++c)
      bv[c] = c < nt ? *reinterpret_cast<const float4*>(B + (tx + kTile * c) * sb + k)
                     : zero;
#pragma unroll
    for (int r = 0; r < kMaxT; ++r) {
      if (P == Part::kCausalReduction && kb > r) continue;   // block-uniform
#pragma unroll
      for (int c = 0; c < kMaxT; ++c) {
        if (P == Part::kLowerTiles && c > r) continue;       // compile time
        float t = acc[r][c];
        t = fmaf(av[r].x, bv[c].x, t);
        t = fmaf(av[r].y, bv[c].y, t);
        t = fmaf(av[r].z, bv[c].z, t);
        t = fmaf(av[r].w, bv[c].w, t);
        acc[r][c] = t;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, long long xs_b, long long xs_l,
                 long long xs_h, const float* __restrict__ dt, long long ds_b,
                 long long ds_l, long long ds_h, const float* __restrict__ a,
                 const float* __restrict__ bm, long long bs_b, long long bs_l,
                 long long bs_h, const float* __restrict__ cm, long long cs_b,
                 long long cs_l, long long cs_h, float* __restrict__ y,
                 float* __restrict__ state, float* __restrict__ cum_out,
                 int seqlen, int heads, int p, int n, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout s = make_layout(chunk, n, p);
  float* cum = smem + s.cum;
  float* tail = smem + s.tail;
  float* dts = smem + s.dts;
  float* r1 = smem + s.r1;
  float* r2 = smem + s.r2;
  float* xt = smem + s.xt;

  const int nc = seqlen / chunk;
  const int ci = blockIdx.x % nc;
  const int bh = blockIdx.x / nc;
  const int h = bh % heads;
  const int b = bh / heads;
  const int l0 = ci * chunk;
  const int tid = threadIdx.x;
  const int ty = tid / kTile;
  const int tx = tid % kTile;
  const int kp = s.kp, np = s.np, pp = s.pp, sk = s.sk, sn = s.sn;

  for (int j = tid; j < kp; j += kThreads)
    dts[j] = j < chunk ? dt[b * ds_b + (l0 + j) * ds_l + h * ds_h] : 0.f;
  __syncthreads();

  if (tid == 0) {                    // inclusive scan, in order
    const float av = a[h];
    float run = 0.f;
    for (int j = 0; j < chunk; ++j) {
      run = __fadd_rn(run, __fmul_rn(dts[j], av));   // no fma: as torch
      cum[j] = run;
    }
    for (int j = chunk; j < kp; ++j) cum[j] = 0.f;
  }
  // C (rows i) and B (rows j) with the state axis innermost, zero-padded
  const float* cb0 = cm + b * cs_b + l0 * cs_l + h * cs_h;
  const float* bb0 = bm + b * bs_b + l0 * bs_l + h * bs_h;
  for (int e = tid; e < kp * np; e += kThreads) {
    const int i = e / np, nn = e % np;
    const bool live = i < chunk && nn < n;
    r1[i * sn + nn] = live ? cb0[i * cs_l + nn] : 0.f;
    r2[i * sn + nn] = live ? bb0[i * bs_l + nn] : 0.f;
  }
  // dt x, transposed to (P, K)
  const float* xb0 = x + b * xs_b + l0 * xs_l + h * xs_h;
  for (int e = tid; e < kp * pp; e += kThreads) {
    const int j = e / pp, pc = e % pp;
    xt[pc * sk + j] = (j < chunk && pc < p) ? xb0[j * xs_l + pc] * dts[j] : 0.f;
  }
  __syncthreads();

  for (int j = tid; j < kp; j += kThreads) {
    tail[j] = j < chunk ? expf(cum[chunk - 1] - cum[j]) : 0.f;
    if (j < chunk)
      cum_out[((long long)b * seqlen + l0 + j) * heads + h] = cum[j];
  }

  float acc[kMaxT][kMaxT];
  const int kt = kp / kTile;
  // C B^T in registers, then (after every thread is done with B) the
  // masked, decayed G over B's space
  tile_gemm<Part::kLowerTiles>(r1, sn, r2, sn, np, ty, tx, kt, kt, acc);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxT; ++r)
#pragma unroll
    for (int c = 0; c < kMaxT; ++c)
      if (r < kt && c < kt) {
        const int i = ty + kTile * r, j = tx + kTile * c;
        r2[i * sk + j] = (j <= i && i < chunk) ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
      }
  // tail_j B_j, transposed to (N, K), over C's space
  for (int e = tid; e < kp * np; e += kThreads) {
    const int j = e / np, nn = e % np;
    r1[nn * sk + j] = (j < chunk && nn < n) ? bb0[j * bs_l + nn] * tail[j] : 0.f;
  }
  __syncthreads();

  // y_intra = G (dt x)
  const int pt = pp / kTile;
  tile_gemm<Part::kCausalReduction>(r2, sk, xt, sk, kp, ty, tx, kt, pt, acc);
#pragma unroll
  for (int r = 0; r < kMaxT; ++r)
#pragma unroll
    for (int c = 0; c < kMaxT; ++c) {
      const int i = ty + kTile * r, pc = tx + kTile * c;
      if (r < kt && c < pt && i < chunk && pc < p)
        y[(((long long)b * seqlen + l0 + i) * heads + h) * p + pc] = acc[r][c];
    }

  // state_c = (dt x)^T (tail B)
  const int nt = np / kTile;
  tile_gemm<Part::kFull>(xt, sk, r1, sk, kp, ty, tx, pt, nt, acc);
  float* st = state + (((long long)b * nc + ci) * heads + h) * p * n;
#pragma unroll
  for (int r = 0; r < kMaxT; ++r)
#pragma unroll
    for (int c = 0; c < kMaxT; ++c) {
      const int pc = ty + kTile * r, nn = tx + kTile * c;
      if (r < pt && c < nt && pc < p && nn < n) st[pc * n + nn] = acc[r][c];
    }
}

// The operands of one call: x (B, L, H, P), dt (B, L, H), b and c (B, L,
// H, N) through their strides; y, state and cum contiguous fp32.
struct Args {
  const void* x;
  long long xs_b, xs_l, xs_h;
  const void* dt;
  long long ds_b, ds_l, ds_h;
  const void* a;
  const void* bm;
  long long bs_b, bs_l, bs_h;
  const void* cm;
  long long cs_b, cs_l, cs_h;
  void* y;
  void* state;
  void* cum;
  int batch, seqlen, heads, p, n, chunk;
};

int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = make_layout(a.chunk, a.n, a.p).total * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.batch * a.heads * (a.seqlen / a.chunk);
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(a.x), a.xs_b, a.xs_l, a.xs_h, static_cast<const float*>(a.dt),
      a.ds_b, a.ds_l, a.ds_h, static_cast<const float*>(a.a), static_cast<const float*>(a.bm),
      a.bs_b, a.bs_l, a.bs_h, static_cast<const float*>(a.cm), a.cs_b, a.cs_l, a.cs_h,
      static_cast<float*>(a.y), static_cast<float*>(a.state), static_cast<float*>(a.cum),
      a.seqlen, a.heads, a.p, a.n, a.chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 x, b and c: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTerms = 3;        // bf16 terms of x', and of W below chunk 64
// flags
constexpr int kXVec = 1;         // x moves in 16-byte chunks
constexpr int kBcVec = 2;        // b and c move in 16-byte chunks
constexpr int kShared = 4;       // b's and c's head strides are 0: one S a run

// bf16 terms of W at chunk k
__host__ __device__ inline int w_terms(int k) { return k >= 64 ? 2 : kTerms; }

// The 16 x 16 blocks on or below the diagonal, row-major: block (r, c),
// c <= r, has index r (r + 1) / 2 + c.
__device__ __forceinline__ void block_rc(int blk, int& r, int& c) {
  r = 0;
  while ((r + 1) * (r + 2) / 2 <= blk) ++r;
  c = blk - r * (r + 1) / 2;
}

// Shared memory, in bytes: C (kp x sn bf16), whose space W's bf16 terms
// take once S is computed (a block's term as 32 lanes' A fragments, 16
// bytes each), B (kp x sn bf16), two stages of x (kp x sp bf16), kTerms
// terms of x' for pw of P's columns at a time (kp x sw bf16; all of P up
// to 64, else 32 at a time), S of the blocks on or below the diagonal in
// fp32 (256 floats each, as the accumulators: n8 tile, lane, element), two
// stages of dt and one of cum (kp floats each).  Rows are padded by 8
// elements, an odd number of 16-byte chunks, so ldmatrix's eight row
// addresses fall in distinct bank groups.
struct Layout {
  int kp, np, pp, sn, sp, pw, sw, blocks;
  int c, b, x, xp, s, dt, cum, total;
};

__host__ __device__ inline Layout make_layout(int k, int n, int p) {
  Layout s;
  s.kp = round16(k);
  s.np = round16(n);
  s.pp = round16(p);
  s.sn = s.np + 8;
  s.sp = s.pp + 8;
  s.pw = s.pp <= 64 ? s.pp : 32;
  s.sw = s.pw + 8;
  const int rb = s.kp / 16;
  s.blocks = rb * (rb + 1) / 2;
  const int cb = s.kp * s.sn * 2, wb = s.blocks * w_terms(k) * 512;
  s.c = 0;
  s.b = cb > wb ? cb : wb;
  s.x = s.b + cb;
  s.xp = s.x + 2 * s.kp * s.sp * 2;
  s.s = s.xp + kTerms * s.kp * s.sw * 2;
  s.dt = s.s + s.blocks * 1024;
  s.cum = s.dt + 2 * s.kp * 4;
  s.total = s.cum + s.kp * 4;
  return s;
}

// rows [0, rows_pad) x columns [0, cols_pad) of a bf16 operand (row
// stride `ld` elements, unit column stride) into shared memory rows of
// `sst` elements, zero at rows >= rows or columns >= cols: by 16-byte
// cp.async when `vec` (cols a multiple of 8, pointer and strides 16-byte
// aligned), else element by element.
__device__ __forceinline__ void load_tile(bf16* dst, int sst, const bf16* src, long long ld,
                                          int rows, int rows_pad, int cols, int cols_pad,
                                          bool vec) {
  if (vec) {
    const int cpr = cols_pad / 8;
    for (int i = threadIdx.x; i < rows_pad * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * sst + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += kThreads) {
      const int r = i / cols_pad, c = i % cols_pad;
      dst[r * sst + c] = (r < rows && c < cols) ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// An m16n8 fp32 accumulator (rows g and g + 8, columns 2 tig and 2 tig + 1
// of the tile at (i0, j0)) into out[i * ld + j] for i < mi, j < mj.  With
// `vec4` (ld, j0 and mj multiples of 4, out 16-byte aligned) the lanes of a
// pair swap halves by one shuffle and each stores four columns of one row
// in 16 bytes.  Every lane of the warp calls it.
__device__ __forceinline__ void store_acc(float* out, long long ld, int i0, int j0, int mi,
                                          int mj, const float (&c)[4], bool vec4) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  if (vec4) {
    const bool odd = tig & 1;
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
    const int i = i0 + g + (odd ? 8 : 0), j = j0 + 2 * (tig & ~1);
    if (i < mi && j < mj)
      *reinterpret_cast<float4*>(out + i * ld + j) =
          odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >= 2 ? 8 : 0), j = j0 + 2 * tig + (e & 1);
      if (i < mi && j < mj) out[i * ld + j] = c[e];
    }
  }
}

// w0, w1 as T bf16 pairs, each the residual of the ones before it rounded
// to nearest (the first in the low half).
template <int T>
__device__ __forceinline__ void split_terms(float w0, float w1, uint32_t (&t)[T]) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
    t[k] = pack_bf16(w0, w1);
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&t[k]);
    w0 -= __low2float(h);
    w1 -= __high2float(h);
  }
}

// One block per (batch, chunk, run of hr heads).  NT: n8 tiles of y a
// warp holds (a quarter of P's); flags: kXVec, kBcVec, kShared.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const bf16* __restrict__ x, long long xs_b, long long xs_l, long long xs_h,
              const float* __restrict__ dt, long long ds_b, long long ds_l, long long ds_h,
              const float* __restrict__ a, const bf16* __restrict__ bm, long long bs_b,
              long long bs_l, long long bs_h, const bf16* __restrict__ cm, long long cs_b,
              long long cs_l, long long cs_h, float* __restrict__ y, float* __restrict__ state,
              float* __restrict__ cum_out, int seqlen, int heads, int p, int n, int chunk,
              int hr, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout s = make_layout(chunk, n, p);
  const int kp = s.kp, np = s.np, pp = s.pp, sn = s.sn, sp = s.sp, pw = s.pw, sw = s.sw;
  const int xe = kp * sp, we = kp * sw;  // elements of an x tile, of an x' term
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + s.c);
  uint4* wsm = reinterpret_cast<uint4*>(smem_raw + s.c);     // [blocks][terms][32], over C
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + s.b);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + s.x);        // [2][kp][sp]
  bf16* xp = reinterpret_cast<bf16*>(smem_raw + s.xp);       // [kTerms][kp][sw]
  float4* ssm = reinterpret_cast<float4*>(smem_raw + s.s);   // [blocks][2][32]
  float* dts = reinterpret_cast<float*>(smem_raw + s.dt);    // [2][kp]
  float* cum = reinterpret_cast<float*>(smem_raw + s.cum);

  const int nc = seqlen / chunk;
  const int runs = (heads + hr - 1) / hr;
  const int run = blockIdx.x % runs;
  const int ci = blockIdx.x / runs % nc;
  const int b = blockIdx.x / runs / nc;
  const int h_lo = run * hr, h_hi = min(heads, h_lo + hr);
  const int l0 = ci * chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const bool shared = flags & kShared;
  const int yterms = w_terms(chunk);

  auto load_cb = [&](int h) {
    const bool vec = flags & kBcVec;
    load_tile(cs, sn, cm + b * cs_b + l0 * cs_l + h * cs_h, cs_l, chunk, kp, n, np, vec);
    load_tile(bs, sn, bm + b * bs_b + l0 * bs_l + h * bs_h, bs_l, chunk, kp, n, np, vec);
  };
  auto load_x = [&](int st, int h) {
    load_tile(xs + st * xe, sp, x + b * xs_b + l0 * xs_l + h * xs_h, xs_l, chunk, kp, p, pp,
              flags & kXVec);
    for (int j = tid; j < kp; j += kThreads) {
      const bool ok = j < chunk;
      cp_async4(dts + st * kp + j, ok ? dt + b * ds_b + (l0 + j) * ds_l + h * ds_h : dt, ok);
    }
  };
  load_cb(h_lo);
  load_x(0, h_lo);
  cp_async_commit();

  // ldmatrix lane addressing: A row-major (C), B of two n8 tiles from rows
  // of n (B for S), B of two n8 tiles transposed from rows of k (x, B for
  // state_c), A transposed from rows of k (x')
  const int a_row = (lane / 8 % 2) * 8 + lane % 8, a_col = lane / 16 * 8;
  const int k_row = lane / 16 * 8 + lane % 8, k_col = lane / 8 % 2 * 8;
  const int v_row = lane / 8 % 2 * 8 + lane % 8, v_col = lane / 16 * 8;
  const int at_row = lane / 16 * 8 + lane % 8, at_col = (lane / 8 % 2) * 8;

  // this warp's part of y: row blocks r1 = w % 4 and r2 = R - 1 - r1 (the
  // causal triangle balanced), n8 tiles [t_lo, t_lo + t_cnt) of P: a
  // quarter each, rounded up to an even count
  const int rb = kp / 16;
  const int r1 = warp % 4, r2 = rb - 1 - r1;
  const int nt8 = pp / 8, quarter = ((nt8 + 3) / 4 + 1) & ~1;
  const int t_lo = warp / 4 * quarter, t_cnt = max(0, min(quarter, nt8 - t_lo));
  const int y_rows = r1 > r2 ? 0 : r1 == r2 ? 1 : 2;  // row blocks this warp takes

  for (int h = h_lo, it = 0; h < h_hi; ++h, ++it) {
    const int st = it & 1;
    const bf16* xt = xs + st * xe;
    const float* dtt = dts + st * kp;
    // this head's x and dt (and C and B) have landed; every warp is done
    // with the last head, whose x stage the next load refills
    cp_async_wait<0>();
    __syncthreads();
    if (!shared && it > 0) {
      load_cb(h);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (h + 1 < h_hi) load_x(st ^ 1, h + 1);
    cp_async_commit();

    if (it == 0 || !shared) {  // S = C B^T, the blocks on or below the diagonal
      for (int blk = warp; blk < s.blocks; blk += kWarps) {
        int row, col;
        block_rc(blk, row, col);
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < np / 16; ++kk) {
          uint32_t af[4], bk[4];
          ldmatrix_x4(af, cs + (row * 16 + a_row) * sn + kk * 16 + a_col);
          ldmatrix_x4(bk, bs + (col * 16 + k_row) * sn + kk * 16 + k_col);
          mma_bf16(acc[0], af, bk[0], bk[1]);
          mma_bf16(acc[1], af, bk[2], bk[3]);
        }
        ssm[blk * 64 + lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
        ssm[blk * 64 + 32 + lane] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
      }
    }

    // cum: an inclusive scan of dt * a, four values a lane of warp 0
    if (warp == 0) {
      const float av = a[h];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        v[e] = j < chunk ? __fmul_rn(dtt[j], av) : 0.f;  // no fma: as torch
      }
      v[1] = __fadd_rn(v[1], v[0]);
      v[2] = __fadd_rn(v[2], v[1]);
      v[3] = __fadd_rn(v[3], v[2]);
      float tot = v[3];
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, tot, o);
        if (lane >= o) tot = __fadd_rn(tot, u);
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        if (j < kp) cum[j] = j < chunk ? __fadd_rn(excl, v[e]) : 0.f;
      }
    }
    __syncthreads();  // cum, and S (C's space is W's from here)

    for (int j = tid; j < chunk; j += kThreads)
      cum_out[((long long)b * seqlen + l0 + j) * heads + h] = cum[j];
    const float last = cum[chunk - 1];
    // x'_j = tail_j dt_j x_j in fp32, as kTerms bf16 terms, for P's
    // columns [p0, p0 + min(pw, pp - p0))
    auto build_xp = [&](int p0) {
      const int cpr = min(pw, pp - p0) / 8;
      for (int i = tid; i < kp * cpr; i += kThreads) {
        const int j = i / cpr, c = (i % cpr) * 8;
        const float w = j < chunk ? expf(last - cum[j]) * dtt[j] : 0.f;
        const uint4 raw = *reinterpret_cast<const uint4*>(xt + j * sp + p0 + c);
        const uint32_t xw[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t t[4][kTerms];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&xw[e]);
          split_terms(w * __low2float(v), w * __high2float(v), t[e]);
        }
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          *reinterpret_cast<uint4*>(xp + k * we + j * sw + c) =
              make_uint4(t[0][k], t[1][k], t[2][k], t[3][k]);
      }
    };
    build_xp(0);
    // W_ij = S_ij (exp(cum_i - cum_j) dt_j) (j <= i < chunk, else 0) as
    // bf16 terms, a block and lane at a time: (i, j) = (16 R + g (+8),
    // 16 C + 8 t + 2 tig (+1)), as the accumulators of S hold them
    for (int i = tid; i < s.blocks * 32; i += kThreads) {
      const int blk = i / 32, l = i % 32;
      int row, col;
      block_rc(blk, row, col);
      const float4 s0 = ssm[blk * 64 + l], s1 = ssm[blk * 64 + 32 + l];
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ii = row * 16 + l / 4 + (e & 2 ? 8 : 0);
        const int jj = col * 16 + (e / 4) * 8 + 2 * (l % 4) + (e & 1);
        w[e] = (jj <= ii && ii < chunk) ? sv[e] * (expf(cum[ii] - cum[jj]) * dtt[jj]) : 0.f;
      }
      uint32_t af[4][kTerms];
#pragma unroll
      for (int f = 0; f < 4; ++f) split_terms(w[2 * f], w[2 * f + 1], af[f]);
      // A fragment order: (g, 2 tig), (g + 8, 2 tig), (g, 8 + 2 tig), (g + 8, 8 + 2 tig)
#pragma unroll
      for (int k = 0; k < kTerms; ++k)
        if (k < yterms)
          wsm[(blk * yterms + k) * 32 + l] = make_uint4(af[0][k], af[1][k], af[2][k], af[3][k]);
    }
    __syncthreads();

    // y = W x over this warp's row blocks and columns
    if (t_cnt > 0 && y_rows > 0) {
      float* yb = y + (((long long)b * seqlen + l0) * heads + h) * p;
      const long long ld = (long long)heads * p;
      const bool vec4 = p % 4 == 0;
      for (int r = 0; r < y_rows; ++r) {
        const int row = r == 0 ? r1 : r2;
        float yacc[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[t][e] = 0.f;
        for (int col = 0; col <= row; ++col) {
          const uint4* src = wsm + (row * (row + 1) / 2 + col) * yterms * 32 + lane;
          uint4 af[kTerms];
#pragma unroll
          for (int k = 0; k < kTerms; ++k)
            if (k < yterms) af[k] = src[k * 32];
          uint32_t bv[NT / 2][4];
#pragma unroll
          for (int tt = 0; tt < NT / 2; ++tt)
            if (2 * tt < t_cnt)
              ldmatrix_x4_trans(bv[tt],
                                xt + (col * 16 + v_row) * sp + (t_lo + 2 * tt) * 8 + v_col);
#pragma unroll
          for (int k = 0; k < kTerms; ++k) {
            if (k == yterms) break;
            const uint32_t ak[4] = {af[k].x, af[k].y, af[k].z, af[k].w};
#pragma unroll
            for (int tt = 0; tt < NT / 2; ++tt) {
              if (2 * tt >= t_cnt) break;
              mma_bf16(yacc[2 * tt], ak, bv[tt][0], bv[tt][1]);
              mma_bf16(yacc[2 * tt + 1], ak, bv[tt][2], bv[tt][3]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
          if (t < t_cnt) store_acc(yb, ld, row * 16, (t_lo + t) * 8, chunk, p, yacc[t], vec4);
      }
    }

    // state_c = x'^T B: tiles of 16 rows of P by 32 columns of N, P's
    // columns pw at a time
    float* sb = state + (((long long)b * nc + ci) * heads + h) * p * n;
    const bool nvec4 = n % 4 == 0;
    const int nchunks = (np + 31) / 32;
    for (int p0 = 0; p0 < pp; p0 += pw) {
      if (p0 > 0) {  // every warp is done with the last columns' terms
        __syncthreads();
        build_xp(p0);
        __syncthreads();
      }
      const int ptiles = min(pw, pp - p0) / 16;
      for (int tile = warp; tile < ptiles * nchunks; tile += kWarps) {
        const int pt = tile % ptiles, n0 = tile / ptiles * 32;
        const int ncnt = min(4, (np - n0) / 8);  // n8 tiles, even
        float sa[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[t][e] = 0.f;
        for (int kk = 0; kk < kp / 16; ++kk) {
          uint32_t af[kTerms][4], bv[2][4];
#pragma unroll
          for (int k = 0; k < kTerms; ++k)
            ldmatrix_x4_trans(af[k], xp + k * we + (kk * 16 + at_row) * sw + pt * 16 + at_col);
#pragma unroll
          for (int tt = 0; tt < 2; ++tt)
            if (2 * tt < ncnt)
              ldmatrix_x4_trans(bv[tt], bs + (kk * 16 + v_row) * sn + n0 + tt * 16 + v_col);
#pragma unroll
          for (int k = 0; k < kTerms; ++k)
#pragma unroll
            for (int tt = 0; tt < 2; ++tt) {
              if (2 * tt >= ncnt) break;
              mma_bf16(sa[2 * tt], af[k], bv[tt][0], bv[tt][1]);
              mma_bf16(sa[2 * tt + 1], af[k], bv[tt][2], bv[tt][3]);
            }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t < ncnt) store_acc(sb, n, p0 + pt * 16, n0 + t * 8, p, n, sa[t], nvec4);
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* ptr, int elem, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long st : strides)
    if (st * elem % 16) return false;
  return true;
}

template <int NT>
int launch_tc(const Args& a, int flags, cudaStream_t stream) {
  const int smem = make_layout(a.chunk, a.n, a.p).total;
  if (smem > (int)kMaxSmem) return (int)cudaErrorInvalidValue;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  // the largest layout, so that one attribute serves every shape
  const int err = kernel_setup(ssd_tc_kernel<NT>, make_layout(kMaxDim, kMaxDim, kMaxDim).total,
                               sms, sm_count);
  if (err) return err;
  // a run of heads a block, so that the grid is about one wave
  const int units = a.batch * (a.seqlen / a.chunk);
  const int want = max(1, sm_count / units);
  const int hr = (a.heads + want - 1) / want;
  const int runs = (a.heads + hr - 1) / hr;
  ssd_tc_kernel<NT><<<(unsigned)((long long)units * runs), kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), a.xs_b, a.xs_l, a.xs_h, static_cast<const float*>(a.dt),
      a.ds_b, a.ds_l, a.ds_h, static_cast<const float*>(a.a), static_cast<const bf16*>(a.bm),
      a.bs_b, a.bs_l, a.bs_h, static_cast<const bf16*>(a.cm), a.cs_b, a.cs_l, a.cs_h,
      static_cast<float*>(a.y), static_cast<float*>(a.state), static_cast<float*>(a.cum),
      a.seqlen, a.heads, a.p, a.n, a.chunk, hr, flags);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, cudaStream_t stream) {
  int flags = 0;
  if (a.p % 8 == 0 && aligned16(a.x, 2, {a.xs_b, a.xs_l, a.xs_h})) flags |= kXVec;
  if (a.n % 8 == 0 && aligned16(a.bm, 2, {a.bs_b, a.bs_l, a.bs_h}) &&
      aligned16(a.cm, 2, {a.cs_b, a.cs_l, a.cs_h}))
    flags |= kBcVec;
  if (a.bs_h == 0 && a.cs_h == 0) flags |= kShared;
  return round16(a.p) <= 64 ? launch_tc<2>(a, flags, stream) : launch_tc<4>(a, flags, stream);
}

}  // namespace tc

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, b and c; dt and a are float32).
// x (B, L, H, P), b/c (B, L, H, N) and dt (B, L, H) through their strides
// (unit stride in the last dim); y (B, L, H, P), state (B, L / chunk, H, P, N)
// and cum (B, L, H) are contiguous fp32.  chunk, P and N at most 128.
static int ssd_chunk_impl(const void* x, long long xs_b, long long xs_l,
                          long long xs_h, const void* dt, long long ds_b,
                          long long ds_l, long long ds_h, const void* a,
                          const void* bm, long long bs_b, long long bs_l,
                          long long bs_h, const void* cm, long long cs_b,
                          long long cs_l, long long cs_h, void* y, void* state,
                          void* cum, int dtype, int batch, int seqlen, int heads,
                          int p, int n, int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxDim || p < 1 || p > kMaxDim || n < 1 || n > kMaxDim ||
      seqlen % chunk || batch < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const Args args{x,  xs_b, xs_l, xs_h, dt,    ds_b,  ds_l,  ds_h,  a,     bm,     bs_b,
                  bs_l, bs_h, cm,  cs_b, cs_l, cs_h, y,     state, cum,   batch, seqlen,
                  heads, p,   n,   chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(args, s);
  if (dtype == 1) return tc::launch_bf16(args, s);
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int ssd_chunk(const long long* args) {
  return call_packed(ssd_chunk_impl, args);
}
