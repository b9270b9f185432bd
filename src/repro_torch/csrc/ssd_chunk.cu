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
//   80 heads of P 64, N 128, chunk 128) one launch reads x, B and C (bf16)
//   and dt and writes y, state_c and cum in fp32, about 107 MB, against
//   5.3 MFLOP a cell over the causal triangle (6.7 GFLOP a launch): 0.032 ms
//   of bytes and 0.007 ms of bf16 tensor-core work.  This first kernel runs
//   the three products on the fp32 CUDA cores (about 0.1 ms of them at
//   67 TFLOP/s), so it is bound by operations as written.
//
// Design: one block of 256 threads (a 16 x 16 grid) per cell.  The block
//   stages C and B (K x N), dt x (transposed, P x K) and dt / cum / tail in
//   shared memory as fp32 (bf16 inputs are widened on load), 166.5 KiB at
//   the shapes above (199.5 KiB at P = 128), so it opts in to more than
//   48 KB.  cum is a sequential scan by one thread (K <= 128).  The three
//   products are one routine: each thread keeps an up-to 8 x 8 register
//   tile of rows {ty + 16 r} and columns {tx + 16 c} and walks the
//   reduction axis four at a time with float4 loads; both operands are
//   stored reduction-axis innermost with a row stride of an odd number of
//   float4s, so a warp's float4 loads fall in distinct bank groups.  C B^T
//   is computed in registers for the tiles on or below the diagonal
//   (c <= r) only; after a barrier the decay-masked G = C B^T o exp(cum_i - cum_j) [j <= i] overwrites B, and B
//   scaled by tail_j = exp(cum_last - cum_j) is re-read from device memory
//   (L2: all heads of a group share it) transposed over C.  Then y = G (dt x)
//   walks, for row tile r, only the reduction blocks j < 16 (r + 1), so the
//   causal products cover j <= i and skip 28 of the 64 tiles above the
//   diagonal; state_c = (dt x)^T (tail B) is the full product.  The skipped
//   terms are exact zeros of G, so the sums are those of the full product.
//   b and c are read through (batch, position, head) strides, so a stride-0
//   expand of the groups over the heads is never materialized.  Tensor-core
//   (mma / wgmma) tiles are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kTile = 16;                  // threads per side of the grid
constexpr int kThreads = kTile * kTile;
constexpr int kMaxDim = 128;               // chunk, P and N
constexpr int kMaxT = kMaxDim / kTile;     // register tile extent
constexpr size_t kMaxSmem = 232448;        // per block, H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const T* __restrict__ x, long long xs_b, long long xs_l,
                 long long xs_h, const float* __restrict__ dt, long long ds_b,
                 long long ds_l, long long ds_h, const float* __restrict__ a,
                 const T* __restrict__ bm, long long bs_b, long long bs_l,
                 long long bs_h, const T* __restrict__ cm, long long cs_b,
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
  const T* cb0 = cm + b * cs_b + l0 * cs_l + h * cs_h;
  const T* bb0 = bm + b * bs_b + l0 * bs_l + h * bs_h;
  for (int e = tid; e < kp * np; e += kThreads) {
    const int i = e / np, nn = e % np;
    const bool live = i < chunk && nn < n;
    r1[i * sn + nn] = live ? to_f(cb0[i * cs_l + nn]) : 0.f;
    r2[i * sn + nn] = live ? to_f(bb0[i * bs_l + nn]) : 0.f;
  }
  // dt x, transposed to (P, K)
  const T* xb0 = x + b * xs_b + l0 * xs_l + h * xs_h;
  for (int e = tid; e < kp * pp; e += kThreads) {
    const int j = e / pp, pc = e % pp;
    xt[pc * sk + j] = (j < chunk && pc < p) ? to_f(xb0[j * xs_l + pc]) * dts[j] : 0.f;
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
    r1[nn * sk + j] = (j < chunk && nn < n) ? to_f(bb0[j * bs_l + nn]) * tail[j] : 0.f;
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

template <typename T>
int launch(const void* x, long long xs_b, long long xs_l, long long xs_h,
           const void* dt, long long ds_b, long long ds_l, long long ds_h,
           const void* a, const void* bm, long long bs_b, long long bs_l,
           long long bs_h, const void* cm, long long cs_b, long long cs_l,
           long long cs_h, void* y, void* state, void* cum, int batch,
           int seqlen, int heads, int p, int n, int chunk, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)batch * heads * (seqlen / chunk);
  ssd_chunk_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), xs_b, xs_l, xs_h, static_cast<const float*>(dt),
      ds_b, ds_l, ds_h, static_cast<const float*>(a), static_cast<const T*>(bm),
      bs_b, bs_l, bs_h, static_cast<const T*>(cm), cs_b, cs_l, cs_h,
      static_cast<float*>(y), static_cast<float*>(state), static_cast<float*>(cum),
      seqlen, heads, p, n, chunk);
  return (int)cudaGetLastError();
}

// Shared memory one block needs, in bytes (0 for shapes the kernel rejects).
size_t smem_bytes(int p, int n, int chunk) {
  if (chunk < 1 || chunk > kMaxDim || p < 1 || p > kMaxDim || n < 1 || n > kMaxDim)
    return 0;
  const size_t bytes = make_layout(chunk, n, p).total * sizeof(float);
  return bytes <= kMaxSmem ? bytes : 0;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, b and c; dt and a are float32).
// x (B, L, H, P), b/c (B, L, H, N) and dt (B, L, H) through their strides
// (unit stride in the last dim); y (B, L, H, P), state (B, L / chunk, H, P, N)
// and cum (B, L, H) are contiguous fp32.
static int ssd_chunk_impl(const void* x, long long xs_b, long long xs_l,
                          long long xs_h, const void* dt, long long ds_b,
                          long long ds_l, long long ds_h, const void* a,
                          const void* bm, long long bs_b, long long bs_l,
                          long long bs_h, const void* cm, long long cs_b,
                          long long cs_l, long long cs_h, void* y, void* state,
                          void* cum, int dtype, int batch, int seqlen, int heads,
                          int p, int n, int chunk, void* stream) {
  const size_t smem = smem_bytes(p, n, chunk);
  if (smem == 0 || seqlen % chunk || batch < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_ARGS x, xs_b, xs_l, xs_h, dt, ds_b, ds_l, ds_h, a, bm, bs_b, bs_l, \
    bs_h, cm, cs_b, cs_l, cs_h, y, state, cum, batch, seqlen, heads, p, n,    \
    chunk, smem, s
  if (dtype == 0) return launch<float>(SSD_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(SSD_ARGS);
#undef SSD_ARGS
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int ssd_chunk(const long long* args) {
  return call_packed(ssd_chunk_impl, args);
}
