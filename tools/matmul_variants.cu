// Design variants of the fp32 matmul kernels of src/repro_torch/csrc/
// hete_matmul.cu, timed by tools/matmul_variants.py against each other, the
// port's kernel and cuBLAS in one process.  Each computes relu(x (M, K) @
// w (K, N) + bias) in fp32 over contiguous operands.  Not part of the port:
// the kernels the port runs are in csrc/.

#include "../src/repro_torch/csrc/device_helpers.h"

namespace {

// ---------------- SGEMM: generic (threads, tile per thread, BK, stages) ----
// THR threads; thread grid TY x TX; thread tile RM rows x CN cols.
// Rows of thread ty: ty + TY*i (i < RM); cols of tx: tx*4 + 4*TX*j + e (j < CN/4).
template <int THR, int TY, int RM, int CN, int BK, int ST>
struct G {
  static constexpr int TX = THR / TY;
  static constexpr int BM = TY * RM, BN = TX * CN;
  static constexpr int AS = BK + 4;
  static constexpr int AF = BM * AS, BF = BK * BN, STAGE = AF + BF;
  static constexpr int SMEM = ST * STAGE * 4;
};

template <int THR, int TY, int RM, int CN, int BK, int ST, int MINB>
__global__ void __launch_bounds__(THR, MINB)
sgemm(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
      float* __restrict__ y, int m, int n, int k) {
  using C = G<THR, TY, RM, CN, BK, ST>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, ty = tid / C::TX, tx = tid % C::TX;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  auto load = [&](int st, int k0) {
    float* as = sm + st * C::STAGE;
    float* bs = as + C::AF;
    for (int c = tid; c < C::BM * BK / 4; c += THR) {
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const bool ok = m0 + r < m && k0 + kc < k;
      cp_async16(as + r * C::AS + kc, ok ? x + (long long)(m0 + r) * k + k0 + kc : x, ok);
    }
    for (int c = tid; c < BK * C::BN / 4; c += THR) {
      const int r = c / (C::BN / 4), nc = (c % (C::BN / 4)) * 4;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16(bs + r * C::BN + nc, ok ? w + (long long)(k0 + r) * n + n0 + nc : w, ok);
    }
  };
  const int kt_n = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < kt_n) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (kt + ST - 1 < kt_n) load((kt + ST - 1) % ST, (kt + ST - 1) * BK);
    cp_async_commit();
    const float* as = sm + (kt % ST) * C::STAGE;
    const float* bs = as + C::AF;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * C::AS + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[CN];
#pragma unroll
        for (int q = 0; q < CN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(bs + (kq + kk) * C::BN + q * 4 * C::TX + tx * 4);
          b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty + TY * i;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < CN / 4; ++q) {
      const int col = n0 + q * 4 * C::TX + tx * 4;
      if (col >= n) continue;
      float4 v;
      v.x = fmaxf(acc[i][4 * q] + bias[col], 0.f);
      v.y = fmaxf(acc[i][4 * q + 1] + bias[col + 1], 0.f);
      v.z = fmaxf(acc[i][4 * q + 2] + bias[col + 2], 0.f);
      v.w = fmaxf(acc[i][4 * q + 3] + bias[col + 3], 0.f);
      *reinterpret_cast<float4*>(y + (long long)row * n + col) = v;
    }
  }
}

template <int THR, int TY, int RM, int CN, int BK, int ST, int MINB>
int run_sgemm(const float* x, const float* w, const float* b, float* y, int m, int n, int k,
              cudaStream_t s) {
  using C = G<THR, TY, RM, CN, BK, ST>;
  auto kern = sgemm<THR, TY, RM, CN, BK, ST, MINB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  dim3 grid((m + C::BM - 1) / C::BM, (n + C::BN - 1) / C::BN);
  kern<<<grid, THR, C::SMEM, s>>>(x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}

// ---------------- skinny: ldg streaming, COLS per block ------------------
// THR threads; a block owns COLS columns (COLS/4 float4 groups); the
// threads split into KG = THR / (COLS/4) k groups; each iteration a thread
// loads U rows (k = it*KG*U + kg*U + u), unrolled UN times.
template <int MR, int COLS, int U, int UN>
__global__ void __launch_bounds__(256)
skinny_ldg(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
           float* __restrict__ y, int m, int n, int k) {
  constexpr int CG = COLS / 4, KG = 256 / CG;
  __shared__ float red[KG][MR][COLS];
  const int tid = threadIdx.x, c4 = tid % CG, kg = tid / CG;
  const int n0 = blockIdx.x * COLS, col = n0 + c4 * 4;
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  if (col < n) {
#pragma unroll UN
    for (int kb = kg * U; kb < k; kb += U * KG) {
      float4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        wv[u] = __ldg(reinterpret_cast<const float4*>(w + (long long)(kb + u) * n + col));
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= m) break;
        float xs[U];
#pragma unroll
        for (int u = 0; u < U; u += 4) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(x + (long long)r * k + kb + u));
          xs[u] = xv.x; xs[u + 1] = xv.y; xs[u + 2] = xv.z; xs[u + 3] = xv.w;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[r][0] = fmaf(xs[u], wv[u].x, acc[r][0]);
          acc[r][1] = fmaf(xs[u], wv[u].y, acc[r][1]);
          acc[r][2] = fmaf(xs[u], wv[u].z, acc[r][2]);
          acc[r][3] = fmaf(xs[u], wv[u].w, acc[r][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[kg][r][c4 * 4 + e] = acc[r][e];
  __syncthreads();
  for (int o = tid; o < MR * COLS; o += 256) {
    const int r = o / COLS, c = o % COLS;
    if (r >= m || n0 + c >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < KG; ++q) s += red[q][r][c];
    y[(long long)r * n + n0 + c] = fmaxf(s + bias[n0 + c], 0.f);
  }
}

template <int MR, int COLS, int U, int UN>
int run_skinny(const float* x, const float* w, const float* b, float* y, int m, int n, int k,
               cudaStream_t s) {
  skinny_ldg<MR, COLS, U, UN><<<(n + COLS - 1) / COLS, 256, 0, s>>>(x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}

// ---------------- skinny: cp.async per-thread ring, COLS per block -------
template <int MR, int COLS, int U, int ST>
__global__ void __launch_bounds__(256)
skinny_ring(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
            float* __restrict__ y, int m, int n, int k) {
  constexpr int CG = COLS / 4, KG = 256 / CG, ROWS = U * KG, SLOTS = U * 256;
  extern __shared__ __align__(16) float4 ring[];
  __shared__ float red[KG][MR][COLS];
  const int tid = threadIdx.x, c4 = tid % CG, kg = tid / CG;
  const int n0 = blockIdx.x * COLS, col = n0 + c4 * 4;
  const bool col_ok = col < n;
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  const int batches = (k + ROWS - 1) / ROWS;
  auto copy_batch = [&](int bt) {
    float4* st = ring + (bt % ST) * SLOTS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kr = bt * ROWS + kg * U + u;
      const bool ok = col_ok && kr < k;
      cp_async16(st + u * 256 + tid, ok ? w + (long long)kr * n + col : w, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < batches) copy_batch(s);
    cp_async_commit();
  }
  for (int bt = 0; bt < batches; ++bt) {
    cp_async_wait<ST - 2>();
    if (bt + ST - 1 < batches) copy_batch(bt + ST - 1);
    cp_async_commit();
    const float4* st = ring + (bt % ST) * SLOTS;
    const int kb = bt * ROWS + kg * U;
    if (kb >= k) continue;
    float4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) wv[u] = st[u * 256 + tid];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= m) break;
      float xs[U];
#pragma unroll
      for (int u = 0; u < U; u += 4) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(x + (long long)r * k + kb + u));
        xs[u] = xv.x; xs[u + 1] = xv.y; xs[u + 2] = xv.z; xs[u + 3] = xv.w;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[r][0] = fmaf(xs[u], wv[u].x, acc[r][0]);
        acc[r][1] = fmaf(xs[u], wv[u].y, acc[r][1]);
        acc[r][2] = fmaf(xs[u], wv[u].z, acc[r][2]);
        acc[r][3] = fmaf(xs[u], wv[u].w, acc[r][3]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[kg][r][c4 * 4 + e] = acc[r][e];
  __syncthreads();
  for (int o = tid; o < MR * COLS; o += 256) {
    const int r = o / COLS, c = o % COLS;
    if (r >= m || n0 + c >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < KG; ++q) s += red[q][r][c];
    y[(long long)r * n + n0 + c] = fmaxf(s + bias[n0 + c], 0.f);
  }
}

template <int MR, int COLS, int U, int ST>
int run_ring(const float* x, const float* w, const float* b, float* y, int m, int n, int k,
             cudaStream_t s) {
  constexpr int SM = ST * U * 256 * 16;
  auto kern = skinny_ring<MR, COLS, U, ST>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
  kern<<<(n + COLS - 1) / COLS, 256, SM, s>>>(x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}


// Thread (row, col) sets by layout L.  0: 16 x 16 threads (warp tile 16 x 128);
// 1: warps 4 x 2 of 32 x 64 (lanes 4 x 8); 2: warps 2 x 4 of 64 x 32 (lanes 8 x 4).
template <int L>
__device__ __forceinline__ void tile_of(int tid, int& r0, int& rs, int& c0, int& cs) {
  const int w = tid / 32, lane = tid % 32;
  if (L == 0) { r0 = (tid / 16) * 4; rs = 64; c0 = (tid % 16) * 4; cs = 64; }
  if (L == 1) { r0 = (w % 4) * 32 + (lane / 8) * 4; rs = 16; c0 = (w / 4) * 64 + (lane % 8) * 4; cs = 32; }
  if (L == 2) { r0 = (w % 2) * 64 + (lane / 4) * 4; rs = 32; c0 = (w / 2) * 32 + (lane % 4) * 4; cs = 16; }
}

template <int BK, int BST, int L>
__global__ void __launch_bounds__(256, 2)
sgemm_w(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
        float* __restrict__ y, int m, int n, int k) {
  constexpr int BM = 128, BN = 128;
  constexpr int AV = BM * BK / 4 / 256;
  extern __shared__ __align__(16) float sm[];
  float* as = sm;
  float* bs = sm + 2 * BK * BM;
  const int tid = threadIdx.x;
  int r0, rs, c0, cs;
  tile_of<L>(tid, r0, rs, c0, cs);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int arow = tid % BM, akc = tid / BM;
  float4 ra[AV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int kc = k0 + (akc + 2 * v) * 4;
      const bool ok = m0 + arow < m && kc < k;
      ra[v] = ok ? __ldg(reinterpret_cast<const float4*>(x + (long long)(m0 + arow) * k + kc))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      float* d = as + (buf * BK + (akc + 2 * v) * 4) * BM + arow;
      d[0] = ra[v].x; d[BM] = ra[v].y; d[2 * BM] = ra[v].z; d[3 * BM] = ra[v].w;
    }
  };
  auto load_b = [&](int st, int k0) {
    float* d = bs + st * BK * BN;
    for (int c = tid; c < BK * BN / 4; c += 256) {
      const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16(d + r * BN + nc, ok ? w + (long long)(k0 + r) * n + n0 + nc : w, ok);
    }
  };
  const int kt_n = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < BST - 1; ++s) {
    if (s < kt_n) load_b(s, s * BK);
    cp_async_commit();
  }
  if (kt_n > 0) { fetch(0); stash(0); }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<BST - 2>();
    __syncthreads();
    if (kt + BST - 1 < kt_n) load_b((kt + BST - 1) % BST, (kt + BST - 1) * BK);
    cp_async_commit();
    const bool more = kt + 1 < kt_n;
    if (more) fetch((kt + 1) * BK);
    const float* a_t = as + (kt & 1) * BK * BM + r0;
    const float* b_t = bs + (kt % BST) * BK * BN + c0;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_t + kk * BM);
      const float4 a1 = *reinterpret_cast<const float4*>(a_t + kk * BM + rs);
      const float4 b0 = *reinterpret_cast<const float4*>(b_t + kk * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(b_t + kk * BN + cs);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash((kt + 1) & 1);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + r0 + (i / 4) * rs + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + c0 + q * cs;
      if (col >= n) continue;
      float4 v;
      v.x = fmaxf(acc[i][4 * q] + bias[col], 0.f);
      v.y = fmaxf(acc[i][4 * q + 1] + bias[col + 1], 0.f);
      v.z = fmaxf(acc[i][4 * q + 2] + bias[col + 2], 0.f);
      v.w = fmaxf(acc[i][4 * q + 3] + bias[col + 3], 0.f);
      *reinterpret_cast<float4*>(y + (long long)row * n + col) = v;
    }
  }
}

template <int BK, int BST, int L>
int run_w(const float* x, const float* w, const float* b, float* y, int m, int n, int k,
          cudaStream_t s) {
  constexpr int SM = (2 * BK * 128 + BST * BK * 128) * 4;
  auto kern = sgemm_w<BK, BST, L>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
  dim3 grid((m + 127) / 128, (n + 127) / 128);
  kern<<<grid, 256, SM, s>>>(x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}


// x by cp.async into a raw ring too; each thread transposes the chunks it
// copied into a double buffer after its compute of the previous tile.
template <int BK, int BST, int DB>
__global__ void __launch_bounds__(256, 2)
sgemm_c(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
        float* __restrict__ y, int m, int n, int k) {
  constexpr int BM = 128, BN = 128;
  constexpr int AV = BM * BK / 4 / 256;
  extern __shared__ __align__(16) float sm[];
  float* as = sm;                          // [2][BK][BM]
  float* bs = as + 2 * BK * BM;            // [BST][BK][BN]
  float* xr = bs + BST * BK * BN;          // [BST][BM][BK]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int arow = tid % BM, akc = tid / BM;
  auto load = [&](int st, int k0) {
    float* xd = xr + st * BM * BK;
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int kc = (akc + 2 * v) * 4;
      const bool ok = m0 + arow < m && k0 + kc < k;
      cp_async16(xd + arow * BK + kc, ok ? x + (long long)(m0 + arow) * k + k0 + kc : x, ok);
    }
    float* d = bs + st * BK * BN;
    for (int c = tid; c < BK * BN / 4; c += 256) {
      const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16(d + r * BN + nc, ok ? w + (long long)(k0 + r) * n + n0 + nc : w, ok);
    }
  };
  auto transpose = [&](int st, int buf) {
    const float* xs = xr + st * BM * BK;
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int kc = (akc + 2 * v) * 4;
      const float4 t = *reinterpret_cast<const float4*>(xs + arow * BK + kc);
      float* d = as + (buf * BK + kc) * BM + arow;
      d[0] = t.x; d[BM] = t.y; d[2 * BM] = t.z; d[3 * BM] = t.w;
    }
  };
  const int kt_n = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < BST - 1; ++s) {
    if (s < kt_n) load(s, s * BK);
    cp_async_commit();
  }
  cp_async_wait<BST - 2>();
  if (kt_n > 0) transpose(0, 0);
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<BST - 2>();
    __syncthreads();
    if (kt + BST - 1 < kt_n) load((kt + BST - 1) % BST, (kt + BST - 1) * BK);
    cp_async_commit();
    const float* a_t = as + (kt & 1) * BK * BM;
    const float* b_t = bs + (kt % BST) * BK * BN;
    float4 fa[2][2], fb[2][2];
    auto frag = [&](int kk, int p) {
      fa[p][0] = *reinterpret_cast<const float4*>(a_t + kk * BM + ty * 4);
      fa[p][1] = *reinterpret_cast<const float4*>(a_t + kk * BM + 64 + ty * 4);
      fb[p][0] = *reinterpret_cast<const float4*>(b_t + kk * BN + tx * 4);
      fb[p][1] = *reinterpret_cast<const float4*>(b_t + kk * BN + 64 + tx * 4);
    };
    if (DB) frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int p = DB ? kk & 1 : 0;
      if (DB) {
        if (kk + 1 < BK) frag(kk + 1, p ^ 1);
      } else {
        frag(kk, 0);
      }
      const float a[8] = {fa[p][0].x, fa[p][0].y, fa[p][0].z, fa[p][0].w,
                          fa[p][1].x, fa[p][1].y, fa[p][1].z, fa[p][1].w};
      const float b[8] = {fb[p][0].x, fb[p][0].y, fb[p][0].z, fb[p][0].w,
                          fb[p][1].x, fb[p][1].y, fb[p][1].z, fb[p][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < kt_n) {
      cp_async_wait<BST - 2>();   // tile kt + 1: the chunks this thread copied
      transpose((kt + 1) % BST, (kt + 1) & 1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + q * 64 + tx * 4;
      if (col >= n) continue;
      float4 v;
      v.x = fmaxf(acc[i][4 * q] + bias[col], 0.f);
      v.y = fmaxf(acc[i][4 * q + 1] + bias[col + 1], 0.f);
      v.z = fmaxf(acc[i][4 * q + 2] + bias[col + 2], 0.f);
      v.w = fmaxf(acc[i][4 * q + 3] + bias[col + 3], 0.f);
      *reinterpret_cast<float4*>(y + (long long)row * n + col) = v;
    }
  }
}

template <int BK, int BST, int DB>
int run_c(const float* x, const float* w, const float* b, float* y, int m, int n, int k,
          cudaStream_t s) {
  constexpr int SM = (2 * BK * 128 + 2 * BST * BK * 128) * 4;
  auto kern = sgemm_c<BK, BST, DB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
  dim3 grid((m + 127) / 128, (n + 127) / 128);
  kern<<<grid, 256, SM, s>>>(x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}

// The port's design (x by cp.async, transposed in shared memory by the
// thread that copied it) at other tile shapes: BM x BN a block, TY x TX
// threads, RM x CN a thread; thread (ty, tx) owns rows g*4*TY + 4*ty + e
// and columns h*4*TX + 4*tx + e.
template <int BM, int BN, int TY, int TX, int RM, int CN, int BK, int BST, int MINB, int WT = 0>
__global__ void __launch_bounds__(TY * TX, MINB)
sgemm_g(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
        float* __restrict__ y, int m, int n, int k) {
  constexpr int THR = TY * TX, XC = BM * BK / 4 / THR;  // x chunks a thread a stage
  static_assert(RM == BM / TY && CN == BN / TX && XC * THR * 4 == BM * BK, "tiles");
  extern __shared__ __align__(16) float sm[];
  float* as = sm;                          // [2][BK][BM]
  float* bs = as + 2 * BK * BM;            // [BST][BK][BN]
  float* xr = bs + BST * BK * BN;          // [BST][BM][BK]
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // a thread's rows r0 + g * rs + e and columns c0 + h * cs + e; WT = 1:
  // warps of 64 x 64 (lanes 8 x 4), as CUTLASS's SIMT warp tiles
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = WT ? (warp % (BM / 64)) * 64 + (lane / 4) * 4 : 4 * ty;
  const int rs = WT ? 32 : 4 * TY;
  const int c0 = WT ? (warp / (BM / 64)) * 64 + (lane % 4) * 4 : 4 * tx;
  const int cs = WT ? 16 : 4 * TX;
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  auto load = [&](int st, int k0) {
    float* xd = xr + st * BM * BK;
#pragma unroll
    for (int v = 0; v < XC; ++v) {
      const int c = tid + v * THR, row = c % BM, kc = (c / BM) * 4;
      const bool ok = m0 + row < m && k0 + kc < k;
      cp_async16(xd + row * BK + kc, ok ? x + (long long)(m0 + row) * k + k0 + kc : x, ok);
    }
    float* d = bs + st * BK * BN;
    for (int c = tid; c < BK * BN / 4; c += THR) {
      const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16(d + r * BN + nc, ok ? w + (long long)(k0 + r) * n + n0 + nc : w, ok);
    }
  };
  auto transpose = [&](int st, int buf) {
    const float* xs = xr + st * BM * BK;
#pragma unroll
    for (int v = 0; v < XC; ++v) {
      const int c = tid + v * THR, row = c % BM, kc = (c / BM) * 4;
      const float4 t = *reinterpret_cast<const float4*>(xs + row * BK + kc);
      float* dd = as + (buf * BK + kc) * BM + row;
      dd[0] = t.x; dd[BM] = t.y; dd[2 * BM] = t.z; dd[3 * BM] = t.w;
    }
  };
  const int kt_n = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < BST - 1; ++s) {
    if (s < kt_n) load(s, s * BK);
    cp_async_commit();
  }
  cp_async_wait<BST - 2>();
  if (kt_n > 0) transpose(0, 0);
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<BST - 2>();
    __syncthreads();
    if (kt + BST - 1 < kt_n) load((kt + BST - 1) % BST, (kt + BST - 1) * BK);
    cp_async_commit();
    const float* a_t = as + (kt & 1) * BK * BM + r0;
    const float* b_t = bs + (kt % BST) * BK * BN + c0;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM], b[CN];
#pragma unroll
      for (int g = 0; g < RM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(a_t + kk * BM + g * rs);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < CN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(b_t + kk * BN + h * cs);
        b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < kt_n) {
      cp_async_wait<BST - 2>();
      transpose((kt + 1) % BST, (kt + 1) & 1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + r0 + (i / 4) * rs + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < CN / 4; ++h) {
      const int col = n0 + c0 + h * cs;
      if (col >= n) continue;
      float4 v;
      v.x = fmaxf(acc[i][4 * h] + bias[col], 0.f);
      v.y = fmaxf(acc[i][4 * h + 1] + bias[col + 1], 0.f);
      v.z = fmaxf(acc[i][4 * h + 2] + bias[col + 2], 0.f);
      v.w = fmaxf(acc[i][4 * h + 3] + bias[col + 3], 0.f);
      *reinterpret_cast<float4*>(y + (long long)row * n + col) = v;
    }
  }
}

template <int BM, int BN, int TY, int TX, int RM, int CN, int BK, int BST, int MINB, int WT = 0>
int run_g(const float* x, const float* w, const float* b, float* y, int m, int n, int k,
          cudaStream_t s) {
  constexpr int SM = (2 * BK * BM + BST * BK * BN + BST * BM * BK) * 4;
  auto kern = sgemm_g<BM, BN, TY, TX, RM, CN, BK, BST, MINB, WT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kern<<<grid, TY * TX, SM, s>>>(x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}

typedef int (*Fn)(const float*, const float*, const float*, float*, int, int, int, cudaStream_t);

// M > 8 (timed at 256 x 4096 x 16384), then M <= 8 (at 4 x 4096 x 16384);
// the names are tools/matmul_variants.py's.
const Fn kFns[] = {
    run_sgemm<256, 16, 8, 8, 32, 3, 2>,   // x along K, 8 x 8, BK 32, ring 3
    run_sgemm<256, 16, 8, 8, 16, 4, 2>,   // x along K, 8 x 8, BK 16, ring 4
    run_sgemm<128, 16, 8, 16, 16, 3, 2>,  // x along K, 8 x 16 of 128 threads
    run_w<8, 4, 0>,                       // x by registers, transposed, BK 8, weights ring 4
    run_w<16, 4, 0>,                      // the same, BK 16
    run_w<32, 3, 0>,                      // the same, BK 32, ring 3
    run_w<32, 3, 1>,                      // BK 32, warps of 32 x 64
    run_w<32, 3, 2>,                      // BK 32, warps of 64 x 32
    run_c<16, 4, 0>,                      // x by cp.async, transposed in shared memory, BK 16, ring 4
    run_c<16, 3, 0>,                      // the same, ring 3 (the port's design)
    run_c<32, 2, 0>,                      // BK 32, ring 2
    run_c<16, 4, 1>,                      // BK 16, ring 4, fragments double-buffered
    run_g<128, 128, 16, 16, 8, 8, 16, 3, 2>,    // the same as run_c<16, 3, 0> through sgemm_g
    run_g<256, 128, 16, 16, 16, 8, 16, 3, 1>,   // 256 x 128 a block, 16 x 8 a thread
    run_g<128, 128, 16, 8, 8, 16, 16, 3, 2>,    // 128 threads, 8 x 16 a thread
    run_g<256, 128, 32, 8, 8, 16, 16, 3, 1>,    // 256 x 128, 256 threads, 8 x 16 a thread
    run_g<128, 256, 16, 16, 8, 16, 16, 3, 1>,   // 128 x 256, 8 x 16 a thread
    run_g<256, 64, 32, 8, 8, 8, 16, 3, 2>,      // 256 x 64 a block, 8 x 8 a thread
    run_g<128, 256, 16, 16, 8, 16, 16, 4, 1>,   // 128 x 256, 8 x 16, ring 4
    run_g<128, 256, 16, 16, 8, 16, 32, 3, 1>,   // 128 x 256, 8 x 16, BK 32, ring 3
    run_g<128, 256, 16, 16, 8, 16, 32, 2, 1>,   // 128 x 256, 8 x 16, BK 32, ring 2
    run_g<128, 256, 16, 16, 8, 16, 8, 4, 1>,    // 128 x 256, 8 x 16, BK 8, ring 4
    run_g<128, 256, 16, 16, 8, 16, 16, 3, 1, 1>,   // 128 x 256, 8 x 16, warps of 64 x 64
    run_g<128, 256, 16, 16, 8, 16, 8, 4, 1, 1>,    // the same, BK 8, ring 4
    run_skinny<4, 64, 4, 2>,              // loads, 64 columns a block
    run_skinny<4, 128, 4, 2>,             // loads, 128 columns
    run_skinny<4, 32, 4, 2>,              // loads, 32 columns
    run_skinny<4, 16, 4, 2>,              // loads, 16 columns (the port's design)
    run_skinny<4, 8, 4, 2>,               // loads, 8 columns
    run_skinny<4, 16, 8, 1>,              // loads, 16 columns, 8 rows a batch
    run_ring<4, 64, 4, 4>,                // cp.async ring, 64 columns, 4 stages
    run_ring<4, 32, 4, 4>,                // cp.async ring, 32 columns
    run_ring<4, 16, 4, 4>,                // cp.async ring, 16 columns
};
}  // namespace

extern "C" int n_variants() { return sizeof(kFns) / sizeof(kFns[0]); }
extern "C" int variant(int i, const float* x, const float* w, const float* b, float* y, int m,
                       int n, int k, void* s) {
  return kFns[i](x, w, b, y, m, n, k, static_cast<cudaStream_t>(s));
}
