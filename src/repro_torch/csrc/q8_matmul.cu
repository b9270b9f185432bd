// Int8-weight matmul with per-column scales: y = (x @ q) * scale[col], fp32
// accumulate.  The device share of every alpha-split linear when weights
// stream as int8 (wstream="q8").  Built for sm_90a.
//
// Replaces: src/repro/kernels/q8_matmul.py · q8_matmul (_q8_kernel).
//
// What bounds it on the H100: at decode (M = batch, a handful of rows) the
//   bytes, K * N int8 weight bytes read once against 2 * M FLOPs per byte;
//   at prefill (M = a chunk's rows, tens to hundreds) the FLOPs on the fp32
//   CUDA cores, 2 * M * N * K at 67 TFLOP/s.
//
// One C entry, two kernels chosen by M:
//
// M <= 16 (decode): a weight-streaming kernel split across a thread-block
//   cluster.  A cluster owns a slab of columns (128 at M <= 4, fewer above,
//   so that a warp's sums fit the block's reduction buffer) and splits K
//   into one contiguous range per block (1-8 blocks, chosen from N and K so
//   the grid holds about two blocks per SM).  Each thread copies 16
//   neighbouring int8 columns of a k row with one 16-byte cp.async (8 or 4
//   columns at M > 4, so that its M x columns fp32 accumulators stay at 64
//   registers) into its own slots of a four-batch ring in shared memory,
//   three batches of four rows in flight while it computes the oldest; it
//   reads only what it copied, so the ring needs no barrier.  x's rows for
//   the block's K range are staged in shared memory by cp.async, 8192 / M
//   k rows at a time.  The int8 -> fp32 conversion is a byte permute into
//   the mantissa of 2^23 and one subtraction (exact for |q| <= 127).  A
//   thread sums its k rows in order; the threads of a column group then
//   reduce inside the warp (recursive halving, so each shuffle carries
//   values only once) and across the block's warps through shared memory,
//   and the blocks of the cluster combine through distributed shared
//   memory, each block finishing a share of the slab's outputs by adding
//   the ranks' partial sums in rank order and applying the column scale
//   once.  No atomics: two calls on the same inputs give the same bits.
//   Every edge (any M <= 16, N, K) is masked in the kernel; rows that are
//   not 16-byte aligned (N % 16 != 0) take byte loads.  The slab width,
//   the ring's depth and the blocks an SM were chosen on the card among
//   variants of this kernel (PERF.md).
//
// M > 16 (prefill): a shared-memory tiled SGEMM.  A block of 256 threads
//   owns a 64 x 64 output tile and walks K in steps of 16, staging the x
//   tile (transposed) and the int8 weight tile, dequantized to fp32 as it
//   lands in shared memory.  Each thread keeps a 4 x 4 register tile, summed
//   in runs of 128 k rows that are then added in order (a two-level sum:
//   its fp32 error stays near that of a blocked sum, which `ref.q8_matmul_
//   limit` holds every route to), and applies the column scale once.
//   Every edge is masked in the kernel.  A tensor-core path (an int8
//   weight is exact in bf16 and an fp32 x splits exactly into three bf16
//   terms) is left for a later change.

#include <cooperative_groups.h>

#include "device_helpers.h"
#include "launch_args.h"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// M <= 16: weight streaming, split-K across a cluster
// ---------------------------------------------------------------------------

constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSlabMax = 128;           // columns a cluster owns (at M <= 4)
constexpr int kXFloats = 8192;          // staged x (32 KB), also the reduction buffer
constexpr int kUnroll = 4;              // k rows a thread copies per batch
constexpr int kStages = 4;              // batches in a thread's ring (3 in flight)
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kBlocksPerSm = 2;         // the grid aims at this many blocks an SM

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

template <int MT>
struct StreamCfg {
  static constexpr int COLS = MT <= 4 ? 16 : 64 / MT;  // columns a thread
  static constexpr int WORDS = COLS / 4;               // 32-bit words a load
  // columns a cluster owns: the block's reduction buffer holds MT x SLAB
  // sums of each warp
  static constexpr int SLAB = kSlabMax < kXFloats / kSWarps / MT ? kSlabMax
                                                                  : kXFloats / kSWarps / MT;
  static constexpr int TPR = SLAB / COLS;              // threads a k row
  static constexpr int LOG_TPR = ilog2(TPR);
  static constexpr int RPS = kSThreads / TPR;          // k rows a step
  static constexpr int V = MT * COLS;                  // accumulators a thread
  static constexpr int STEPS = ilog2(32 / TPR);        // shuffle halvings
  static constexpr int KEEP = V >> STEPS;              // sums a lane keeps
  static constexpr int KC = kXFloats / MT;             // x rows staged at once
  static constexpr int OUT = MT * SLAB;                // a block's outputs
  static constexpr int RING = kStages * kUnroll * kSThreads * WORDS;  // words
  static constexpr int SMEM = (kXFloats + RING + OUT) * 4;
  static_assert(kSWarps * OUT <= kXFloats, "reduction buffer");
  static_assert(KEEP >= 1 && TPR <= 32, "lanes");
};

// The weights of k row `k` at this thread's columns [col, col + 4 * WORDS)
// into its shared-memory slot, zeros where the row or a column lies outside
// the matrix.  VEC: the row is 16-byte aligned and N a multiple of 16, so
// the columns are all inside or all outside and one cp.async of 16, 8 or 4
// bytes copies them (nothing is read for a zero fill); otherwise byte
// loads and a store.
template <int WORDS, bool VEC>
__device__ __forceinline__ void stage_row(uint32_t* slot, const int8_t* __restrict__ q, int k,
                                          int k_end, int col, int ncols) {
  if constexpr (VEC) {
    const bool ok = k < k_end && col < ncols;
    const int8_t* src = ok ? q + (size_t)k * ncols + col : q;
    if constexpr (WORDS == 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(slot)),
                   "l"(src), "r"(ok ? 16 : 0) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(slot)),
                   "l"(src), "n"(4 * WORDS), "r"(ok ? 4 * WORDS : 0) : "memory");
    }
  } else {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      uint32_t word = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = col + 4 * j + c;
        const uint32_t byte =
            (k < k_end && cc < ncols) ? (uint8_t)__ldg(q + (size_t)k * ncols + cc) : 0u;
        word |= byte << (8 * c);
      }
      slot[j] = word;
    }
  }
}

// One step of the warp's recursive halving and the steps after it: lanes
// whose bit LOG_TPR + S differs pair up; each keeps the upper or the lower
// half of its V >> S sums (compacted to the front of `a`), adds its
// partner's, and `base` tracks where its kept sums began.
template <int V, int LOG_TPR, int S, int STEPS>
__device__ __forceinline__ void halve(float (&a)[V], int lane, int& base) {
  if constexpr (S < STEPS) {
    constexpr int half = V >> (S + 1);
    const bool hi = (lane >> (LOG_TPR + S)) & 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? a[i] : a[i + half];
      const float keep = hi ? a[i + half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, (1 << LOG_TPR) << S);
    }
    base += hi ? half : 0;
    halve<V, LOG_TPR, S + 1, STEPS>(a, lane, base);
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kSThreads, 2)
q8_stream_kernel(const float* __restrict__ x,      // (M, K)
                 const int8_t* __restrict__ q,     // (K, N)
                 const float* __restrict__ scale,  // (N,)
                 float* __restrict__ y,            // (M, N)
                 int m, int n, int k) {
  using C = StreamCfg<MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // x chunk [KC][MT]; later the reduction
  uint32_t* ring = reinterpret_cast<uint32_t*>(xs + kXFloats);  // [stage][u][thread]
  float* part = reinterpret_cast<float*>(ring + C::RING);       // this block's partial sums
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / cs) * C::SLAB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tcol = tid % C::TPR, trow = tid / C::TPR;
  const int ncol = n0 + tcol * C::COLS;  // this thread's first column

  // the block's contiguous K range
  const int kper = (k + cs - 1) / cs;
  const int kb = min(k, rank * kper), ke = min(k, kb + kper);

  float acc[MT][C::COLS];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < C::COLS; ++j) acc[i][j] = 0.f;

  // batches of kUnroll rows a step apart; each thread copies its own
  // weights into its own ring slots and reads only those, so a batch needs
  // no barrier, only the thread's own cp.async.wait_group
  constexpr int span = kUnroll * C::RPS;        // k rows a batch covers
  constexpr int per_chunk = C::KC / span;       // batches an x chunk holds
  static_assert(C::KC % span == 0, "x chunk");
  const int nb = (ke - kb + span - 1) / span;
  auto slot = [&](int st, int u) {
    return ring + ((st * kUnroll + u) * kSThreads + tid) * C::WORDS;
  };
  auto issue = [&](int st, int bi) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      stage_row<C::WORDS, VEC>(slot(st, u), q, kb + bi * span + u * C::RPS + trow, ke, ncol, n);
  };
  // x's rows [c0, c0 + KC) of the block's range into xs as [kk][MT], zeros
  // for the rows of x past M
  auto stage_x = [&](int c0) {
    const int rows = min(ke, c0 + C::KC) - c0;
    for (int i = tid; i < MT * rows; i += kSThreads) {
      const int r = i / rows, kk = i % rows;
      cp_async4(xs + kk * MT + r, x + (size_t)(r < m ? r : 0) * k + c0 + kk, r < m);
    }
  };
  // the first x chunk, then the first batches, each its own group
  stage_x(kb);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nb) issue(st, st);
    cp_async_commit();
  }
  int c0 = kb;
  for (int bi = 0; bi < nb; ++bi) {
    if (bi > 0 && bi % per_chunk == 0) {  // the next x chunk
      c0 = kb + bi * span;
      __syncthreads();  // the previous chunk's x is consumed
      stage_x(c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    cp_async_wait<kStages - 2>();  // this thread's batch bi (and x chunk 0) landed
    if (bi == 0) __syncthreads();  // every thread's share of x chunk 0 is visible
    if (bi + kStages - 1 < nb) issue((bi + kStages - 1) % kStages, bi + kStages - 1);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kr = kb + bi * span + u * C::RPS + trow;
      if (kr < ke) {
        uint32_t w[C::WORDS];
        const uint32_t* sl = slot(bi % kStages, u);
        if constexpr (C::WORDS == 4) {
          const uint4 t = *reinterpret_cast<const uint4*>(sl);
          w[0] = t.x;
          w[1] = t.y;
          w[2] = t.z;
          w[3] = t.w;
        } else if constexpr (C::WORDS == 2) {
          const uint2 t = *reinterpret_cast<const uint2*>(sl);
          w[0] = t.x;
          w[1] = t.y;
        } else {
          w[0] = sl[0];
        }
        float xv[MT];
        const float* xr = xs + (kr - c0) * MT;
        if constexpr (MT % 4 == 0) {
#pragma unroll
          for (int i = 0; i < MT; i += 4) {
            const float4 t = *reinterpret_cast<const float4*>(xr + i);
            xv[i] = t.x;
            xv[i + 1] = t.y;
            xv[i + 2] = t.z;
            xv[i + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < MT; ++i) xv[i] = xr[i];
        }
#pragma unroll
        for (int j = 0; j < C::WORDS; ++j) {
          float f[4];
          i8x4_to_f32(w[j], f);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][4 * j + c] = fmaf(xv[i], f[c], acc[i][4 * j + c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // reduce over the warp's k rows by recursive halving: at each step a lane
  // keeps one half of its sums and hands the other to its partner
  float a[C::V];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < C::COLS; ++j) a[i * C::COLS + j] = acc[i][j];
  int base = 0;  // the first accumulator index this lane keeps
  halve<C::V, C::LOG_TPR, 0, C::STEPS>(a, lane, base);
  __syncthreads();  // every warp is done with x
  float* red = xs;  // [kSWarps][OUT]
#pragma unroll
  for (int i = 0; i < C::KEEP; ++i) {
    const int ai = base + i, r = ai / C::COLS, c = ai % C::COLS;
    red[warp * C::OUT + r * C::SLAB + tcol * C::COLS + c] = a[i];
  }
  __syncthreads();
  for (int o = tid; o < C::OUT; o += kSThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) s += red[w * C::OUT + o];
    part[o] = s;
  }

  // the cluster's blocks add their partial sums in rank order, each block
  // finishing every cs-th group of the slab's outputs
  cluster.sync();
  for (int o = rank * kSThreads + tid; o < C::OUT; o += cs * kSThreads) {
    const int r = o / C::SLAB, col = n0 + o % C::SLAB;
    if (r < m && col < n) {
      float p[kMaxCluster];  // every rank's partial sum read at once
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < cs) p[j] = cluster.map_shared_rank(part, j)[o];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < cs) s += p[j];
      y[(size_t)r * n + col] = s * scale[col];
    }
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

template <int MT, bool VEC>
int launch_stream(const float* x, const int8_t* q, const float* scale, float* y, int m, int n,
                  int k, cudaStream_t stream) {
  using C = StreamCfg<MT>;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int serr = kernel_setup(q8_stream_kernel<MT, VEC>, C::SMEM, sms, sm_count);
  if (serr) return serr;
  const int slabs = (n + C::SLAB - 1) / C::SLAB;
  const int want = (kBlocksPerSm * sm_count + slabs - 1) / slabs;
  // at least one full batch of k rows for every thread of a block
  const int most = max(1, k / (kUnroll * C::RPS));
  const int cs = max(1, min(kMaxCluster, min(want, most)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs * cs);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, q8_stream_kernel<MT, VEC>, x, q, scale, y,
                                             m, n, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_stream_m(const float* x, const int8_t* q, const float* scale, float* y, int m,
                    int n, int k, cudaStream_t s) {
  if (m <= 1) return launch_stream<1, VEC>(x, q, scale, y, m, n, k, s);
  if (m <= 2) return launch_stream<2, VEC>(x, q, scale, y, m, n, k, s);
  if (m <= 4) return launch_stream<4, VEC>(x, q, scale, y, m, n, k, s);
  if (m <= 8) return launch_stream<8, VEC>(x, q, scale, y, m, n, k, s);
  return launch_stream<16, VEC>(x, q, scale, y, m, n, k, s);
}

// ---------------------------------------------------------------------------
// M > 16: shared-memory tiled SGEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kRun = 8;  // K steps (128 k rows) summed apart, then added in order
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const float* __restrict__ x,        // (M, K)
                 const int8_t* __restrict__ q,       // (K, N)
                 const float* __restrict__ scale,    // (N,)
                 float* __restrict__ y,              // (M, N)
                 int m, int n, int k) {
  __shared__ float xs[kBK][kBM + 4];
  __shared__ float ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
  float tot[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = tot[i][j] = 0.f;

  for (int k0 = 0, step = 0; k0 < k; k0 += kBK, ++step) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < m && gk < k) ? x[(size_t)gm * k + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      ws[r][c] = (gk < k && gn < n)
                     ? static_cast<float>(q[(size_t)gk * n + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
      float w[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = ws[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += a[i] * w[j];
    }
    if (step % kRun == kRun - 1) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          tot[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * (kBM / kTM);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * (kBN / kTN);
      if (gm < m && gn < n) y[(size_t)gm * n + gn] = (tot[i][j] + acc[i][j]) * scale[gn];
    }
  }
}

}  // namespace

static int q8_matmul_f32_impl(const void* x, const void* q, const void* scale,
                              void* y, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 16) {
    const float* xf = static_cast<const float*>(x);
    const int8_t* qi = static_cast<const int8_t*>(q);
    const float* sf = static_cast<const float*>(scale);
    float* yf = static_cast<float*>(y);
    if (n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0)
      return launch_stream_m<true>(xf, qi, sf, yf, m, n, k, s);
    return launch_stream_m<false>(xf, qi, sf, yf, m, n, k, s);
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  q8_matmul_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale, (float*)y, m, n,
      k);
  return (int)cudaGetLastError();
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int q8_matmul_f32(const long long* args) {
  return call_packed(q8_matmul_f32_impl, args);
}
