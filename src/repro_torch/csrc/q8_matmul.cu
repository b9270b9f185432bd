// Int8-weight matmul with per-column scales: y = (x @ q) * scale[col], fp32
// accumulate.  The device share of every alpha-split linear when weights
// stream as int8 (wstream="q8").  Built for sm_90a.
//
// Replaces: src/repro/kernels/q8_matmul.py · q8_matmul (_q8_kernel).
//
// What bounds it on the H100: the bytes, K * N int8 weight bytes read once.
//   At decode (M = batch, a handful of rows) that is 2 * M FLOPs per byte;
//   at prefill (M = a chunk's rows, tens) the fp32-accurate product on the
//   tensor cores, three bf16 products per term at 989 TFLOP/s, still takes
//   less time than the weights' bytes.
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
// M > 16 (prefill): the tensor cores, at fp32 accuracy.  An int8 weight
//   is exact in bf16, and an fp32 x is the exact sum of three bf16 terms
//   (hi, x truncated to bf16; mid, the remainder truncated; lo, the rest),
//   so x q is three bf16 mma.sync (m16n8k16, fp32 accumulate) per tile.
//   The weights are the A operand (16 output columns x 16 k) and x's terms
//   the B operand (16 k x 8 rows of x), so 18-32 rows fill 3 or 4 n8 tiles
//   with little padding; above 32 rows, blocks of 32 rows.  A block of
//   eight warps owns a 64-column slab and 24 or 32 rows of x; a stage of
//   the ring holds 64 k rows of the weights (one 16-byte cp.async a
//   thread) and of x, four stages with three in flight, one barrier a
//   stage.  Each warp takes 32 columns and 16 of a stage's k rows; the
//   mma's k slots map to its rows so that a thread reads its weights as
//   four 32-bit words (4 columns of 4 k rows: byte permutes to fp32, whose
//   top halves are the exact bf16) and its x as one float4 a tile, which it splits into
//   the three terms itself.  The hi products go into one accumulator, mid
//   and lo into another; every 8 k steps (128 k rows) of a warp the two are
//   added into fp32 totals in shared memory (a blocked sum, as `ref.q8_
//   matmul_limit` requires).  K splits across a thread-block cluster of 1-8
//   blocks, as many as fit in one wave at two blocks an SM (two a slab
//   where one would leave SMs half used); the four warps of a
//   column half add in order, then the cluster's blocks in rank order
//   through distributed shared memory, and the column scale is applied
//   once.  No atomics: two calls give the same bits.  Every edge is masked
//   in the kernel (any M > 16, K, N): rows of the weights off 16-byte
//   alignment take byte loads, rows of x 4-byte cp.async.

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
// M > 16: tensor cores, x split into three bf16 terms
// ---------------------------------------------------------------------------

constexpr int kTThreads = 256;           // eight warps: 2 column halves x 4 k steps
constexpr int kTSlab = 64;               // columns a block
constexpr int kTBK = 64;                 // k rows a stage (a warp's 16 of them)
constexpr int kTStages = 4;              // stages in the ring (3 in flight)
constexpr int kTRun = 8;                 // a warp's k steps (128 k rows) summed apart
constexpr int kWRow = kTSlab + 16;       // padded bytes of a staged weight row
constexpr int kXRow = kTBK + 16;         // padded floats of a staged x row

template <int NT>
struct TcCfg {
  static constexpr int MT = 8 * NT;                      // x rows a block
  static constexpr int W_BYTES = kTBK * kWRow;
  static constexpr int STAGE = W_BYTES + MT * kXRow * 4;
  static constexpr int ACC = 2 * NT * 4;                 // a thread's sums
  static constexpr int PART = MT * kTSlab;               // a block's outputs
  static constexpr int SMEM = kTStages * STAGE + (kTThreads * ACC + PART) * 4;
  static_assert(4 * PART * 4 <= kTStages * STAGE, "reduction buffer");
};

// Two fp32 values as three bf16 pairs, each value the exact sum of its
// three terms: hi is x truncated to bf16 (its top 16 bits), mid the
// remainder truncated, lo the rest, which has at most 8 significant bits.
// Each subtraction is exact (Sterbenz), truncation never overflows, and the
// first value goes into the low half of each pair.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(u1 & 0xffff0000u);
  const uint32_t v0 = __float_as_uint(r0), v1 = __float_as_uint(r1);
  const float s0 = r0 - __uint_as_float(v0 & 0xffff0000u);
  const float s1 = r1 - __uint_as_float(v1 & 0xffff0000u);
  hi = __byte_perm(u0, u1, 0x7632);
  mid = __byte_perm(v0, v1, 0x7632);
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632);
}

template <int NT, bool WVEC, bool XVEC>
__global__ void __launch_bounds__(kTThreads, 2)
q8_tc_kernel(const float* __restrict__ x,      // (M, K)
             const int8_t* __restrict__ q,     // (K, N)
             const float* __restrict__ scale,  // (N,)
             float* __restrict__ y,            // (M, N)
             int m, int n, int k, int kper) {
  using C = TcCfg<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tot = reinterpret_cast<float*>(smem_raw + kTStages * C::STAGE);  // [ACC][thread]
  float* part = tot + C::ACC * kTThreads;                                 // [MT][kTSlab]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / cs) * kTSlab;
  const int m0 = blockIdx.y * C::MT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ch = warp % 2, ks = warp / 2;  // column half, k step of a stage
  const int kb = min(k, rank * kper), ke = min(k, kb + kper);
  const int nchunks = (ke - kb + kTBK - 1) / kTBK;

  auto wstage = [&](int s) { return reinterpret_cast<int8_t*>(smem_raw + s * C::STAGE); };
  auto xstage = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + s * C::STAGE + C::W_BYTES);
  };
  // stage `s` <- k rows [k0, k0 + kTBK) of the weights (the slab's columns)
  // and of x (the block's rows); zeros, unread, past ke, M or N
  auto load = [&](int s, int c) {
    const int k0 = kb + c * kTBK;
    {
      const int r = tid / 4, cc = (tid % 4) * 16, kr = k0 + r, col = n0 + cc;
      int8_t* dst = wstage(s) + r * kWRow + cc;
      if constexpr (WVEC) {
        const bool ok = kr < ke && col < n;
        cp_async16(dst, ok ? q + (size_t)kr * n + col : q, ok);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int cb = col + 4 * j + b;
            const uint32_t byte =
                (kr < ke && cb < n) ? (uint8_t)__ldg(q + (size_t)kr * n + cb) : 0u;
            w[j] |= byte << (8 * b);
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    for (int i = tid; i < C::MT * (kTBK / 4); i += kTThreads) {
      const int r = i / (kTBK / 4), cc = (i % (kTBK / 4)) * 4;
      const int row = m0 + r, kk = k0 + cc;
      float* dst = xstage(s) + r * kXRow + cc;
      if constexpr (XVEC) {
        const bool ok = row < m && kk < ke;
        cp_async16(dst, ok ? x + (size_t)row * k + kk : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row < m && kk + e < ke;
          cp_async4(dst + e, ok ? x + (size_t)row * k + kk + e : x, ok);
        }
      }
    }
  };

  // hi terms, mid and lo terms: sums of the current run
  float ah[2][NT][4], am[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[i][j][e] = am[i][j][e] = 0.f;
#pragma unroll
  for (int e = 0; e < C::ACC; ++e) tot[e * kTThreads + tid] = 0.f;
  // a run's sum into this thread's totals (its own slots: no barrier)
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[((i * NT + j) * 4 + e) * kTThreads + tid] += ah[i][j][e] + am[i][j][e];
          ah[i][j][e] = am[i][j][e] = 0.f;
        }
  };

#pragma unroll
  for (int st = 0; st < kTStages - 1; ++st) {
    if (st < nchunks) load(st, st);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();  // stage c landed; every warp is done with stage c - 1
    if (c + kTStages - 1 < nchunks) load((c + kTStages - 1) % kTStages, c + kTStages - 1);
    cp_async_commit();
    const int s = c % kTStages;
    // The mma's 16 k slots map to this warp's 16 k rows so that a thread
    // reads whole words: slots 2t, 2t + 1 are rows 4t, 4t + 1 and slots
    // 2t + 8, 2t + 9 rows 4t + 2, 4t + 3, for the weights (A) and x (B)
    // alike.  A thread's four columns 4g .. 4g + 3 of the warp's 32 are
    // rows g and g + 8 of the first m16 tile (4g, 4g + 1) and of the second
    // (4g + 2, 4g + 3).
    const int8_t* wb = wstage(s) + (16 * ks + 4 * t) * kWRow + 32 * ch + 4 * g;
    float f[4][4];  // [k row 4t + j][column 4g + c]
#pragma unroll
    for (int j = 0; j < 4; ++j) i8x4_to_f32(*reinterpret_cast<const uint32_t*>(wb + j * kWRow), f[j]);
    // an int8 value in fp32 has at most 8 significant bits: its top 16
    // bits are its bf16, taken by a byte permute instead of a conversion
    auto pair = [](float lo, float hi) {
      return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
    };
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i][0] = pair(f[0][2 * i], f[1][2 * i]);
      a[i][1] = pair(f[0][2 * i + 1], f[1][2 * i + 1]);
      a[i][2] = pair(f[2][2 * i], f[3][2 * i]);
      a[i][3] = pair(f[2][2 * i + 1], f[3][2 * i + 1]);
    }
    const float* xb = xstage(s) + g * kXRow + 16 * ks + 4 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(xb + j * 8 * kXRow);
      uint32_t bh[2], bm[2], bl[2];
      split3(v.x, v.y, bh[0], bm[0], bl[0]);
      split3(v.z, v.w, bh[1], bm[1], bl[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(ah[i][j], a[i], bh[0], bh[1]);
        mma_bf16(am[i][j], a[i], bl[0], bl[1]);
        mma_bf16(am[i][j], a[i], bm[0], bm[1]);
      }
    }
    if (c % kTRun == kTRun - 1) fold();
  }
  cp_async_wait<0>();
  fold();

  // the four k-step warps of each column half, added in order; then the
  // cluster's blocks in rank order, each block finishing every cs-th group
  // of the outputs
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem_raw);  // [ks][MT][kTSlab]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = j * 8 + 2 * t + (e & 1), col = 32 * ch + 4 * g + 2 * i + (e >> 1);
        red[(ks * C::MT + row) * kTSlab + col] = tot[((i * NT + j) * 4 + e) * kTThreads + tid];
      }
  __syncthreads();
  for (int o = tid; o < C::PART; o += kTThreads)
    part[o] = ((red[o] + red[C::PART + o]) + red[2 * C::PART + o]) + red[3 * C::PART + o];
  cluster.sync();
  for (int o = rank * kTThreads + tid; o < C::PART; o += cs * kTThreads) {
    const int r = m0 + o / kTSlab, col = n0 + o % kTSlab;
    if (r < m && col < n) {
      float p[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < cs) p[j] = cluster.map_shared_rank(part, j)[o];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < cs) sum += p[j];
      y[(size_t)r * n + col] = sum * scale[col];
    }
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

template <int NT, bool WVEC, bool XVEC>
int launch_tc(const float* x, const int8_t* q, const float* scale, float* y, int m, int n,
              int k, cudaStream_t stream) {
  using C = TcCfg<NT>;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int serr = kernel_setup(q8_tc_kernel<NT, WVEC, XVEC>, C::SMEM, sms, sm_count);
  if (serr) return serr;
  const int slabs = (n + kTSlab - 1) / kTSlab, rows = (m + C::MT - 1) / C::MT;
  // as many blocks as fit at two an SM (a block of a later wave would
  // double the time: 0.0282 against 0.0206 ms at (32, 4096, 2944)), but
  // two a slab where one a slab leaves an SM's second block idle (0.0650
  // against 0.0781 at (32, 4096, 11776); PERF.md); each block keeps at
  // least a full ring of stages
  const int slots = kBlocksPerSm * sm_count, base = slabs * rows;
  int cs = slots / base;
  if (cs < 2) cs = (slots + base - 1) / base;
  cs = max(1, min(cs, min(kMaxCluster, k / (kTStages * kTBK))));
  const int kper = ((k + cs - 1) / cs + kTBK - 1) / kTBK * kTBK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs * cs, rows);
  cfg.blockDim = dim3(kTThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, q8_tc_kernel<NT, WVEC, XVEC>, x, q, scale,
                                             y, m, n, k, kper);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NT>
int launch_tc_nt(const float* x, const int8_t* q, const float* scale, float* y, int m, int n,
                 int k, bool wvec, bool xvec, cudaStream_t s) {
  if (wvec) {
    if (xvec) return launch_tc<NT, true, true>(x, q, scale, y, m, n, k, s);
    return launch_tc<NT, true, false>(x, q, scale, y, m, n, k, s);
  }
  if (xvec) return launch_tc<NT, false, true>(x, q, scale, y, m, n, k, s);
  return launch_tc<NT, false, false>(x, q, scale, y, m, n, k, s);
}

}  // namespace

static int q8_matmul_f32_impl(const void* x, const void* q, const void* scale,
                              void* y, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  float* yf = static_cast<float*>(y);
  const bool wvec = n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (m <= 16) {
    if (wvec) return launch_stream_m<true>(xf, qi, sf, yf, m, n, k, s);
    return launch_stream_m<false>(xf, qi, sf, yf, m, n, k, s);
  }
  const bool xvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (m <= 24) return launch_tc_nt<3>(xf, qi, sf, yf, m, n, k, wvec, xvec, s);
  return launch_tc_nt<4>(xf, qi, sf, yf, m, n, k, wvec, xvec, s);
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int q8_matmul_f32(const long long* args) {
  return call_packed(q8_matmul_f32_impl, args);
}
