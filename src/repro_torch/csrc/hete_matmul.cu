// Dense matmul with a fused epilogue, two kernels of one file.  Built for
// sm_90a.
//
//   hete_matmul:       y = act(x @ w + bias)            x (M, K), w (K, N)
//   hete_gated_matmul: y = act(x @ w_gate) * (x @ w_up)  in one pass over x
//
// Replaces: src/repro/kernels/hete_matmul.py · matmul (_matmul_kernel) and
//   gated_matmul (_gated_kernel).  Both accumulate in fp32, apply the bias
//   and the activation (none, relu, relu2, gelu in its tanh form, silu) once
//   in fp32 on the finished sum, and write x's dtype: one rounding, as the
//   Pallas kernels do.  The Pallas kernels assert that their 128-blocks
//   divide M, N and K; these take any M, and K and N that are multiples of
//   8 (bf16) or 4 (fp32), and mask the ragged edges of their tiles.
//
// What bounds it on the H100 (one H100 80GB HBM3, 700 W; PERF.md).
//   Prefill (M = B * S, hundreds to thousands of rows) is bound by
//   operations: Mistral-NeMo-12B's gated MLP (2048 x 5120 -> 14336, two
//   products) 6.0e11 bf16 FLOPs, 0.61 ms at 989 TFLOP/s; Nemotron-4's
//   squared-ReLU MLP (2048 x 18432 -> 73728) 5.6e12, 5.63 ms; Whisper's
//   (6000 x 768 -> 3072, bias, GELU) 2.8e10, 0.029 ms, where a tile's
//   epilogue (bias, GELU, 128 x 192 outputs) weighs as much as its 12
//   stages of K.  Decode (M = batch = 4) is bound by the weights' bytes:
//   2.7 GB at Nemotron-4's 18432 -> 73728 (0.81 ms at 3.35 TB/s), 4.7 MB
//   at Whisper's 768 -> 3072 (1.4 us, so a few us of latency decide).
//
// Design:
//   * bf16, M > 48, one weight: fold_kernel, wgmma fed by TMA, one
//     persistent block an SM in clusters of two along M.  Three
//     warpgroups: a producer (registers cut to 40 by setmaxnreg) whose one
//     thread issues the TMA loads, and two consumers (232 registers) that
//     each own 64 rows x 192 columns (one m64n192k16 a 16-deep k step).  A
//     stage holds x's 128 x 64 tile (K-major, the A operand) and the
//     weight's 64 x 192 tile as three 64-column boxes (the weight lies
//     (K, N) with N contiguous: an MN-major B, wgmma's transpose flag, no
//     copy), all 128-byte swizzled by TMA; four stages of 40 KB with a
//     full and an empty mbarrier each.  The two blocks of a cluster take
//     two row tiles of one column tile: each loads its own x tile and
//     part of the weight boxes, multicast into both, so the weight tile
//     leaves L2 once for 256 rows (the empty barriers count the consumer
//     warps of both blocks).  The tensor cores' accumulator is folded into
//     an fp32 total every kPromoteK of K (96 + 96 registers a thread).  A
//     tile's epilogue (bias, the activation at compile time, one cast)
//     writes the output into shared memory in TMA's swizzle, one
//     thread stores it by TMA (16-byte rows, coalesced), and it runs in
//     kEpiParts parts between the next tile's first stages, which the
//     tensor cores work on meanwhile.  Groups of tiles are walked with M
//     fastest: the clusters in flight share weight tiles through the
//     50 MB L2 and stay within a few column bands of x.  TMA zero-fills
//     rows past M and a K tail; a weight box wholly past N is not loaded,
//     and the TMA store writes nothing past M or N.  x's tensor map
//     carries its row stride, so a strided x is read in place.
//   * bf16 gated MLP, M > 48: wg_kernel, the same scheme with 128 x 128
//     tiles of each weight, no cluster, an epilogue from registers, and
//     unfolded (both weights' totals would not fit the registers; at K
//     18432 its sums still held ref.gated_matmul_limit on the card).
//   * bf16, one weight, M <= 48: split_kernel streams it.  A block owns 256
//     columns (512-byte runs of every weight row through a cp.async ring,
//     the L2 fetching 256-byte blocks) and one of cs equal runs of K's
//     64-deep tiles; the cs blocks of a column block form a cluster (cs a
//     power of two up to 8, enough blocks for about 8 an SM: 96 blocks at
//     Whisper's N 3072, 1152 at Nemotron-4's N 73728).  Its warps multiply
//     x's 16-row tiles on mma.sync m16n8k16, folding every kPromoteK; then
//     every rank writes its totals of rank r's columns into rank r's
//     shared memory (distributed shared memory), and after one cluster
//     barrier rank r sums them in rank order, runs the epilogue and writes
//     y: a fixed order, no atomics.
//   * bf16 gated MLP, M <= 48: tc_kernel, mma.sync on 16 x 64
//     tiles of both weights through a cp.async ring, folded every
//     kPromoteK: split_kernel over two weights (256 or 128 columns a
//     block) measured slower at four of the paths' six decode shapes.
//   * fp32 (no TF32: the plain version's limits assume fp32 products): the
//     CUDA cores.  M > 8 runs a pipelined SGEMM: a 128 x 256 output tile
//     (128 x 128 a weight when gated), 8 x 16 a thread, 256 threads and
//     one block an SM (128 blocks in one wave at 256 x 16384).  K advances
//     16 at a time (256 barriers at K = 4096) through a three-stage
//     cp.async ring that holds x's tile and the weights' as they lie; each
//     thread then writes the x chunks it copied transposed into one of two
//     buffers, and each k step reads two float4 of x and four of the
//     weights for 128 FMAs.  On the card (one H100, 700 W) this beat
//     128 x 128 tiles with register-prefetched 8-deep steps, and variants
//     with x read along K, 32-deep steps, squarer warp tiles,
//     double-buffered fragments, 256-row tiles and two blocks an SM
//     (tools/matmul_variants.py, PERF.md).  M <= 8 streams
//     the weights with 16-byte read-only loads, two batches of four k rows
//     in flight a thread, each batch against every row of x; a block owns
//     16 columns, so N / 16 blocks (1024 at N = 16384) keep each SM holding
//     several: 64-column blocks, and per-thread cp.async rings of 16 to 64
//     columns, moved fewer bytes a second.  The partial sums
//     meet by shuffles and in shared memory in a fixed order.
//   No sum depends on timing or uses atomics: two calls give the same bits.
//   Every load and store of x, the weights and y is 16 bytes wide (TMA
//   needs the same), so K, N and x's row stride are multiples of 8 (bf16)
//   or 4 (fp32) elements and the operands are 16-byte aligned; the entry
//   points refuse anything else.
//
// What the card showed (one H100 80GB HBM3, 700 W; device ms of 20 calls
//   in a CUDA graph by tools/ab_kernels.py, this source against the one
//   before it, whose routes were 128 x 128 wgmma tiles without cluster,
//   fold overlap or TMA store above 48 rows and 16 x 64 mma.sync tiles at
//   or below; PERF.md rows 7w, 7n): Whisper's 6000 x 768 -> 3072 with bias
//   and GELU 0.083 against 0.128 (torch._addmm_activation 0.056); its 16
//   and 4 rows 0.0066 and 0.0060 against 0.0089 and 0.0084 (0.0044,
//   0.0042); Nemotron-4's 2048 x 18432 -> 73728 8.68 against 13.22
//   (torch.matmul of the bare product 8.17), its 4 rows 0.887 against
//   0.967, 0.91 of the bytes bound.  The design steps, as variants of
//   this source (tools/bf16_matmul_variants.py), at 6000 and 2048 rows:
//   no cluster 0.081 and 11.10; clusters of four 0.090 and 9.21; 128 x
//   128 tiles 0.084 and 12.04; the activation switched at every element
//   0.101; a Newton
//   reciprocal in place of the MUFU one 0.131; the epilogue in four parts
//   0.087, in one 0.082; without the fold 0.081 and 8.02 (but K 18432
//   then fails the limit); without the L2 hint the 4-row stream 0.899.
//   The GELU epilogue of both consumers at once is what keeps 6000 rows
//   above the library's time: staggering the consumers stalls the ring.

#include <cooperative_groups.h>

#include <type_traits>

#include "device_helpers.h"
#include "hopper_helpers.h"
#include "launch_args.h"

namespace cg = cooperative_groups;

namespace {

enum Act { kNone = 0, kRelu = 1, kRelu2 = 2, kGelu = 3, kSilu = 4 };

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(y, 0.f);
    case kRelu2: {
      const float r = fmaxf(y, 0.f);
      return r * r;
    }
    case kGelu: {  // jax.nn.gelu's default, the tanh approximation
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case kSilu:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

// The tensor cores add each product into their fp32 accumulator with
// truncation, not round-to-nearest, so its error grows with K faster than
// an fp32 sum's: at Nemotron-4's K = 18432 a single accumulator lay up to
// 5.5 units of ref._product_bound from the exact product, cuBLAS's too
// (the limit allows 5).  The bf16 kernels below therefore run an
// accumulator over kPromoteK columns of K at a time and add it into an
// fp32 total with round-to-nearest (fold_kernel, split_kernel and
// tc_kernel; the two-weight wg_kernel has no registers for the totals);
// the total's error then grows like an fp32 sum's.
constexpr int kPromoteK = 512;

// 2^x and 1 / x, one MUFU op each, subnormals flushed (the library's
// __expf and __fdividef add range checks an element that the epilogue
// does not need: an overflowed e^t gives 1 / inf = 0, the exact limit)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The activation where the output is bf16 (the wgmma kernels), chosen at
// compile time so that an epilogue runs no switch an element (a branch an
// element cost the wgmma kernels' epilogue most of its time on the card):
// GELU and SiLU as y / (1 + e^-t), a few fp32 ulps from apply_act, far
// under the bf16 output's step (a reciprocal by Newton steps on the FMA
// pipes, in place of the MUFU op, measured 1.8x slower at Whisper's 6000
// rows).
template <int A>
__device__ __forceinline__ float act_bf16(float y) {
  constexpr float kLog2e = 1.4426950408889634f;
  if constexpr (A == kRelu) {
    return fmaxf(y, 0.f);
  } else if constexpr (A == kRelu2) {
    const float r = fmaxf(y, 0.f);
    return r * r;
  } else if constexpr (A == kGelu) {  // 0.5 y (1 + tanh(u)) = y / (1 + e^(-2u))
    const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return y * rcp_ftz(1.f + ex2_ftz(-2.f * kLog2e * u));
  } else if constexpr (A == kSilu) {
    return y * rcp_ftz(1.f + ex2_ftz(-kLog2e * y));
  } else {
    return y;
  }
}

// f(std::integral_constant<int, A>) for the activation code `act`
template <class F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case kRelu:
      f(std::integral_constant<int, kRelu>{});
      break;
    case kRelu2:
      f(std::integral_constant<int, kRelu2>{});
      break;
    case kGelu:
      f(std::integral_constant<int, kGelu>{});
      break;
    case kSilu:
      f(std::integral_constant<int, kSilu>{});
      break;
    default:
      f(std::integral_constant<int, kNone>{});
  }
}

// ---------------------------------------------------------------------------
// bf16, one weight, M <= 48: the weight streamed, K split across a cluster
// ---------------------------------------------------------------------------

// cp_async16 that also has L2 fetch the 256-byte block around it: a
// weight row's 512 bytes arrive in two DRAM bursts (1% of the decode
// kernel's time at Nemotron-4's 4 x 18432 -> 73728 on the card)
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

constexpr int kSpBK = 64;         // K a stage
constexpr int kSpThreads = 256;   // 8 warps side by side along N, 32 columns each
constexpr int kSpMaxCluster = 8;  // blocks sharing one column block's K

struct SplitCfg {
  static constexpr int BN = 256;                        // columns a block
  static constexpr int AS = kSpBK + 8, BS = BN + 8;     // padded row strides: ldmatrix
                                                       // is free of bank conflicts
  static constexpr int A_ELEMS = 48 * AS;               // x's tile, up to 48 rows
  static constexpr int STAGE = A_ELEMS + kSpBK * BS;    // elements
  static constexpr int STAGES = 4;                      // 159 KB of ring
  static constexpr int RING = STAGES * STAGE * 2;
  // the totals the block sums, beside the ring, so that a rank may write
  // into another's while that one still reads its ring
  static constexpr int PART = 48 * (BN + 8 * kSpMaxCluster) * 4;
  static constexpr int SMEM = RING + PART;
  static constexpr int WN = BN / 8;                     // a warp's columns (32)
  static constexpr int NT = WN / 8;                     // its n8 tiles (4)
};

// Block (column block c, cluster rank r) of a cluster of cs: columns 256 c
// .. 256 c + 255 over the r-th of cs equal runs of K's 64-deep tiles.
// Every thread copies 16-byte chunks of whole 512-byte weight rows (and
// x's) through a cp.async ring; each warp multiplies x's MT 16-row tiles
// against its 32 columns on mma.sync m16n8k16, folding the accumulators
// into fp32 totals every kPromoteK of K.  Rank r finishes columns r 256 /
// cs ..: every rank writes its totals of them into rank r's shared memory
// through distributed shared memory, and after one cluster barrier rank r
// sums them in rank order, adds the bias, applies the activation and
// writes y.
template <int MT>
__global__ void __launch_bounds__(kSpThreads, 1)
split_kernel(const __nv_bfloat16* __restrict__ x, long long lda,
             const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
             __nv_bfloat16* __restrict__ y, int m, int n, int k, int act) {
  using C = SplitCfg;
  extern __shared__ __align__(16) unsigned char split_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(split_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / cs) * C::BN;
  const int ktiles = (k + kSpBK - 1) / kSpBK;
  const int kt0 = (int)((long long)rank * ktiles / cs);
  const int nk = (int)((long long)(rank + 1) * ktiles / cs) - kt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  cluster_arrive_relaxed();  // this block runs (waited for before any DSMEM write)

  // k-tile kt of x's rows and of the weight's 256 columns into stage s;
  // what lies outside the matrices arrives as zeros
  auto load = [&](int s, int kt) {
    __nv_bfloat16* as = smem + s * C::STAGE;
    __nv_bfloat16* bs = as + C::A_ELEMS;
    const int k0 = kt * kSpBK;
    for (int c = threadIdx.x; c < MT * 16 * (kSpBK / 8); c += kSpThreads) {
      const int r = c / (kSpBK / 8), kc = (c % (kSpBK / 8)) * 8;
      const bool ok = r < m && k0 + kc < k;
      cp_async16(as + r * C::AS + kc, ok ? x + (long long)r * lda + k0 + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kSpBK * C::BN / 8 / kSpThreads; ++i) {
      const int c = threadIdx.x + i * kSpThreads;
      const int r = c / (C::BN / 8), nc = (c % (C::BN / 8)) * 8;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16_l2(bs + r * C::BS + nc, ok ? w + (long long)(k0 + r) * n + n0 + nc : w, ok);
    }
  };

  // acc: the mma accumulators of the current run of kPromoteK columns of
  // K; tot: the sum of the finished runs, added with round-to-nearest
  float acc[MT][C::NT][4], tot[MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + C::STAGES - 1 < nk) load((t + C::STAGES - 1) % C::STAGES, kt0 + t + C::STAGES - 1);
    cp_async_commit();

    const __nv_bfloat16* as = smem + (t % C::STAGES) * C::STAGE;
    const __nv_bfloat16* bs = as + C::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kSpBK; kk += 16) {
      uint32_t af[MT][4], bf[C::NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], as + (i * 16 + lane % 16) * C::AS + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < C::NT / 2; ++j)
        ldmatrix_x4_trans(bf[j], bs + (kk + lane % 16) * C::BS + warp * C::WN + j * 16 +
                                     (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT / 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
    }
    if ((t + 1) % (kPromoteK / kSpBK) == 0 || t + 1 == nk) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] += acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();
  cluster_wait();  // every rank runs

  // rank q finishes columns q 256 / cs .. of the block's 256: each rank
  // writes its totals of those columns into rank q's shared memory, at
  // [its rank][row][column] (rows padded by 8 floats: a warp's float2
  // stores fall in distinct banks), through distributed shared memory
  const int slice = C::BN / cs, ps = slice + 8;
  float* part = reinterpret_cast<float*>(split_smem + C::RING);
  {
    const int q = warp * C::WN / slice;  // a warp's 32 columns lie in one rank's slice
    float* dst = cluster.map_shared_rank(part, q);
    const int gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i * 16 + gid + 8 * h;
        if (row >= m) continue;  // x's zero rows: nothing to sum
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          *reinterpret_cast<float2*>(dst + (rank * MT * 16 + row) * ps + warp * C::WN -
                                     q * slice + j * 8 + tig * 2) =
              make_float2(tot[i][j][2 * h], tot[i][j][2 * h + 1]);
      }
  }
  cluster.sync();  // every rank's totals of this rank's columns are here

  // 4 columns a thread: the ranks' totals summed in rank order, then the
  // bias and the activation in fp32 and one cast (n is a multiple of 8,
  // so 4 columns are all in range or all out); nothing reads another
  // block's shared memory from here on, so no block waits for the others
  // to leave
  const int quads = slice / 4;
  for (int o = threadIdx.x; o < m * quads; o += kSpThreads) {
    const int row = o / quads, lc = (o % quads) * 4, col = n0 + rank * slice + lc;
    if (col >= n) continue;
    float v[4] = {};
    for (int r = 0; r < cs; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(part + (r * MT * 16 + row) * ps + lc);
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = apply_act(v[e] + (bias != nullptr ? __bfloat162float(bias[col + e]) : 0.f), act);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(y + (long long)row * n + col) = packed;
  }
}

// The cluster: the fewest blocks (a power of two up to 8, each with a
// k-tile at least two) that give 8 blocks an SM, so that the streams of
// many blocks are in flight on every SM and the last wave is short.
template <int MT>
int launch_split(const void* x, long long lda, const void* w, const void* bias, void* y,
                 int m, int n, int k, int act, cudaStream_t stream) {
  using C = SplitCfg;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(split_kernel<MT>, C::SMEM, sms, sm_count);
  if (err) return err;
  const int nb = (n + C::BN - 1) / C::BN, ktiles = (k + kSpBK - 1) / kSpBK;
  int cs = 1;
  while (cs < kSpMaxCluster && 2 * cs <= ktiles && nb * cs < 8 * sm_count) cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * cs);
  cfg.blockDim = dim3(kSpThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, split_kernel<MT>, static_cast<const __nv_bfloat16*>(x), lda,
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), m, n, k, act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_split_rows(const void* x, long long lda, const void* w, const void* bias, void* y,
                      int m, int n, int k, int act, cudaStream_t stream) {
  if (m <= 16) return launch_split<1>(x, lda, w, bias, y, m, n, k, act, stream);
  if (m <= 32) return launch_split<2>(x, lda, w, bias, y, m, n, k, act, stream);
  return launch_split<3>(x, lda, w, bias, y, m, n, k, act, stream);
}

// ---------------------------------------------------------------------------
// bf16 gated MLP, M <= 48: tensor-core tiles on mma.sync (the split-K
// stream measured slower at some of the paths' decode shapes)
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct TcCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // its mma tiles
  static constexpr int AS = BK + 8, BS = BN + 8;       // padded row strides
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "tile shape");
};

// Decode: 16 rows, 64 columns a block, four stages.
using TcDecode = TcCfg<16, 64, 64, 1, 4, 4>;          // 128 threads, warp 16 x 16

template <class C, int NW>
constexpr size_t tc_smem() {
  return (size_t)C::STAGES * ((size_t)C::BM * C::AS + (size_t)NW * C::BK * C::BS) *
         sizeof(__nv_bfloat16);
}

// One (BM x BK) tile of x and (BK x BN) tiles of the NW weights into stage
// buffers; out-of-range elements are zeros.
template <class C, int NW>
__device__ __forceinline__ void tc_load(__nv_bfloat16* as, __nv_bfloat16* bs,
                                        const __nv_bfloat16* __restrict__ x, long long lda,
                                        const __nv_bfloat16* const (&w)[2], int m, int n,
                                        int k, int m0, int n0, int k0) {
  constexpr int AC = C::BM * C::BK / 8, BC = C::BK * C::BN / 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < AC; c += C::kThreads) {
    const int r = c / (C::BK / 8), kc = (c % (C::BK / 8)) * 8;
    const bool ok = m0 + r < m && k0 + kc < k;
    cp_async16(as + r * C::AS + kc, ok ? x + (long long)(m0 + r) * lda + k0 + kc : x, ok);
  }
#pragma unroll
  for (int g = 0; g < NW; ++g) {
    for (int c = threadIdx.x; c < BC; c += C::kThreads) {
      const int r = c / (C::BN / 8), nc = (c % (C::BN / 8)) * 8;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16(bs + (g * C::BK + r) * C::BS + nc,
                 ok ? w[g] + (long long)(k0 + r) * n + n0 + nc : w[g], ok);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads)
tc_kernel(const __nv_bfloat16* __restrict__ x, long long lda,
          const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
          __nv_bfloat16* __restrict__ y, int m, int n, int k, int act) {
  constexpr int NW = 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int A_ELEMS = C::BM * C::AS, B_ELEMS = NW * C::BK * C::BS;
  constexpr int STAGE = A_ELEMS + B_ELEMS;

  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const __nv_bfloat16* const w[2] = {w0, w1};

  // acc: the mma accumulators of the current run of kPromoteK columns of
  // K; tot: the sum of the finished runs, added in fp32 with
  // round-to-nearest (the tensor cores' own accumulation truncates)
  float acc[NW][C::MT][C::NT][4], tot[NW][C::MT][C::NT][4];
#pragma unroll
  for (int g = 0; g < NW; ++g)
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][i][j][e] = tot[g][i][j][e] = 0.f;

  const int ktiles = (k + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles)
      tc_load<C, NW>(smem + s * STAGE, smem + s * STAGE + A_ELEMS, x, lda, w, m, n, k, m0,
                     n0, s * C::BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int nk = kt + C::STAGES - 1;
    if (nk < ktiles) {
      const int s = nk % C::STAGES;
      tc_load<C, NW>(smem + s * STAGE, smem + s * STAGE + A_ELEMS, x, lda, w, m, n, k, m0,
                     n0, nk * C::BK);
    }
    cp_async_commit();

    const __nv_bfloat16* as = smem + (kt % C::STAGES) * STAGE;
    const __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      // every fragment of this 16-deep step first, then its products
      uint32_t af[C::MT][4], bf[NW][C::NT / 2][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
        ldmatrix_x4(af[i], as + (wm * C::WTM + i * 16 + lane % 16) * C::AS + kk + (lane / 16) * 8);
#pragma unroll
      for (int g = 0; g < NW; ++g)
#pragma unroll
        for (int j = 0; j < C::NT / 2; ++j)
          ldmatrix_x4_trans(bf[g][j], bs + (g * C::BK + kk + lane % 16) * C::BS + wn * C::WTN +
                                          j * 16 + (lane / 16) * 8);
#pragma unroll
      for (int g = 0; g < NW; ++g)
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT / 2; ++j) {
            mma_bf16(acc[g][i][2 * j], af[i], bf[g][j][0], bf[g][j][1]);
            mma_bf16(acc[g][i][2 * j + 1], af[i], bf[g][j][2], bf[g][j][3]);
          }
    }
    if ((kt + 1) % (kPromoteK / C::BK) == 0 || kt + 1 == ktiles) {
#pragma unroll
      for (int g = 0; g < NW; ++g)
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[g][i][j][e] += acc[g][i][j][e];
              acc[g][i][j][e] = 0.f;
            }
    }
  }
  cp_async_wait<0>();

  // epilogue in registers: the gate's activation in fp32 times the up
  // product, one cast (n is even, so a thread's two columns are both in
  // range or both out)
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int col = n0 + wn * C::WTN + j * 8 + tig * 2;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * C::WTM + i * 16 + gid + h * 8;
        if (row >= m) continue;
        const float v0 = apply_act(tot[0][i][j][2 * h], act) * tot[1][i][j][2 * h];
        const float v1 = apply_act(tot[0][i][j][2 * h + 1], act) * tot[1][i][j][2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <class C>
int launch_tc(const void* x, long long lda, const void* w0, const void* w1, void* y, int m,
              int n, int k, int act, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<C, 2>();
  cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + C::BM - 1) / C::BM, (n + C::BN - 1) / C::BN);
  tc_kernel<C><<<grid, C::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), lda, static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<__nv_bfloat16*>(y), m, n, k, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, M > 48: wgmma fed by TMA, warp-specialized, persistent
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;          // rows a tile, 64 a consumer warpgroup
constexpr int kWgBK = 64;           // K a stage: one 128-byte swizzled row
constexpr int kWgThreads = 384;     // consumer warpgroups 0 and 1, the producer 2
constexpr int kWgBox = kWgBK * 64 * 2;  // one 64-column box of a weight's stage tile

// d += a * b over 64 BOXES columns
template <int BOXES>
__device__ __forceinline__ void wgmma_bt(float (&d)[32 * BOXES], uint64_t a, uint64_t b) {
  if constexpr (BOXES == 2) {
    wgmma_m64n128k16_bf16_bt(d, a, b);
  } else {
    wgmma_m64n192k16_bf16_bt(d, a, b);
  }
}

constexpr int kEpiParts = 2;  // a tile's epilogue runs in parts between the next tile's stages
static_assert(kEpiParts <= kPromoteK / kWgBK, "no fold falls among the overlapped stages");

// f(std::integral_constant<int, I>) for I = 0 .. N - 1, each I a constant
template <int N, int I = 0, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<N, I + 1>(f);
  }
}

// The folded kernel's tiles: 128 rows x 64 BOXES columns (3: 128 x 192,
// the widest whose totals fit beside the accumulators).
template <int BOXES>
struct FoldCfg {
  static constexpr int BN = 64 * BOXES;                  // columns a tile
  static constexpr int A_BYTES = kWgBM * kWgBK * 2;      // x's tile, 16 KB
  static constexpr int B_BYTES = BOXES * kWgBox;         // the weight's tile
  static constexpr int STAGE = A_BYTES + B_BYTES;        // 40 KB at 3 boxes
  static constexpr int OUT_BOX = kWgBM * 128;            // 64 columns of the output tile
  static constexpr int OUT = BOXES * OUT_BOX;            // the output tile, staged for TMA
  static constexpr int STAGES = (212992 - OUT) / STAGE;  // 4 at 3 boxes
  static constexpr int ACC = BN / 2;                     // accumulators a thread
  static constexpr int SMEM = 1024 + STAGES * STAGE + OUT + 2 * STAGES * 8;
};

// See the notes at the top.  tx: x (M, K) in 128 x 64 boxes; tw: the
// weight (K, N) in 64 x 64 boxes; ty: y (M, N) in 64 x 64 boxes.  A
// cluster of CM blocks takes CM row tiles of one column tile at a time;
// weight box h of a stage is loaded by rank h % CM into every rank's
// shared memory, so each empty barrier counts the consumer warps of the
// whole cluster.
template <int BOXES, int CM>
__global__ void __launch_bounds__(kWgThreads, 1)
fold_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap ty, const __nv_bfloat16* __restrict__ bias,
            int m, int n, int k, int act) {
  using C = FoldCfg<BOXES>;
  extern __shared__ __align__(16) unsigned char fold_smem[];
  unsigned char* ring = fold_smem + ((1024 - (smem_u32(fold_smem) & 1023)) & 1023);
  unsigned char* out = ring + C::STAGES * C::STAGE;  // 1024-aligned: STAGE is a multiple
  uint64_t* full = reinterpret_cast<uint64_t*>(out + C::OUT);
  uint64_t* empty = full + C::STAGES;

  const uint32_t rank = CM > 1 ? cluster_rank() : 0;
  const int mg = ((m + kWgBM - 1) / kWgBM + CM - 1) / CM;  // groups of CM row tiles
  const int groups = mg * ((n + C::BN - 1) / C::BN);
  const int ktiles = (k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;
  const int cluster_id = blockIdx.x / CM, clusters = gridDim.x / CM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);        // the producer's arrival, plus the TMA bytes
      mbar_init(&empty[s], 8 * CM);  // one arrival a consumer warp of the cluster
    }
    fence_barrier_init();
  }
  if constexpr (CM > 1) {
    cluster_sync();  // every rank's barriers are initialised before a peer uses them
  } else {
    __syncthreads();
  }

  if (wg == 2) {
    // producer: one thread walks the cluster's groups and their stages
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = cluster_id; t < groups; t += clusters) {
        const int m0 = ((t % mg) * CM + (int)rank) * kWgBM, n0 = (t / mg) * C::BN;
        const int boxes = min(BOXES, (n - n0 + 63) / 64);  // a box wholly past N is not loaded
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // every consumer is done with it
          unsigned char* st = ring + stage * C::STAGE;
          mbar_arrive_expect_tx(&full[stage], C::A_BYTES + boxes * kWgBox);
          tma_load_2d(st, &tx, kt * kWgBK, m0, &full[stage]);
          for (int h = (int)rank; h < boxes; h += CM) {
            unsigned char* dst = st + C::A_BYTES + h * kWgBox;
            if constexpr (CM > 1) {
              tma_load_2d_multicast(dst, &tw, n0 + 64 * h, kt * kWgBK, &full[stage],
                                    (uint16_t)((1 << CM) - 1));
            } else {
              tma_load_2d(dst, &tw, n0 + 64 * h, kt * kWgBK, &full[stage]);
            }
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // every stage released for the last time, by the peers' consumers
      // too: no peer arrives on this block's barriers after it exits
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer `wg`: rows 64 wg .. 64 wg + 63 of each tile
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's TMA stores
    // acc: the wgmma accumulators of the current run of kPromoteK columns
    // of K; tot: the sum of the finished runs, added with round-to-nearest,
    // and at a tile's end its whole sum, written while the next tile's
    // first stages run in acc
    float acc[C::ACC], tot[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) tot[i] = 0.f;
    unsigned char* ob = out + wg * 64 * 128;  // this consumer's rows of each output box
    const int r0 = warp * 16 + lane / 4;      // its first row in them
    const bool bias2 = (reinterpret_cast<uintptr_t>(bias) & 3) == 0;  // bf16 pairs aligned
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    int pm0 = -1, pn0 = 0;  // the tile whose sums tot holds, not yet written

    // stage s released to every producer of the cluster
    auto release = [&](int s) {
      if constexpr (CM > 1) {
#pragma unroll
        for (int r = 0; r < CM; ++r) mbar_arrive_cluster(&empty[s], r);
      } else {
        mbar_arrive(&empty[s]);
      }
    };
    // the next k-tile's products issued into acc; the stage before released
    // once its products have retired
    auto step = [&]() {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(ring + stage * C::STAGE) + wg * 64 * 128;
      const uint32_t b = smem_u32(ring + stage * C::STAGE + C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da = wgmma_desc_k_major(a + kk * 32);
        wgmma_bt<BOXES>(acc, da, wgmma_desc_mn_major(b + kk * 16 * 128, kWgBox));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) release(prev);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // part `P` of kEpiParts of tot's tile: the bias and the activation in
    // fp32, one cast, into the staged output boxes in TMA's 128-byte
    // swizzle (the 16-byte chunk c of row r at chunk c ^ (r % 8): a warp's
    // stores fall in 32 banks)
    auto epilogue_part = [&](auto part) {
      constexpr int P = decltype(part)::value, JP = C::ACC / 4 / kEpiParts;
      with_act(act, [&](auto a) {
        constexpr int A = decltype(a)::value;
#pragma unroll
        for (int j = P * JP; j < (P + 1) * JP; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          float b0 = 0.f, b1 = 0.f;
          if (bias != nullptr && pn0 + c < n) {
            if (bias2) {  // one 4-byte load for the thread's two columns
              const float2 bb = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(bias + pn0 + c));
              b0 = bb.x;
              b1 = bb.y;
            } else {
              b0 = __bfloat162float(bias[pn0 + c]);
              b1 = __bfloat162float(bias[pn0 + c + 1]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h, e = 4 * j + 2 * h;
            const float v0 = act_bf16<A>(tot[e] + b0);
            const float v1 = act_bf16<A>(tot[e + 1] + b1);
            *reinterpret_cast<__nv_bfloat162*>(ob + (c / 64) * C::OUT_BOX + r * 128 +
                                               ((((c % 64) / 8) ^ (r & 7)) << 4) + (c % 8) * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      });
    };
    // the staged boxes of tot's tile stored by TMA, tot cleared
    auto store = [&]() {
      fence_proxy_async();  // the generic writes, before the TMA store reads them
      named_bar_sync(1 + wg, 128);
      if (leader) {
        for (int h = 0; h < BOXES && pn0 + 64 * h < n; ++h)
          tma_store_2d(&ty, ob + h * C::OUT_BOX, pn0 + 64 * h, pm0 + wg * 64);
        bulk_commit();
      }
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) tot[i] = 0.f;
      pm0 = -1;
    };
    // the finished run of kPromoteK columns of K added into tot
    auto fold = [&]() {
      wgmma_wait<0>();  // its products have retired
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) {
        reg_fence(acc[i]);
        tot[i] += acc[i];
        acc[i] = 0.f;
        reg_fence(acc[i]);
      }
    };
    // the staging boxes free again: the last tile's TMA stores have read them
    auto staging_free = [&]() {
      if (leader) bulk_wait_read<0>();
      named_bar_sync(1 + wg, 128);
    };

    for (int t = cluster_id; t < groups; t += clusters) {
      const int m0 = ((t % mg) * CM + (int)rank) * kWgBM, n0 = (t / mg) * C::BN;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) {
        acc[i] = 0.f;
        reg_fence(acc[i]);
      }
      prev = -1;
      int kt = 0;
      if (pm0 >= 0) {
        // the last tile's epilogue, a part after each of this tile's first
        // kEpiParts stages is issued, both consumers at once (staggering
        // them measured slower: the one ahead waits on the ring for the
        // other); no fold falls among them
        staging_free();
        static_for<kEpiParts>([&](auto part) {
          if (kt < ktiles) {
            step();
            ++kt;
          }
          epilogue_part(part);
        });
        store();
      }
      for (; kt < ktiles; ++kt) {
        step();
        if ((kt + 1) % (kPromoteK / kWgBK) == 0 && kt + 1 < ktiles) fold();
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) release(prev);
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) {
        reg_fence(acc[i]);
        tot[i] += acc[i];
      }
      pm0 = m0;
      pn0 = n0;
    }
    if (pm0 >= 0) {  // the block's last tile
      staging_free();
      static_for<kEpiParts>([&](auto part) { epilogue_part(part); });
      store();
    }
    if (leader) bulk_wait<0>();
  }
}

template <int BOXES, int CM>
int launch_fold(const void* x, long long lda, const void* w, const void* bias, void* y, int m,
                int n, int k, int act, cudaStream_t stream) {
  using C = FoldCfg<BOXES>;
  auto kernel = fold_kernel<BOXES, CM>;
  static std::atomic<int> sms[kMaxDevices], fit[kMaxDevices];
  int sm_count = 0;
  int err = kernel_setup(kernel, C::SMEM, sms, sm_count);
  if (err) return err;
  CUtensorMap tx = {}, tw = {}, ty = {};
  err = encode_bf16_2d(&ty, y, m, n, 2ll * n, 64, 64);
  if (!err && k > 0) {  // with K = 0 nothing is loaded
    err = encode_bf16_2d(&tx, x, m, k, 2 * lda, kWgBM, kWgBK);
    if (!err) err = encode_bf16_2d(&tw, w, k, n, 2ll * n, kWgBK, 64);
  }
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CM;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters that fit the card at once, asked once per device
  int dev = 0;
  cudaGetDevice(&dev);
  int most = fit[dev].load(std::memory_order_acquire);
  if (most <= 0) {
    cfg.gridDim = dim3(CM * (sm_count / CM));
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (most <= 0) return (int)cudaErrorInvalidConfiguration;
    fit[dev].store(most, std::memory_order_release);
  }
  const int groups = (((m + kWgBM - 1) / kWgBM + CM - 1) / CM) * ((n + C::BN - 1) / C::BN);
  cfg.gridDim = dim3(CM * min(most, groups));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tx, tw, ty,
                                           static_cast<const __nv_bfloat16*>(bias), m, n, k, act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 gated MLP, M > 48: 128 x 128 tiles a weight, its accumulators
// unfolded
// ---------------------------------------------------------------------------

struct WgCfg {
  static constexpr int A_BYTES = kWgBM * kWgBK * 2;  // x's tile, 16 KB
  static constexpr int B_BYTES = 2 * kWgBox;         // a weight's tile, 16 KB
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;  // 48 KB
  static constexpr int STAGES = 4;
  // 1024 bytes to align the ring to the swizzle atom, the ring, and a
  // full and an empty mbarrier a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// tx: x (M, K) in 128 x 64 boxes; tw0, tw1: the weights (K, N) in 64 x 64
// boxes.  Each consumer holds 64 rows x 128 columns of both weights'
// accumulators (128 fp32 registers a thread), so there is no room for
// fp32 totals: the sum over K runs in the tensor cores' accumulator alone
// (at K 18432 it stays within ref.gated_matmul_limit on the card:
// test_torch_gpu.py's long-K gated test).
__global__ void __launch_bounds__(kWgThreads, 1)
wg_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw0,
          const __grid_constant__ CUtensorMap tw1, __nv_bfloat16* __restrict__ y, int m, int n,
          int k, int act) {
  using C = WgCfg;
  constexpr int kWgBN = 128;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* ring = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;

  const int mt = (m + kWgBM - 1) / kWgBM;
  const int tiles = mt * ((n + kWgBN - 1) / kWgBN);
  const int ktiles = (k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread walks the block's tiles and their stages
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const CUtensorMap* const tw[2] = {&tw0, &tw1};
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % mt) * kWgBM, n0 = (t / mt) * kWgBN;
        const int boxes = n0 + 64 < n ? 2 : 1;  // a box wholly past N is not loaded
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // both consumers are done with it
          unsigned char* st = ring + stage * C::STAGE;
          mbar_arrive_expect_tx(&full[stage], C::A_BYTES + 2 * boxes * kWgBox);
          tma_load_2d(st, &tx, kt * kWgBK, m0, &full[stage]);
#pragma unroll
          for (int g = 0; g < 2; ++g)
            for (int h = 0; h < boxes; ++h)
              tma_load_2d(st + C::A_BYTES + g * C::B_BYTES + h * kWgBox, tw[g], n0 + 64 * h,
                          kt * kWgBK, &full[stage]);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer `wg`: rows 64 wg .. 64 wg + 63 of each tile
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    float acc[2][64];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * kWgBM, n0 = (t / mt) * kWgBN;
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          acc[g][i] = 0.f;
          reg_fence(acc[g][i]);
        }
      int prev = -1;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(ring + stage * C::STAGE) + wg * 64 * 128;
        const uint32_t b = smem_u32(ring + stage * C::STAGE + C::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          const uint64_t da = wgmma_desc_k_major(a + kk * 32);
#pragma unroll
          for (int g = 0; g < 2; ++g)
            wgmma_m64n128k16_bf16_bt(
                acc[g], da, wgmma_desc_mn_major(b + g * C::B_BYTES + kk * 16 * 128, kWgBox));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before's products have retired: release it
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[g][i]);

      // epilogue in registers: the gate's activation in fp32 times the up
      // product, one cast (n is even, so a thread's two columns are both
      // in range or both out)
      const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
      const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j;
        if (col >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= m) continue;
          const int e = 4 * j + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * n + col) =
              __floats2bfloat162_rn(apply_act(acc[0][e], act) * acc[1][e],
                                    apply_act(acc[0][e + 1], act) * acc[1][e + 1]);
        }
      }
    }
  }
}

int launch_wg(const void* x, long long lda, const void* w0, const void* w1, void* y, int m,
              int n, int k, int act, cudaStream_t stream) {
  using C = WgCfg;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  int err = kernel_setup(wg_kernel, C::SMEM, sms, sm_count);
  if (err) return err;
  CUtensorMap tx = {}, tw0 = {}, tw1 = {};
  if (k > 0) {  // with K = 0 nothing is loaded
    err = encode_bf16_2d(&tx, x, m, k, 2 * lda, kWgBM, kWgBK);
    if (!err) err = encode_bf16_2d(&tw0, w0, k, n, 2ll * n, kWgBK, 64);
    if (!err) err = encode_bf16_2d(&tw1, w1, k, n, 2ll * n, kWgBK, 64);
    if (err) return err;
  }
  const int tiles = ((m + kWgBM - 1) / kWgBM) * ((n + 127) / 128);
  wg_kernel<<<min(sm_count, tiles), kWgThreads, C::SMEM, stream>>>(
      tx, tw0, tw1, static_cast<__nv_bfloat16*>(y), m, n, k, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32, M > 8: a pipelined SGEMM on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFpThreads = 256;   // a 16 x 16 grid of threads
constexpr int kFpBM = 128;        // rows a block
constexpr int kFpBN = 256;        // columns a block, over its weights
constexpr int kFpBK = 16;         // K a stage
constexpr int kFpStages = 3;      // stages of the ring
constexpr int kFpAV = kFpBM * kFpBK / 4 / kFpThreads;  // x chunks a thread copies a stage

template <bool GATED>
struct FpCfg {
  static constexpr int NW = GATED ? 2 : 1;
  static constexpr int BN = kFpBN / NW;          // columns a block, per weight
  static constexpr int TN = BN / 16;             // columns a thread holds, per weight
  static constexpr int XT = kFpBK * kFpBM;       // x's tile, transposed (floats)
  static constexpr int B_TILE = kFpBK * kFpBN;   // the weights' tiles (floats)
  // two transposed x tiles, then the ring: the weights' tiles, x's raw tiles
  static constexpr int SMEM = (2 * XT + kFpStages * (B_TILE + XT)) * 4;
  static_assert(TN % 4 == 0 && kFpAV * 4 * kFpThreads == kFpBM * kFpBK, "tiles");
};

// Thread (ty, tx) owns rows {ty*4 + i%4 + 64*(i/4)} and, of each weight,
// columns {tx*4 + j%4 + 64*(j/4)} of the block tile: 8 rows x 16 columns
// (8 a weight when gated), 128 accumulators, so one block of 256 threads
// an SM.  Both operands go through a three-stage cp.async ring as they lie
// in memory, zero-filled without a read outside the matrices (K and N are
// multiples of 4, so a 16-byte chunk is all inside or all outside).
// Thread t copies x's chunks of row t % 128 and, once they have landed,
// writes them transposed (xt[k][row]) into one of two buffers, so that
// each k step reads two float4 of x and four of the weights for 128 FMAs,
// with no bank conflict.
template <bool GATED>
__global__ void __launch_bounds__(kFpThreads, 1)
fp_tiled_kernel(const float* __restrict__ x, long long lda, const float* __restrict__ w0,
                const float* __restrict__ w1, const float* __restrict__ bias,
                float* __restrict__ y, int m, int n, int k, int act) {
  using C = FpCfg<GATED>;
  constexpr int NW = C::NW, BN = C::BN, TN = C::TN;
  extern __shared__ __align__(16) float fsmem[];
  float* xt = fsmem;                       // [2][BK][BM]
  float* bs = xt + 2 * C::XT;              // [stage][g][BK][BN]
  float* xr = bs + kFpStages * C::B_TILE;  // [stage][BM][BK]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kFpBM, n0 = blockIdx.y * BN;
  const int arow = tid % kFpBM, akc = tid / kFpBM;  // x chunks (akc + 2v) * 4 of row arow
  const float* const w[2] = {w0, w1};

  auto load = [&](int st, int k0) {
    float* xd = xr + st * C::XT;
#pragma unroll
    for (int v = 0; v < kFpAV; ++v) {
      const int kc = (akc + 2 * v) * 4;
      const bool ok = m0 + arow < m && k0 + kc < k;
      cp_async16(xd + arow * kFpBK + kc, ok ? x + (long long)(m0 + arow) * lda + k0 + kc : x,
                 ok);
    }
    float* bd = bs + st * C::B_TILE;
#pragma unroll
    for (int g = 0; g < NW; ++g) {
#pragma unroll
      for (int c = tid; c < kFpBK * BN / 4; c += kFpThreads) {
        const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
        const bool ok = k0 + r < k && n0 + nc < n;
        cp_async16(bd + (g * kFpBK + r) * BN + nc,
                   ok ? w[g] + (long long)(k0 + r) * n + n0 + nc : w[g], ok);
      }
    }
  };
  // the chunks this thread copied into stage `st`, transposed into buffer `buf`
  auto transpose = [&](int st, int buf) {
    const float* xs = xr + st * C::XT;
#pragma unroll
    for (int v = 0; v < kFpAV; ++v) {
      const int kc = (akc + 2 * v) * 4;
      const float4 t = *reinterpret_cast<const float4*>(xs + arow * kFpBK + kc);
      float* d = xt + (buf * kFpBK + kc) * kFpBM + arow;
      d[0] = t.x;
      d[kFpBM] = t.y;
      d[2 * kFpBM] = t.z;
      d[3 * kFpBM] = t.w;
    }
  };

  float acc[NW][8][TN];
#pragma unroll
  for (int g = 0; g < NW; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[g][i][j] = 0.f;

  const int ktiles = (k + kFpBK - 1) / kFpBK;
#pragma unroll
  for (int s = 0; s < kFpStages - 1; ++s) {
    if (s < ktiles) load(s, s * kFpBK);
    cp_async_commit();
  }
  cp_async_wait<kFpStages - 2>();
  if (ktiles > 0) transpose(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kFpStages - 2>();
    __syncthreads();  // tile kt is in xt[kt & 1] and its stage; every thread is done with kt - 1
    const int nk = kt + kFpStages - 1;
    if (nk < ktiles) load(nk % kFpStages, nk * kFpBK);
    cp_async_commit();

    const float* at = xt + (kt & 1) * C::XT;
    const float* bt = bs + (kt % kFpStages) * C::B_TILE;
#pragma unroll
    for (int kk = 0; kk < kFpBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(at + kk * kFpBM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(at + kk * kFpBM + 64 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int g = 0; g < NW; ++g) {
        float b[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(bt + (g * kFpBK + kk) * BN + q * 64 + tx * 4);
          b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[g][i][j] = fmaf(a[i], b[j], acc[g][i][j]);
      }
    }
    if (kt + 1 < ktiles) {
      cp_async_wait<kFpStages - 2>();  // tile kt + 1's chunks this thread copied
      transpose((kt + 1) % kFpStages, (kt + 1) & 1);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int col = n0 + q * 64 + tx * 4;
      if (col >= n) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        if (GATED) {
          v[e] = apply_act(acc[0][i][j], act) * acc[NW - 1][i][j];
        } else {
          v[e] = apply_act(acc[0][i][j] + (bias != nullptr ? bias[col + e] : 0.f), act);
        }
      }
      *reinterpret_cast<float4*>(y + (long long)row * n + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, M <= 8: stream the weights
// ---------------------------------------------------------------------------

constexpr int kSkCols = 16;                  // columns a block owns
constexpr int kSkGroups = kFpThreads / 4;    // K groups of 4 threads (a float4 each)
constexpr int kSkWarps = kFpThreads / 32;

// A block owns 16 columns (1024 blocks at N = 16384, so that each SM holds
// several and keeps many loads in flight); thread (kg, c4) reads rows kb..kb
// + 3 of its float4 of columns for kb = 4 kg, 4 kg + 256, ..., two such
// batches in flight, each against every row of x.  The 8 K groups of a warp
// meet by shuffles, the warps in shared memory, in a fixed order.
template <int MR, bool GATED>
__global__ void __launch_bounds__(kFpThreads)
fp_skinny_kernel(const float* __restrict__ x, long long lda, const float* __restrict__ w0,
                 const float* __restrict__ w1, const float* __restrict__ bias,
                 float* __restrict__ y, int m, int n, int k, int act) {
  constexpr int NW = GATED ? 2 : 1;
  __shared__ float red[kSkWarps][NW][MR][kSkCols];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c4 = tid % 4, kg = tid / 4;
  const int n0 = blockIdx.x * kSkCols, col = n0 + c4 * 4;
  const float* const w[2] = {w0, w1};

  float acc[NW][MR][4];
#pragma unroll
  for (int g = 0; g < NW; ++g)
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][r][e] = 0.f;

  if (col < n) {
#pragma unroll 2
    for (int kb = kg * 4; kb < k; kb += 4 * kSkGroups) {
      float4 wv[NW][4];
#pragma unroll
      for (int g = 0; g < NW; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[g][i] = __ldg(reinterpret_cast<const float4*>(w[g] + (long long)(kb + i) * n + col));
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= m) break;
        const float4 xv = __ldg(reinterpret_cast<const float4*>(x + (long long)r * lda + kb));
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int g = 0; g < NW; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[g][r][0] = fmaf(xs[i], wv[g][i].x, acc[g][r][0]);
            acc[g][r][1] = fmaf(xs[i], wv[g][i].y, acc[g][r][1]);
            acc[g][r][2] = fmaf(xs[i], wv[g][i].z, acc[g][r][2]);
            acc[g][r][3] = fmaf(xs[i], wv[g][i].w, acc[g][r][3]);
          }
      }
    }
  }

  // lanes l, l ^ 4, l ^ 8, ... hold the same columns for the warp's 8 K groups
#pragma unroll
  for (int g = 0; g < NW; ++g)
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int sh = 4; sh < 32; sh *= 2)
          acc[g][r][e] += __shfl_xor_sync(0xffffffffu, acc[g][r][e], sh);
  if (lane < 4) {
#pragma unroll
    for (int g = 0; g < NW; ++g)
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][g][r][c4 * 4 + e] = acc[g][r][e];
  }
  __syncthreads();
  for (int o = tid; o < MR * kSkCols; o += kFpThreads) {
    const int r = o / kSkCols, c = o % kSkCols;
    if (r >= m || n0 + c >= n) continue;
    float s[NW];
#pragma unroll
    for (int g = 0; g < NW; ++g) {
      s[g] = 0.f;
#pragma unroll
      for (int q = 0; q < kSkWarps; ++q) s[g] += red[q][g][r][c];
    }
    float v;
    if (GATED) {
      v = apply_act(s[0], act) * s[NW - 1];
    } else {
      v = apply_act(s[0] + (bias != nullptr ? bias[n0 + c] : 0.f), act);
    }
    y[(long long)r * n + n0 + c] = v;
  }
}

template <int MR, bool GATED>
int launch_skinny(const float* x, long long lda, const float* w0, const float* w1,
                  const float* bias, float* y, int m, int n, int k, int act,
                  cudaStream_t stream) {
  fp_skinny_kernel<MR, GATED><<<(n + kSkCols - 1) / kSkCols, kFpThreads, 0, stream>>>(
      x, lda, w0, w1, bias, y, m, n, k, act);
  return (int)cudaGetLastError();
}

template <bool GATED>
int launch_fp(const void* x, long long lda, const void* w0, const void* w1, const void* bias,
              void* y, int m, int n, int k, int act, cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  const float* w0f = static_cast<const float*>(w0);
  const float* w1f = static_cast<const float*>(w1);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (m <= 8) {
    if (m <= 1) return launch_skinny<1, GATED>(xf, lda, w0f, w1f, bf, yf, m, n, k, act, stream);
    if (m <= 2) return launch_skinny<2, GATED>(xf, lda, w0f, w1f, bf, yf, m, n, k, act, stream);
    if (m <= 4) return launch_skinny<4, GATED>(xf, lda, w0f, w1f, bf, yf, m, n, k, act, stream);
    return launch_skinny<8, GATED>(xf, lda, w0f, w1f, bf, yf, m, n, k, act, stream);
  }
  using C = FpCfg<GATED>;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(fp_tiled_kernel<GATED>, C::SMEM, sms, sm_count);
  if (err) return err;
  const dim3 grid((m + kFpBM - 1) / kFpBM, (n + C::BN - 1) / C::BN);
  fp_tiled_kernel<GATED><<<grid, kFpThreads, C::SMEM, stream>>>(xf, lda, w0f, w1f, bf, yf, m, n,
                                                                 k, act);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

int dispatch(const void* x, long long lda, const void* w0, const void* w1, const void* bias,
             void* y, int dtype, int m, int n, int k, int act, bool gated, void* stream) {
  if (m < 0 || n < 0 || k < 0 || act < kNone || act > kSilu || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int lanes = dtype == 0 ? 4 : 8;   // elements in 16 bytes
  if (k % lanes || n % lanes || lda % lanes || !aligned16(x) || !aligned16(w0) ||
      !aligned16(w1) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return gated ? launch_fp<true>(x, lda, w0, w1, bias, y, m, n, k, act, s)
                 : launch_fp<false>(x, lda, w0, w1, bias, y, m, n, k, act, s);
  }
  if (m <= 48) {
    return gated ? launch_tc<TcDecode>(x, lda, w0, w1, y, m, n, k, act, s)
                 : launch_split_rows(x, lda, w0, bias, y, m, n, k, act, s);
  }
  return gated ? launch_wg(x, lda, w0, w1, y, m, n, k, act, s)
               : launch_fold<3, 2>(x, lda, w0, bias, y, m, n, k, act, s);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, the weights, the bias and y alike).
// x (M, K) with row stride lda and a unit column stride; w, w_gate, w_up
// (K, N) and y (M, N) contiguous; bias (N,) or null.  K, N and lda are
// multiples of 16 bytes' elements, x, the weights and y 16-byte aligned.  act: 0 none, 1 relu,
// 2 relu2, 3 gelu (tanh form), 4 silu.  Returns the launch's cudaError.
static int hete_matmul_impl(const void* x, long long lda, const void* w, const void* bias,
                            void* y, int dtype, int m, int n, int k, int act, void* stream) {
  return dispatch(x, lda, w, w, bias, y, dtype, m, n, k, act, false, stream);
}

static int hete_gated_matmul_impl(const void* x, long long lda, const void* w_gate,
                                  const void* w_up, void* y, int dtype, int m, int n, int k,
                                  int act, void* stream) {
  return dispatch(x, lda, w_gate, w_up, nullptr, y, dtype, m, n, k, act, true, stream);
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int hete_matmul(const long long* args) {
  return call_packed(hete_matmul_impl, args);
}
extern "C" int hete_gated_matmul(const long long* args) {
  return call_packed(hete_gated_matmul_impl, args);
}
