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
// What bounds it on the H100.  Prefill (M = B * S, hundreds to thousands
//   of rows) is bound by operations: at Mistral-NeMo-12B's gated MLP (2048 x
//   5120 -> 14336, two products) 6.0e11 bf16 FLOPs, 0.61 ms at 989 TFLOP/s;
//   at OPT-6.7B's fc1 (256 x 4096 -> 16384, fp32) 3.4e10 FLOPs, 0.51 ms at
//   67 TFLOP/s.  Decode (M = batch = 4) is bound by the weights' bytes: 294 MB
//   of bf16 gate and up weights (0.088 ms at 3.35 TB/s), 268 MB of fp32 fc1.
//
// Design:
//   * bf16, M > 48: wgmma fed by TMA, one persistent block an SM.  Only
//     wgmma reaches the card's full bf16 tensor-core rate, so each block
//     runs three warpgroups: a producer (its registers cut to 40 by
//     setmaxnreg) whose one thread issues the TMA loads, and two consumers
//     (232 registers) that each own 64 rows x 128 columns of every
//     weight's accumulator (gate and up: 128 fp32 registers a thread).  A
//     stage holds x's 128 x 64 tile (K-major, the A operand) and each
//     weight's 64 x 128 tile as two 64-column boxes (the weights lie
//     (K, N) with N contiguous: an MN-major B, wgmma's transpose flag, no
//     copy of the weights), all 128-byte swizzled by TMA; four stages of
//     48 KB (six of 32 KB for one weight) with a full and an empty
//     mbarrier each.  A consumer issues, per 16-deep k step, one
//     m64n128k16 wgmma a weight, keeps one group in flight and releases a
//     stage when its group retires; with one weight it folds its
//     accumulator into an fp32 total every 512 columns of K (kPromoteK).  Output tiles of 128 x 128 are walked
//     with M fastest, so the blocks in flight share weight tiles through
//     the 50 MB L2; a consumer's epilogue (bias or gate, activation, one
//     cast, masked bf16x2 stores from registers) overlaps the producer's
//     loads for the next tile.  TMA zero-fills rows past M and a K tail;
//     a weight box wholly past N is not loaded, and columns past N are not
//     stored.  x's tensor map carries its row stride, so a strided x is
//     read in place.
//   * bf16, M <= 48: tensor-core tiles on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), 16 rows and 64 columns a block, so that N spreads over
//     every SM (224 blocks at N = 14336) and each block keeps four 16 KB
//     weight stages in flight through a cp.async ring (rows padded by 16
//     bytes so ldmatrix is free of bank conflicts); each warp loads its A
//     fragments with ldmatrix and its B fragments with ldmatrix.trans and
//     keeps its accumulators, one set per weight, in registers, folded
//     into fp32 totals every kPromoteK columns of K, where the epilogue
//     runs.
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
//   No kernel splits K or uses atomics: two calls give the same bits.
//   Every load and store of x, the weights and y is 16 bytes wide (TMA
//   needs the same), so K, N and x's row stride are multiples of 8 (bf16)
//   or 4 (fp32) elements and the operands are 16-byte aligned; the entry
//   points refuse anything else.

#include "device_helpers.h"
#include "hopper_helpers.h"
#include "launch_args.h"

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
// fp32 total with round-to-nearest (the one-weight wgmma kernel; the
// mma.sync kernel for either); the total's error then grows like an fp32
// sum's.
constexpr int kPromoteK = 512;

// ---------------------------------------------------------------------------
// bf16, M <= 48: tensor-core tiles on mma.sync
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

template <class C, bool GATED>
__global__ void __launch_bounds__(C::kThreads)
tc_kernel(const __nv_bfloat16* __restrict__ x, long long lda,
          const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
          const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, int m,
          int n, int k, int act) {
  constexpr int NW = GATED ? 2 : 1;
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

  // epilogue in registers: bias and activation in fp32, one cast (n is
  // even, so a thread's two columns are both in range or both out)
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int col = n0 + wn * C::WTN + j * 8 + tig * 2;
      if (col >= n) continue;
      float b0 = 0.f, b1 = 0.f;
      if (!GATED && bias != nullptr) {
        b0 = __bfloat162float(bias[col]);
        b1 = __bfloat162float(bias[col + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * C::WTM + i * 16 + gid + h * 8;
        if (row >= m) continue;
        float v0, v1;
        if (GATED) {
          v0 = apply_act(tot[0][i][j][2 * h], act) * tot[NW - 1][i][j][2 * h];
          v1 = apply_act(tot[0][i][j][2 * h + 1], act) * tot[NW - 1][i][j][2 * h + 1];
        } else {
          v0 = apply_act(tot[0][i][j][2 * h] + b0, act);
          v1 = apply_act(tot[0][i][j][2 * h + 1] + b1, act);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <class C, bool GATED>
int launch_tc(const void* x, long long lda, const void* w0, const void* w1, const void* bias,
              void* y, int m, int n, int k, int act, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<C, GATED ? 2 : 1>();
  cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<C, GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + C::BM - 1) / C::BM, (n + C::BN - 1) / C::BN);
  tc_kernel<C, GATED><<<grid, C::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), lda, static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), m, n, k, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, M > 48: wgmma fed by TMA, warp-specialized, persistent
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;          // rows a tile, 64 a consumer warpgroup
constexpr int kWgBN = 128;          // columns a tile, of each weight
constexpr int kWgBK = 64;           // K a stage: one 128-byte swizzled row
constexpr int kWgThreads = 384;     // consumer warpgroups 0 and 1, the producer 2
constexpr int kWgBox = kWgBK * 64 * 2;  // one 64-column box of a weight's stage tile

template <bool GATED>
struct WgCfg {
  static constexpr int NW = GATED ? 2 : 1;
  static constexpr int A_BYTES = kWgBM * kWgBK * 2;     // x's tile, 16 KB
  static constexpr int B_BYTES = 2 * kWgBox;            // a weight's tile, 16 KB
  static constexpr int STAGE = A_BYTES + NW * B_BYTES;  // 48 KB gated, 32 KB not
  static constexpr int STAGES = GATED ? 4 : 6;          // 192 KB of ring either way
  // 1024 bytes to align the ring to the swizzle atom, the ring, and a
  // full and an empty mbarrier a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// See the notes at the top.  tx: x (M, K) in 128 x 64 boxes; tw0, tw1: the
// weights (K, N) in 64 x 64 boxes (tw1 unused for one weight).
template <bool GATED>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw0,
          const __grid_constant__ CUtensorMap tw1, const __nv_bfloat16* __restrict__ bias,
          __nv_bfloat16* __restrict__ y, int m, int n, int k, int act) {
  using C = WgCfg<GATED>;
  constexpr int NW = C::NW;
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
          mbar_arrive_expect_tx(&full[stage], C::A_BYTES + NW * boxes * kWgBox);
          tma_load_2d(st, &tx, kt * kWgBK, m0, &full[stage]);
#pragma unroll
          for (int g = 0; g < NW; ++g)
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
    float acc[NW][64];
    // one weight: the total of the finished kPromoteK runs of K (two
    // weights' totals would not fit the 232 registers beside the
    // accumulators)
    float tot[GATED ? 1 : 64];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * kWgBM, n0 = (t / mt) * kWgBN;
#pragma unroll
      for (int g = 0; g < NW; ++g)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          acc[g][i] = 0.f;
          reg_fence(acc[g][i]);
        }
      if constexpr (!GATED) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] = 0.f;
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
          for (int g = 0; g < NW; ++g)
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
        if constexpr (!GATED) {
          if ((kt + 1) % (kPromoteK / kWgBK) == 0 && kt + 1 < ktiles) {
            wgmma_wait<0>();  // this run's products have retired: fold it in
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              reg_fence(acc[0][i]);
              tot[i] += acc[0][i];
              acc[0][i] = 0.f;
              reg_fence(acc[0][i]);
            }
          }
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int g = 0; g < NW; ++g)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[g][i]);
      if constexpr (!GATED) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += tot[i];
      }

      // epilogue in registers: bias or gate and the activation in fp32,
      // one cast (n is even, so a thread's two columns are both in range
      // or both out)
      const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
      const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j;
        if (col >= n) continue;
        float b0 = 0.f, b1 = 0.f;
        if (!GATED && bias != nullptr) {
          b0 = __bfloat162float(bias[col]);
          b1 = __bfloat162float(bias[col + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= m) continue;
          const int e = 4 * j + 2 * h;
          float v0, v1;
          if (GATED) {
            v0 = apply_act(acc[0][e], act) * acc[NW - 1][e];
            v1 = apply_act(acc[0][e + 1], act) * acc[NW - 1][e + 1];
          } else {
            v0 = apply_act(acc[0][e] + b0, act);
            v1 = apply_act(acc[0][e + 1] + b1, act);
          }
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * n + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <bool GATED>
int launch_wg(const void* x, long long lda, const void* w0, const void* w1, const void* bias,
              void* y, int m, int n, int k, int act, cudaStream_t stream) {
  using C = WgCfg<GATED>;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  int err = kernel_setup(wg_kernel<GATED>, C::SMEM, sms, sm_count);
  if (err) return err;
  CUtensorMap tx = {}, tw0 = {}, tw1 = {};
  if (k > 0) {  // with K = 0 nothing is loaded
    err = encode_bf16_2d(&tx, x, m, k, 2 * lda, kWgBM, kWgBK);
    if (!err) err = encode_bf16_2d(&tw0, w0, k, n, 2ll * n, kWgBK, 64);
    if (!err && GATED) err = encode_bf16_2d(&tw1, w1, k, n, 2ll * n, kWgBK, 64);
    if (err) return err;
  }
  const int tiles = ((m + kWgBM - 1) / kWgBM) * ((n + kWgBN - 1) / kWgBN);
  wg_kernel<GATED><<<min(sm_count, tiles), kWgThreads, C::SMEM, stream>>>(
      tx, tw0, tw1, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), m,
      n, k, act);
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
    return gated ? launch_tc<TcDecode, true>(x, lda, w0, w1, bias, y, m, n, k, act, s)
                 : launch_tc<TcDecode, false>(x, lda, w0, w1, bias, y, m, n, k, act, s);
  }
  return gated ? launch_wg<true>(x, lda, w0, w1, bias, y, m, n, k, act, s)
               : launch_wg<false>(x, lda, w0, w1, bias, y, m, n, k, act, s);
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
