// Flash attention (prefill): Sq query rows attend over Skv key rows, query i
// at position i and key j at position j, causal or not, optionally within a
// sliding window and with a softcap; GQA maps q-head h to kv-head
// h / (Hq / Hkv).  Built for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py · flash_attention
//   (_flash_kernel).
//
// What bounds it on the H100: operations.  4 * D FLOPs per unmasked
//   (query, key) pair against 2 * Skv * D elements of K/V; at the prompt
//   lengths served (hundreds of tokens) the kernel is far above the
//   memory ridge.
//
// Both kernels address Q, K and V through (batch, head, row) strides, so
//   strided views of a KV cache (the first Skv positions of the stacked
//   (B, Hkv, T, D) cache or of the backend's (B, T, Hkv, D) buffer) are read
//   in place, and write the output through its strides into the (B, Sq, Hq,
//   D) layout.  Key tiles wholly above a tile's last diagonal (causal) or
//   wholly before its first row's window are never loaded.  Masked (query,
//   key) pairs get p = 0 exactly (a select, not exp(-inf)), and key rows
//   outside [0, Skv) or past the tile's last diagonal are staged as zeros
//   without being read, so nothing past Skv, NaN included, reaches a valid
//   row; a row with no valid key writes 0.  The online softmax keeps m and l
//   in fp32 and l sums the unrounded p.  Ragged Sq and Skv are masked in the
//   kernel: nothing is padded.
//
// bf16: tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).  A block
//   of four warps owns 64 query rows, 16 a warp; the query tiles run
//   heaviest first (the last causal tile is the grid's first).  Q is staged
//   once with cp.async and each warp keeps its A fragments in registers (D
//   <= 128).  K/V tiles of 32 keys go through a ring of cp.async stages in
//   shared memory (one barrier a tile), rows padded by 16 bytes so that
//   ldmatrix (K) and ldmatrix.trans (V) are free of bank conflicts at every
//   head dim it is built for, each multiple of 16 up to 256 (a padded row
//   is D / 2 + 4 words, 4 past a multiple of 8, so the eight rows of an
//   ldmatrix phase fall on distinct banks whether or not D is a power of
//   two; above D = 128, Q's fragments are read from shared memory).  On the
//   card (3b's shape), 32-key tiles with three blocks an SM at D = 128 ran
//   6-10% faster than 64-key tiles with two; three or four stages were no
//   faster than two; 32 query rows a warp (each K/V fragment feeding two
//   mma) ran slower.  S = Q K^T stays in the mma accumulators; it is scaled
//   in fp32, softcapped and masked there, in base 2 (the scale times
//   log2(e), so that p is one exp2), the row max and sum are reduced over
//   the four threads of a quad with shuffles, and p is rounded to bf16
//   straight from the accumulator layout into the A fragments of the PV
//   mma (as the Pallas kernel rounds p to the value dtype), with no trip
//   through shared memory.  Templated on D (16,
//   32, 64, 128, 256); every row stride and base pointer is a multiple of 16
//   bytes (the wrapper refuses anything else).
//
// fp32: the CUDA cores, register-tiled (the fp32 design of
//   csrc/paged_prefill_attention.cu over dense strides; the step over a
//   tile is csrc/f32_attention.h, shared with it).  A block of 128
//   threads owns 32 query rows of one q-head; thread (tr, tk) = (tid / 16,
//   tid % 16) owns rows tr + 8i (i < 4) throughout: in Q K^T the keys tk +
//   16j (j < 2) of each 32-key tile, a 4 x 2 register patch summed over D by
//   float4 reads (Q rows a broadcast within the half-warp, K rows padded so
//   that the 16 lanes hit distinct banks); in P V the columns tk * 4 + 64c,
//   a 4 x D/16 patch of the output.  K/V tiles go through a two-stage
//   cp.async ring, the row max and sum reduce over the 16 lanes of the
//   half-warp with shuffles, and P crosses shared memory to the same 16
//   lanes (a __syncwarp, no barrier).  Any D up to 256, computed at a
//   padded width of 64, 128 or 256 with zeros staged past D; rows 16-byte
//   aligned are copied 16 bytes at a time, others 4.  At OPT-6.7B's prefill
//   (B 4, S 64, 32 heads, D 128) this ran at 0.0146 ms on the card against
//   0.0264 for a 3xTF32 tensor-core design of the same function
//   (tools/flash_f32_3xtf32.cu: 4 warps an SM, 3 mma a product and the
//   operand splits on its critical path; PERF.md).

#include "device_helpers.h"
#include "f32_attention.h"
#include "launch_args.h"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16 * kTcWarps;  // query rows a block
constexpr int kTcKeys = 32;             // keys a tile
constexpr int kTcStages = 2;            // K/V tiles in shared memory

template <int D>
struct TcCfg {
  static constexpr int RS = D + 8;                // padded shared row (elements)
  static constexpr int KT = D / 16;               // k-steps of Q K^T
  static constexpr int NT = kTcKeys / 8;          // n8 tiles of S
  static constexpr int DT = D / 8;                // n8 tiles of O
  static constexpr bool QREGS = D <= 128;         // Q fragments in registers
  // blocks an SM holds: at D = 128 a cap of 168 registers (three blocks)
  // beat two blocks of 197 on the card by 10%
  static constexpr int MIN_BLOCKS = D == 128 ? 3 : 1;
  static constexpr int SMEM = (kTcRows + 2 * kTcStages * kTcKeys) * RS * (int)sizeof(bf16);
  static_assert(D % 16 == 0 && D <= 256, "head dim");
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, TcCfg<D>::MIN_BLOCKS)
flash_tc_kernel(const bf16* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
                const bf16* __restrict__ k, const bf16* __restrict__ v, long long kv_sb,
                long long kv_sh, long long kv_ss, bf16* __restrict__ out, long long o_sb,
                long long o_sh, long long o_ss, int hq, int hkv, int sq, int skv,
                float scale, float softcap, int causal, int window) {
  using C = TcCfg<D>;
  constexpr int BN = kTcKeys, RS = C::RS, CPR = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kTcRows x RS
  bf16* ks = qs + kTcRows * RS;                   // kTcStages of BN x RS
  bf16* vs = ks + kTcStages * BN * RS;            // kTcStages of BN x RS

  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int last_q = min(q0 + kTcRows, sq) - 1;

  // the key range any row of the block can see
  const int k_hi = causal ? min(skv, last_q + 1) : skv;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * kv_sb + kvh * kv_sh;
  const bf16* vb = v + b * kv_sb + kvh * kv_sh;

  for (int i = tid; i < kTcRows * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = q0 + r < sq;
    cp_async16(qs + r * RS + c, ok ? qb + (q0 + r) * q_ss + c : qb, ok);
  }
  cp_async_commit();

  // K/V tile of keys [j0, j0 + BN) into `stage`; keys at or past k_hi are
  // zero-filled without a read
  auto load_kv = [&](int stage, int j0) {
    bf16* kd = ks + stage * BN * RS;
    bf16* vd = vs + stage * BN * RS;
    for (int i = tid; i < BN * CPR; i += kTcThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = j0 + r < k_hi;
      const long long off = ok ? (j0 + r) * kv_ss + c : 0;
      cp_async16(kd + r * RS + c, kb + off, ok);
      cp_async16(vd + r * RS + c, vb + off, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, k_lo + st * BN);
    cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  const int wq = q0 + warp * 16;           // the warp's first query row
  const int qr[2] = {wq + g, wq + g + 8};  // this thread's two rows
  uint32_t qf[C::QREGS ? C::KT : 1][4];
  float o[C::DT][4];
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  // ldmatrix lane addressing: A (Q) fragments, B (K) fragments of two n8
  // tiles, B (V, transposed) fragments of two n8 tiles
  const int a_row = warp * 16 + (lane / 8 % 2) * 8 + lane % 8, a_col = lane / 16 * 8;
  const int k_row = lane / 16 * 8 + lane % 8, k_col = lane / 8 % 2 * 8;
  const int v_row = lane / 8 % 2 * 8 + lane % 8, v_col = lane / 16 * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = k_lo + it * BN;
    // Q and tile `it` have landed, and every warp is done with tile it - 1,
    // whose stage the next load refills
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    if (it + kTcStages - 1 < n_tiles)
      load_kv((it + kTcStages - 1) % kTcStages, j0 + (kTcStages - 1) * BN);
    cp_async_commit();
    if constexpr (C::QREGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::KT; ++kk) ldmatrix_x4(qf[kk], qs + a_row * RS + kk * 16 + a_col);
      }
    }
    const bf16* kt = ks + (it % kTcStages) * BN * RS;
    const bf16* vt = vs + (it % kTcStages) * BN * RS;
    // does any (row, key) pair of this warp and tile survive the masks?
    const bool live = (!causal || j0 <= wq + 15) && (window <= 0 || j0 + BN - 1 > wq - window);
    if (live) {
      float s[C::NT][4];
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KT; ++kk) {
        uint32_t a[4];
        if constexpr (C::QREGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, qs + a_row * RS + kk * 16 + a_col);
        }
#pragma unroll
        for (int np = 0; np < C::NT / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (np * 16 + k_row) * RS + kk * 16 + k_col);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale, softcap and mask in fp32, in base 2 (x log2(e), so that p is
      // one exp2 of a difference); the tile's row max; rescale
      const bool edge = j0 + BN > skv || (causal && j0 + BN - 1 > wq) ||
                        (window > 0 && j0 <= wq + 15 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (softcap > 0.f) x = softcap * tanhf(s[j][e] * scale / softcap) * kLog2e;
          if (edge) {
            const int kpos = j0 + j * 8 + 2 * tig + (e & 1), qpos = qr[e / 2];
            bool ok = kpos < skv;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            x = ok ? x : kNegInf;
          }
          s[j][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < C::DT; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }

      // p (fp32 into l, bf16 into the PV A fragments), then O += P V
#pragma unroll
      for (int t = 0; t < BN / 16; ++t) {
        float p[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[2 * t + jj][e];
            const float pe = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
            l[e / 2] += pe;
            p[jj][e] = pe;
          }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int dp = 0; dp < C::DT / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (t * 16 + v_row) * RS + dp * 16 + v_col);
          mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qr[r] >= sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = out + b * o_sb + h * o_sh + qr[r] * o_ss + 2 * tig;
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

template <int D>
int launch_tc(const void* q, long long q_sb, long long q_sh, long long q_ss, const void* k,
              const void* v, long long kv_sb, long long kv_sh, long long kv_ss, void* out,
              long long o_sb, long long o_sh, long long o_ss, int b, int hq, int hkv, int sq,
              int skv, float scale, float softcap, int causal, int window,
              cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(flash_tc_kernel<D>, TcCfg<D>::SMEM, sms, sm_count);
  if (err) return err;
  const dim3 grid(b * hq, (sq + kTcRows - 1) / kTcRows);
  flash_tc_kernel<D><<<grid, kTcThreads, TcCfg<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), q_sb, q_sh, q_ss, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_sb, kv_sh, kv_ss, static_cast<bf16*>(out), o_sb, o_sh,
      o_ss, hq, hkv, sq, skv, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register-tiled
// ---------------------------------------------------------------------------

constexpr int kFThreads = 128;
constexpr int kFRows = 32;        // query rows a block
constexpr int kFKeys = kF32Keys;  // keys a tile
constexpr int kFStages = 2;       // K/V tiles in shared memory

template <int DP>
struct F32Cfg {
  static constexpr int RS = DP + 4;         // padded fp32 row (floats)
  static constexpr int CG = DP / 64;        // float4 column groups of P V
  static constexpr int TILE = kFKeys * RS;  // one K or V tile (floats)
  static constexpr int SMEM = (kFRows * RS + kFKeys * kF32PS + kFStages * 2 * TILE) * 4;
  static constexpr int MIN_BLOCKS = DP <= 128 ? 2 : 1;
  static_assert(DP % 64 == 0 && DP <= 256, "padded head dim");
};

template <int DP>
__global__ void __launch_bounds__(kFThreads, F32Cfg<DP>::MIN_BLOCKS)
flash_f32_kernel(const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
                 const float* __restrict__ k, const float* __restrict__ v, long long kv_sb,
                 long long kv_sh, long long kv_ss, float* __restrict__ out, long long o_sb,
                 long long o_sh, long long o_ss, int hq, int hkv, int sq, int skv, int d,
                 float scale, float softcap, int causal, int window, int vec_in,
                 int vec_out) {
  using C = F32Cfg<DP>;
  constexpr int RS = C::RS;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // kFRows x RS
  float* ps = qs + kFRows * RS;     // kFKeys x kF32PS
  float* ring = ps + kFKeys * kF32PS;  // kFStages of a K tile and a V tile

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, kvh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFRows;  // heaviest first
  const int tid = threadIdx.x, tr = tid / 16, tk = tid % 16;
  const int last_q = min(q0 + kFRows, sq) - 1;
  // the key range any row of the block can see
  const int k_hi = causal ? min(skv, last_q + 1) : skv;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kFKeys) * kFKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kFKeys - 1) / kFKeys : 0;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * kv_sb + kvh * kv_sh;
  const float* vb = v + b * kv_sb + kvh * kv_sh;

  // rows [r0, r0 + n) of src (row stride ss) into dst, DP columns: zeros,
  // unread, past d and at rows >= limit; 16-byte copies where every row is
  // 16-byte aligned, 4-byte copies otherwise
  auto copy_rows = [&](float* dst, const float* src, long long ss, int r0, int n, int limit) {
    if (vec_in) {
      for (int i = tid; i < n * (DP / 4); i += kFThreads) {
        const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
        const bool ok = r0 + r < limit && c < d;
        cp_async16(dst + r * RS + c, ok ? src + (r0 + r) * ss + c : src, ok);
      }
    } else {
      for (int i = tid; i < n * DP; i += kFThreads) {
        const int r = i / DP, c = i % DP;
        const bool ok = r0 + r < limit && c < d;
        cp_async4(dst + r * RS + c, ok ? src + (r0 + r) * ss + c : src, ok);
      }
    }
  };
  copy_rows(qs, qb, q_ss, q0, kFRows, sq);
  cp_async_commit();
  // keys at or past k_hi are zero-filled without a read
  auto load_kv = [&](int st, int j0) {
    float* kd = ring + st * 2 * C::TILE;
    copy_rows(kd, kb, kv_ss, j0, kFKeys, k_hi);
    copy_rows(kd + C::TILE, vb, kv_ss, j0, kFKeys, k_hi);
  };
#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, k_lo + st * kFKeys);
    cp_async_commit();
  }

  int qpos[4];  // this thread's rows tr + 8i
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + tr + 8 * i;
  float o[4][4 * C::CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * C::CG; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = k_lo + it * kFKeys;
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // tile `it` (and Q) landed; every thread is done with it - 1
    if (it + kFStages - 1 < n_tiles)
      load_kv((it + kFStages - 1) % kFStages, j0 + (kFStages - 1) * kFKeys);
    cp_async_commit();
    const float* kt = ring + (it % kFStages) * 2 * C::TILE;
    const float* vt = kt + C::TILE;

    f32_attention_tile<DP>(qs, kt, vt, ps, j0, tr, tk, scale, softcap,
                           [&](int i, int kpos) {
                             bool ok = kpos < skv;
                             if (causal) ok = ok && kpos <= qpos[i];
                             if (window > 0) ok = ok && kpos > qpos[i] - window;
                             return ok;
                           },
                           o, m, l);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + b * o_sb + h * o_sh + qpos[i] * o_ss;
#pragma unroll
    for (int cg = 0; cg < C::CG; ++cg) {
      const int c = cg * 64 + tk * 4;
      const float r[4] = {o[i][4 * cg] / denom, o[i][4 * cg + 1] / denom,
                          o[i][4 * cg + 2] / denom, o[i][4 * cg + 3] / denom};
      if (vec_out) {
        if (c < d) *reinterpret_cast<float4*>(orow + c) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) orow[c + e] = r[e];
      }
    }
  }
}

bool rows16(const void* p, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 && ss % 4 == 0;
}

template <int DP>
int launch_f32(const void* q, long long q_sb, long long q_sh, long long q_ss, const void* k,
               const void* v, long long kv_sb, long long kv_sh, long long kv_ss, void* out,
               long long o_sb, long long o_sh, long long o_ss, int b, int hq, int hkv, int sq,
               int skv, int d, float scale, float softcap, int causal, int window,
               cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(flash_f32_kernel<DP>, F32Cfg<DP>::SMEM, sms, sm_count);
  if (err) return err;
  const int vec_in = d % 4 == 0 && rows16(q, q_sb, q_sh, q_ss) &&
                     rows16(k, kv_sb, kv_sh, kv_ss) && rows16(v, kv_sb, kv_sh, kv_ss);
  const int vec_out = d % 4 == 0 && rows16(out, o_sb, o_sh, o_ss);
  const dim3 grid(b * hq, (sq + kFRows - 1) / kFRows);
  flash_f32_kernel<DP><<<grid, kFThreads, F32Cfg<DP>::SMEM, stream>>>(
      static_cast<const float*>(q), q_sb, q_sh, q_ss, static_cast<const float*>(k),
      static_cast<const float*>(v), kv_sb, kv_sh, kv_ss, static_cast<float*>(out), o_sb,
      o_sh, o_ss, hq, hkv, sq, skv, d, scale, softcap, causal, window, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out share one dtype).
// bf16 takes D a multiple of 16 up to 256, fp32 any D up to 256.
static int flash_attention_impl(
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_ss, void* out, long long o_sb, long long o_sh,
    long long o_ss, int dtype, int b, int hq, int hkv, int sq, int skv,
    int d, float scale, float softcap, int causal, int window,
    void* stream) {
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define FLASH_F32(DP)                                                                          \
  launch_f32<DP>(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_ss, out, o_sb, o_sh, o_ss, b, hq, \
                 hkv, sq, skv, d, scale, softcap, causal, window, s)
    if (d <= 64) return FLASH_F32(64);
    if (d <= 128) return FLASH_F32(128);
    return FLASH_F32(256);
#undef FLASH_F32
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define FLASH_TC(D)                                                                     \
  case D:                                                                               \
    return launch_tc<D>(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_ss, out, o_sb, o_sh, \
                        o_ss, b, hq, hkv, sq, skv, scale, softcap, causal, window, s);
  switch (d) {
    BF16_ATTENTION_HEAD_DIMS(FLASH_TC)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_TC
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int flash_attention(const long long* args) {
  return call_packed(flash_attention_impl, args);
}
