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
//   ldmatrix (K) and ldmatrix.trans (V) are free of bank conflicts.  On the
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
// fp32 (no TF32: the plain version's limit allows fp32 reordering only):
//   the CUDA cores.  One block of 128 threads per 32 query rows walks K/V
//   tiles of 32 keys staged as fp32 in shared memory; four threads share a
//   query row, each scoring 8 of the tile's keys and keeping D / 4
//   accumulator columns in registers.

#include "device_helpers.h"
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
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kRowThreads = kThreads / kBlockQ;      // 4 threads per row
constexpr int kKeysPerThread = kBlockK / kRowThreads;  // 8
constexpr int kMaxD = 256;
constexpr int kMaxAcc = kMaxD / kRowThreads;         // 64

constexpr int f32_smem(int d) {
  return (int)sizeof(float) *
         (kBlockQ * (d + 1) + kBlockK * (d + 1) + kBlockK * d + kBlockQ * (kBlockK + 1));
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, long long q_sb, long long q_sh,
                 long long q_ss, const float* __restrict__ k,
                 const float* __restrict__ v, long long kv_sb, long long kv_sh,
                 long long kv_ss, float* __restrict__ out, long long o_sb,
                 long long o_sh, long long o_ss, int hq, int hkv, int sq,
                 int skv, int d, float scale, float softcap, int causal,
                 int window) {
  extern __shared__ float smem[];
  const int dp = d + 1;                          // padded row stride
  float* qs = smem;                              // kBlockQ * dp
  float* ks = qs + kBlockQ * dp;                 // kBlockK * dp
  float* vs = ks + kBlockK * dp;                 // kBlockK * d
  float* ps = vs + kBlockK * d;                  // kBlockQ * (kBlockK + 1)

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;               // this thread's query row
  const int part = tid % kRowThreads;
  const int qpos = q0 + r;
  const int last_q = min(q0 + kBlockQ, sq) - 1;  // the tile's last row

  const float* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int rr = i / d, c = i % d;
    qs[rr * dp + c] = q0 + rr < sq ? qb[(q0 + rr) * q_ss + c] * scale : 0.f;
  }

  // the key range any row of the tile can see
  int k_lo = 0;
  int k_hi = causal ? min(skv, last_q + 1) : skv;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kBlockK) * kBlockK;

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const float* kb = k + b * kv_sb + kvh * kv_sh;
  const float* vb = v + b * kv_sb + kvh * kv_sh;
  for (int j0 = k_lo; j0 < k_hi; j0 += kBlockK) {
    __syncthreads();             // the previous tile's K/V/P are consumed
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int t = i / d, c = i % d;
      const int kpos = j0 + t;
      const bool live = kpos < k_hi;
      ks[t * dp + c] = live ? kb[kpos * kv_ss + c] : 0.f;
      vs[t * d + c] = live ? vb[kpos * kv_ss + c] : 0.f;
    }
    __syncthreads();

    float s[kKeysPerThread];
    bool ok[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = qs[r * dp + c];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        s[j] += qv * ks[(part + kRowThreads * j) * dp + c];
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int kpos = j0 + part + kRowThreads * j;
      bool valid = qpos < sq && kpos < skv;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      ok[j] = valid;
      float sv = s[j];
      if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
      s[j] = valid ? sv : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      sum += p;
      ps[r * (kBlockK + 1) + part + kRowThreads * j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();                // the row's P is written by its own warp

#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int c = part + kRowThreads * i;
      if (c < d) {
        float a = acc[i] * alpha;
        for (int t = 0; t < kBlockK; ++t)
          a += ps[r * (kBlockK + 1) + t] * vs[t * d + c];
        acc[i] = a;
      }
    }
  }

  if (qpos < sq) {
    const float denom = l == 0.f ? 1.f : l;
    float* ob = out + b * o_sb + h * o_sh + qpos * o_ss;
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int c = part + kRowThreads * i;
      if (c < d) ob[c] = acc[i] / denom;
    }
  }
}

int launch_f32(const void* q, long long q_sb, long long q_sh, long long q_ss, const void* k,
               const void* v, long long kv_sb, long long kv_sh, long long kv_ss, void* out,
               long long o_sb, long long o_sh, long long o_ss, int b, int hq, int hkv, int sq,
               int skv, int d, float scale, float softcap, int causal, int window,
               cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(flash_f32_kernel, f32_smem(kMaxD), sms, sm_count);
  if (err) return err;
  const dim3 grid(b * hq, (sq + kBlockQ - 1) / kBlockQ);
  flash_f32_kernel<<<grid, kThreads, f32_smem(d), stream>>>(
      static_cast<const float*>(q), q_sb, q_sh, q_ss, static_cast<const float*>(k),
      static_cast<const float*>(v), kv_sb, kv_sh, kv_ss, static_cast<float*>(out), o_sb,
      o_sh, o_ss, hq, hkv, sq, skv, d, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out share one dtype).
// bf16 takes D in {16, 32, 64, 128, 256}, fp32 any D up to 256.
static int flash_attention_impl(
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_ss, void* out, long long o_sb, long long o_sh,
    long long o_ss, int dtype, int b, int hq, int hkv, int sq, int skv,
    int d, float scale, float softcap, int causal, int window,
    void* stream) {
  if (d > kMaxD || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_ss, out, o_sb, o_sh, o_ss,
                      b, hq, hkv, sq, skv, d, scale, softcap, causal, window, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define FLASH_TC(D)                                                                     \
  case D:                                                                               \
    return launch_tc<D>(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_ss, out, o_sb, o_sh, \
                        o_ss, b, hq, hkv, sq, skv, scale, softcap, causal, window, s);
  switch (d) {
    FLASH_TC(16)
    FLASH_TC(32)
    FLASH_TC(64)
    FLASH_TC(128)
    FLASH_TC(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_TC
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int flash_attention(const long long* args) {
  return call_packed(flash_attention_impl, args);
}
