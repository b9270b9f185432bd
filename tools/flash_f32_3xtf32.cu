// A design variant of fp32 flash attention, measured beside the port's
// kernel (csrc/flash_attention.cu) and not used by the port:
//
//     python tools/ab_kernels.py --variant 3xtf32=flash_attention:tools/flash_f32_3xtf32.cu \
//         --shapes "flash f32"
//
// It exports the C entry of csrc/flash_attention.cu and takes fp32 only
// (another dtype returns cudaErrorInvalidValue).  The tensor cores in
// 3xTF32 (plain TF32 keeps 11 bits, and the plain version's limit allows
// fp32 reordering only: it rejects q and k rounded to TF32).  Each operand
// x splits into big, x rounded to TF32, and small, the remainder rounded
// (both by integer ops), and each product is small * big + big * small +
// big * big on mma.sync m16n8k8 (TF32 in, fp32 accumulate), the cross
// terms first; this for Q K^T (the cross terms in an accumulator of their
// own, added to the big products' once the head dim is summed) and for P V
// with p in fp32.  The block layout is the bf16 kernel's: four warps of 16
// query rows, heaviest tiles first, 32-key K/V tiles through a two-stage
// cp.async ring, S and P in the accumulator layout with the row max and sum
// reduced over the quad.  Q stays in shared memory as fp32 and every
// operand is split as its fragment is read (Q and K per k step of 8, V per
// n8 tile).  P V's k slots tig and tig + 4 stand for keys 2 tig and 2 tig
// + 1, so the A fragment of P is the thread's own accumulator elements,
// with no shuffle, and V's B fragment is read at those keys.  Rows are
// padded to d8 + 4 floats (d8: D rounded up to 8, zeros past D), which
// keeps every fragment read free of bank conflicts; rows 16-byte aligned
// are copied 16 bytes at a time, others 4.  Any D up to 256.  On the card
// it ran at 0.0264 ms at OPT-6.7B's prefill shape against 0.0146 for the
// port's CUDA-core kernel (PERF.md): latency, 4 warps an SM, 3 mma a
// product and the operand splits.

#include "device_helpers.h"
#include "launch_args.h"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in (32-bit registers whose
// low 13 bits are zero), fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (to nearest, ties away from zero) as a 32-bit pattern
// with the low 13 bits clear: cvt.rna.tf32.f32's result for every finite
// x, in two integer ops on the full-rate pipes (a conversion issues at a
// quarter of their rate).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as the sum of two TF32 values for 3xTF32 products: big, x rounded to
// TF32, and small, the remainder (exact in fp32) rounded.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

constexpr int kFThreads = 128;  // four warps of 16 query rows
constexpr int kFRows = 64;      // query rows a block
constexpr int kFStages = 2;     // K/V tiles in shared memory

template <int DMAX>
struct F32Cfg {
  static constexpr int KEYS = 32;  // keys a tile
  // Shared memory for a head dim padded to d8 (a multiple of 8): Q and the
  // ring of K/V tiles, rows of d8 + 4 floats (16-byte aligned, and free of
  // bank conflicts for every fragment read below).
  static int smem(int d8) { return (kFRows + 2 * kFStages * KEYS) * (d8 + 4) * (int)sizeof(float); }
};

template <int DMAX>
__global__ void __launch_bounds__(kFThreads)
flash_f32_kernel(const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
                 const float* __restrict__ k, const float* __restrict__ v, long long kv_sb,
                 long long kv_sh, long long kv_ss, float* __restrict__ out, long long o_sb,
                 long long o_sh, long long o_ss, int hq, int hkv, int sq, int skv, int d,
                 float scale, float softcap, int causal, int window, int vec) {
  constexpr int DT = DMAX / 8;   // n8 tiles of O at most
  constexpr int BN = F32Cfg<DMAX>::KEYS;
  const int d8 = (d + 7) / 8 * 8, RS = d8 + 4, dt = d8 / 8;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                          // kFRows x RS
  float* ks = qs + kFRows * RS;             // kFStages of BN x RS
  float* vs = ks + kFStages * BN * RS;      // kFStages of BN x RS

  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFRows;  // heaviest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int last_q = min(q0 + kFRows, sq) - 1;

  // the key range any row of the block can see
  const int k_hi = causal ? min(skv, last_q + 1) : skv;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * kv_sb + kvh * kv_sh;
  const float* vb = v + b * kv_sb + kvh * kv_sh;

  // rows [r0, r0 + n) of src (row stride ss) into dst, d8 columns: zeros,
  // unread, past d and at rows >= limit; 16-byte copies where every row is
  // 16-byte aligned (vec), 4-byte copies otherwise
  auto copy_rows = [&](float* dst, const float* src, long long ss, int r0, int n, int limit) {
    if (vec) {
      const int cpr = d8 / 4;
      for (int i = tid; i < n * cpr; i += kFThreads) {
        const int r = i / cpr, c = (i % cpr) * 4;
        const bool ok = r0 + r < limit && c < d;
        cp_async16(dst + r * RS + c, ok ? src + (r0 + r) * ss + c : src, ok);
      }
    } else {
      for (int i = tid; i < n * d8; i += kFThreads) {
        const int r = i / d8, c = i % d8;
        const bool ok = r0 + r < limit && c < d;
        cp_async4(dst + r * RS + c, ok ? src + (r0 + r) * ss + c : src, ok);
      }
    }
  };
  copy_rows(qs, qb, q_ss, q0, kFRows, sq);
  cp_async_commit();
  // keys at or past k_hi are zero-filled without a read
  auto load_kv = [&](int stage, int j0) {
    copy_rows(ks + stage * BN * RS, kb, kv_ss, j0, BN, k_hi);
    copy_rows(vs + stage * BN * RS, vb, kv_ss, j0, BN, k_hi);
  };
#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, k_lo + st * BN);
    cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  const int wq = q0 + warp * 16;           // the warp's first query row
  const int qr[2] = {wq + g, wq + g + 8};  // this thread's two rows
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  // this thread's A fragment elements of Q: rows g and g + 8, columns tig
  // and tig + 4 of each k step
  const float* qw = qs + (warp * 16 + g) * RS + tig;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = k_lo + it * BN;
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // tile `it` (and Q) landed; every warp is done with it - 1
    if (it + kFStages - 1 < n_tiles)
      load_kv((it + kFStages - 1) % kFStages, j0 + (kFStages - 1) * BN);
    cp_async_commit();
    const float* kt = ks + (it % kFStages) * BN * RS;
    const float* vt = vs + (it % kFStages) * BN * RS;
    const bool live = (!causal || j0 <= wq + 15) && (window <= 0 || j0 + BN - 1 > wq - window);
    if (live) {
      // S = Q K^T in 3xTF32: per k step of 8, Q (A) and K (B: key g, columns
      // tig and tig + 4) split on the fly; the cross products summed in
      // one accumulator, big * big in another, the two added at the end
      float s[BN / 8][4], sx[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sx[j][e] = 0.f;
      const float* kr = kt + g * RS + tig;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        if (kk < dt) {
          uint32_t ab[4], as[4];
          split_tf32(qw[kk * 8], ab[0], as[0]);
          split_tf32(qw[8 * RS + kk * 8], ab[1], as[1]);
          split_tf32(qw[kk * 8 + 4], ab[2], as[2]);
          split_tf32(qw[8 * RS + kk * 8 + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(kr[j * 8 * RS + kk * 8], bb0, bs0);
            split_tf32(kr[j * 8 * RS + kk * 8 + 4], bb1, bs1);
            mma_tf32(sx[j], as, bb0, bb1);
            mma_tf32(sx[j], ab, bs0, bs1);
            mma_tf32(s[j], ab, bb0, bb1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sx[j][e];

      // scale, softcap and mask in fp32, in base 2; the tile's row max;
      // rescale
      const bool edge = j0 + BN > skv || (causal && j0 + BN - 1 > wq) ||
                        (window > 0 && j0 <= wq + 15 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
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
        for (int j = 0; j < DT; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }

      // O += P V in 3xTF32, one k step per 8 keys.  The step's k slots tig
      // and tig + 4 are keys 2 tig and 2 tig + 1, so P's A fragment is this
      // thread's own accumulator elements, and V's B fragment (key, column g)
      // is read at those keys.
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          p[e] = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
          l[e / 2] += p[e];
        }
        uint32_t pb[4], ps[4];
        split_tf32(p[0], pb[0], ps[0]);  // row g, key 2 tig
        split_tf32(p[2], pb[1], ps[1]);  // row g + 8, key 2 tig
        split_tf32(p[1], pb[2], ps[2]);  // row g, key 2 tig + 1
        split_tf32(p[3], pb[3], ps[3]);  // row g + 8, key 2 tig + 1
        const float* vr = vt + (j * 8 + 2 * tig) * RS + g;
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          if (dn < dt) {
            uint32_t vb0, vs0, vb1, vs1;
            split_tf32(vr[dn * 8], vb0, vs0);
            split_tf32(vr[RS + dn * 8], vb1, vs1);
            mma_tf32(o[dn], ps, vb0, vb1);
            mma_tf32(o[dn], pb, vs0, vs1);
            mma_tf32(o[dn], pb, vb0, vb1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qr[r] >= sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    float* orow = out + b * o_sb + h * o_sh + qr[r] * o_ss;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c < d) orow[c] = o[j][2 * r] / denom;
      if (c + 1 < d) orow[c + 1] = o[j][2 * r + 1] / denom;
    }
  }
}

template <int DMAX>
int launch_f32(const void* q, long long q_sb, long long q_sh, long long q_ss, const void* k,
               const void* v, long long kv_sb, long long kv_sh, long long kv_ss, void* out,
               long long o_sb, long long o_sh, long long o_ss, int b, int hq, int hkv, int sq,
               int skv, int d, float scale, float softcap, int causal, int window,
               cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(flash_f32_kernel<DMAX>, F32Cfg<DMAX>::smem(DMAX), sms, sm_count);
  if (err) return err;
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = d % 4 == 0 && a16(q) && a16(k) && a16(v) && q_sb % 4 == 0 &&
                  q_sh % 4 == 0 && q_ss % 4 == 0 && kv_sb % 4 == 0 && kv_sh % 4 == 0 &&
                  kv_ss % 4 == 0;
  const dim3 grid(b * hq, (sq + kFRows - 1) / kFRows);
  flash_f32_kernel<DMAX><<<grid, kFThreads, F32Cfg<DMAX>::smem((d + 7) / 8 * 8), stream>>>(
      static_cast<const float*>(q), q_sb, q_sh, q_ss, static_cast<const float*>(k),
      static_cast<const float*>(v), kv_sb, kv_sh, kv_ss, static_cast<float*>(out), o_sb,
      o_sh, o_ss, hq, hkv, sq, skv, d, scale, softcap, causal, window, vec);
  return (int)cudaGetLastError();
}

}  // namespace

static int flash_attention_impl(
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_ss, void* out, long long o_sb, long long o_sh,
    long long o_ss, int dtype, int b, int hq, int hkv, int sq, int skv,
    int d, float scale, float softcap, int causal, int window,
    void* stream) {
  if (dtype != 0 || d <= 0 || d > 256 || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_F32(D)                                                                          \
  launch_f32<D>(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_ss, out, o_sb, o_sh, o_ss, b, hq, \
                hkv, sq, skv, d, scale, softcap, causal, window, s)
  if (d <= 16) return FLASH_F32(16);
  if (d <= 32) return FLASH_F32(32);
  if (d <= 64) return FLASH_F32(64);
  if (d <= 128) return FLASH_F32(128);
  return FLASH_F32(256);
#undef FLASH_F32
}

extern "C" int flash_attention(const long long* args) {
  return call_packed(flash_attention_impl, args);
}
