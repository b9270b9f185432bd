// Dense flash-decode: one query token per (batch, q-head) attending over the
// first kv_len[b] rows of a dense KV cache.  Built for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py · decode_attention
//   (_decode_body; fp and bf16 caches, and int8 caches with per-(b, head,
//   token) fp32 scales dequantized inside the kernel in q's dtype, as the
//   JAX package's stacked whole model dequantizes its int8 cache before
//   attending: in fp32 under an fp32 q, in bf16 under a bf16 q).
//
// What bounds it on the H100: bytes.  Each (batch, kv-head) row of kv_len
//   tokens must be read once (2 * kv_len * D elements, and the scales of an
//   int8 cache) for 4 FLOPs per element and q-head, far below the card's
//   ridge in any dtype.
//
// K/V are addressed through (batch, head, token) strides, so the stacked
//   (B, Hkv, T, D) cache and the backend's (B, T, Hkv, D) buffer seen
//   through transpose(1, 2) are both read in place, without a copy.  Every
//   route keeps these rules: p is rounded to the value dtype before the PV
//   product (bf16 caches, and int8 caches under a bf16 q), l sums the
//   unrounded p; an int8 cache under a bf16 q is dequantized as
//   bf16(bf16(k) * bf16(scale)); rows at or past kv_len are never read, so
//   a NaN there reaches no output; a row with no valid key writes 0.
//
// bf16 q over a bf16 or int8 cache (head dims in multiples of 16 up to 256, 16-byte
//   aligned rows; the wrapper refuses any other bf16 shape): the split-KV
//   kernel of csrc/split_decode.h, one thread-block cluster of 1-8 blocks
//   per (batch, kv-head, group of up to 16 q-heads), each block a
//   contiguous range of the row's tokens, the GQA group's q rows sharing
//   each K/V row it reads, the blocks merged in rank order through
//   distributed shared memory in the one launch; an int8 tile is
//   dequantized in bf16 by the warp that uses it.
//
// fp32 q over an fp32 or int8 cache: one block of 16 warps per (batch,
//   q-head); warp w takes tokens w, w + 16, ..., its lanes own head-dim
//   columns lane + 32 i, each warp keeps its own online softmax in
//   registers, and the 16 partial states merge once through shared
//   memory.  The q-heads of a GQA group re-read the same rows, which the
//   50 MB L2 absorbs.

#include <type_traits>

#include "device_helpers.h"
#include "launch_args.h"
#include "split_decode.h"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1.0e30f;
constexpr int kMaxD = 256;

// ---------------------------------------------------------------------------
// bf16 q: split-KV over a cluster, tensor cores (csrc/split_decode.h)
// ---------------------------------------------------------------------------

// K/V rows (and scales) of one (batch, kv-head) of the cache, through its
// token strides.
template <typename T>
struct StridedRows {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  long long st, s_st;
  __device__ long long kv(int t) const { return t * st; }
  __device__ long long sc(int t) const { return t * s_st; }
};

// One cluster per (batch, kv-head, group of 16 q-heads).  RULE: bf16 K/V,
// or int8 with per-token fp32 scales dequantized in bf16.
template <int D, int RULE>
__global__ void __launch_bounds__(split_decode::kThreads)
decode_split_kernel(const bf16* __restrict__ q, long long q_sb, long long q_sh,
                    const void* __restrict__ k, const void* __restrict__ v, long long kv_sb,
                    long long kv_sh, long long kv_st, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, long long s_sb, long long s_sh,
                    long long s_st, const int32_t* __restrict__ kv_len, bf16* __restrict__ out,
                    long long o_sb, long long o_sh, float* __restrict__ lse, int hq, int hkv,
                    int t_max, float scale, float softcap) {
  typedef typename std::conditional<RULE == split_decode::kBf16, bf16, int8_t>::type TKV;
  const split_decode::Block blk = split_decode::block_of(hq, hkv);
  const long long kvo = blk.b * kv_sb + blk.kvh * kv_sh, so = blk.b * s_sb + blk.kvh * s_sh;
  const StridedRows<TKV> rows{static_cast<const TKV*>(k) + kvo, static_cast<const TKV*>(v) + kvo,
                              k_scale + so, v_scale + so, kv_st, s_st};
  split_decode::run<D, RULE>(q + blk.b * q_sb + blk.h0 * q_sh, q_sh,
                             out + blk.b * o_sb + blk.h0 * o_sh, o_sh, blk.gn,
                             max(0, min(kv_len[blk.b], t_max)), rows, scale, softcap,
                             lse == nullptr ? nullptr : lse + (long long)blk.b * hq + blk.h0);
}

template <int D, bool Q8>
int launch_split(const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
                 long long kv_sb, long long kv_sh, long long kv_st, const void* k_scale,
                 const void* v_scale, long long s_sb, long long s_sh, long long s_st,
                 const void* kv_len, void* out, long long o_sb, long long o_sh, void* lse, int b,
                 int hq, int hkv, int t_max, float scale, float softcap, cudaStream_t stream) {
  constexpr int RULE = Q8 ? split_decode::kInt8Bf16 : split_decode::kBf16;
  static std::atomic<int> sms[kMaxDevices];
  return split_decode::launch<D, RULE>(
      decode_split_kernel<D, RULE>, sms, b, hq, hkv, t_max, stream,
      static_cast<const bf16*>(q), q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), s_sb, s_sh, s_st,
      static_cast<const int32_t*>(kv_len), static_cast<bf16*>(out), o_sb, o_sh,
      static_cast<float*>(lse), hq, hkv, t_max, scale, softcap);
}

// ---------------------------------------------------------------------------
// fp32 q: a block per q-head
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = kMaxD / 32;      // head-dim columns per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// Q8: int8 K/V with per-row scales applied in fp32 (the JAX package's
// stacked-cache rule under an fp32 q, models/model.py:481-485).
template <typename TKV, bool Q8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, long long q_sb, long long q_sh,
              const TKV* __restrict__ k, const TKV* __restrict__ v,
              long long kv_sb, long long kv_sh, long long kv_st,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              long long s_sb, long long s_sh, long long s_st,
              const int32_t* __restrict__ kv_len, float* __restrict__ out,
              long long o_sb, long long o_sh, float* __restrict__ lse, int hq,
              int hkv, int t_max, int d, float scale, float softcap) {
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxD];

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(kv_len[b], t_max);

  float qr[kCols];
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? q[b * q_sb + h * q_sh + c] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const TKV* kb = k + b * kv_sb + kvh * kv_sh;
  const TKV* vb = v + b * kv_sb + kvh * kv_sh;
  for (int t = warp; t < len; t += kWarps) {
    const TKV* kr = kb + t * kv_st;
    const TKV* vr = vb + t * kv_st;
    float ksc = 1.f, vsc = 1.f;
    if (Q8) {
      const long long si = b * s_sb + kvh * s_sh + t * s_st;
      ksc = k_scale[si];
      vsc = v_scale[si];
    }
    float kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      kv[i] = c < d ? to_f(kr[c]) : 0.f;
      vv[i] = c < d ? to_f(vr[c]) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) s += qr[i] * kv[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (Q8) s *= ksc;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float pv = p * vsc;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = acc[i] * alpha + pv * vv[i];
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = lane + 32 * i;
    if (c < d) acc_s[warp][c] = acc[i];
  }
  __syncthreads();

  for (int c = threadIdx.x; c < d; c += kThreads) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = (l_s[w] == 0.f) ? 0.f : expf(m_s[w] - mx);
      lt += l_s[w] * f;
      at += acc_s[w][c] * f;
    }
    out[b * o_sb + h * o_sh + c] = at / (lt == 0.f ? 1.f : lt);
    if (lse != nullptr && c == 0)
      lse[(long long)b * hq + h] = lt == 0.f ? __int_as_float(0xff800000) : mx + logf(lt);
  }
}

template <typename TKV, bool Q8>
int launch(const void* q, long long q_sb, long long q_sh, const void* k,
           const void* v, long long kv_sb, long long kv_sh, long long kv_st,
           const void* k_scale, const void* v_scale, long long s_sb,
           long long s_sh, long long s_st, const void* kv_len, void* out,
           long long o_sb, long long o_sh, void* lse, int b, int hq, int hkv,
           int t_max, int d, float scale, float softcap, cudaStream_t stream) {
  decode_kernel<TKV, Q8><<<b * hq, kThreads, 0, stream>>>(
      static_cast<const float*>(q), q_sb, q_sh, static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kv_sb, kv_sh, kv_st,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      s_sb, s_sh, s_st, static_cast<const int32_t*>(kv_len),
      static_cast<float*>(out), o_sb, o_sh, static_cast<float*>(lse), hq, hkv,
      t_max, d, scale, softcap);
  return (int)cudaGetLastError();
}

// Does a bf16 q over this cache fit the split kernel: a head dim it is
// instantiated for, and every row it copies 16-byte aligned (a stride of a
// dim of size 1 is never used).  The wrapper refuses anything else first.
bool split_shape(const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
                 long long kv_sb, long long kv_sh, long long kv_st, int kv_el, int b, int hq,
                 int hkv, int t_max, int d) {
  if (d % 16 || d < 16 || d > 256) return false;
  auto al = [](long long x) { return x % 16 == 0; };
  if (!al((long long)(uintptr_t)q) || !al((long long)(uintptr_t)k) ||
      !al((long long)(uintptr_t)v))
    return false;
  if ((b > 1 && !al(2 * q_sb)) || (hq > 1 && !al(2 * q_sh))) return false;
  if ((b > 1 && !al(kv_el * kv_sb)) || (hkv > 1 && !al(kv_el * kv_sh)) ||
      (t_max > 1 && !al(kv_el * kv_st)))
    return false;
  return true;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only, with scales).
// A bf16 q takes the split kernel or is refused; an fp32 q the per-q-head
// kernel.
static int decode_attention_impl(
    const void* q, long long q_sb, long long q_sh, int q_dtype,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_st, int kv_dtype, const void* k_scale, const void* v_scale,
    long long s_sb, long long s_sh, long long s_st, const void* kv_len,
    void* out, long long o_sb, long long o_sh, void* lse, int b, int hq,
    int hkv, int t_max, int d, float scale, float softcap, void* stream) {
  if (d > kMaxD || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1) {
    if ((kv_dtype != 1 && kv_dtype != 2) ||
        !split_shape(q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, kv_dtype == 1 ? 2 : 1, b, hq,
                     hkv, t_max, d))
      return (int)cudaErrorInvalidValue;
#define SPLIT_ARGS q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, k_scale, v_scale, s_sb, s_sh, \
    s_st, kv_len, out, o_sb, o_sh, lse, b, hq, hkv, t_max, scale, softcap, s
#define SPLIT(D)                                                   \
  case D:                                                          \
    return kv_dtype == 2 ? launch_split<D, true>(SPLIT_ARGS)       \
                         : launch_split<D, false>(SPLIT_ARGS);
    switch (d) {
      BF16_ATTENTION_HEAD_DIMS(SPLIT)
    }
#undef SPLIT
#undef SPLIT_ARGS
    return (int)cudaErrorInvalidValue;
  }
#define DECODE_ARGS q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, k_scale, v_scale, \
    s_sb, s_sh, s_st, kv_len, out, o_sb, o_sh, lse, b, hq, hkv, t_max, d, scale, \
    softcap, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, false>(DECODE_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<int8_t, true>(DECODE_ARGS);
#undef DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int decode_attention(const long long* args) {
  return call_packed(decode_attention_impl, args);
}
