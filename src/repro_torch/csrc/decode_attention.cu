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
//   tokens is read once per q-head of its group (2 * kv_len * D elements)
//   for 4 FLOPs per element, far below the card's ridge in any dtype.
//
// Design: one block of 16 warps per (batch, q-head).  K/V are addressed
//   through (batch, head, token) strides, so the stacked (B, Hkv, T, D)
//   cache and the backend's (B, T, Hkv, D) buffer seen through
//   transpose(1, 2) are both read in place, without a copy.  Warp w takes
//   tokens w, w + 16, ...; its lanes own head-dim columns lane + 32 i, so
//   every K and V row load is coalesced, and the V row is loaded before the
//   score is reduced so both loads are in flight together.  Each warp keeps
//   its own online softmax (m, l) and accumulator in registers with no
//   block-wide barrier in the loop; the 16 partial states are merged once
//   through shared memory at the end.  p is rounded to the value dtype
//   before the PV product (bf16 caches), as the Pallas kernel does; l sums
//   the unrounded p.  Rows at or past kv_len are never read; a row with no
//   valid key writes 0.  The q-heads of a GQA group re-read the same rows,
//   which the 50 MB L2 absorbs.  Splitting one long row across blocks
//   (split-KV with a combine pass) is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_args.h"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 32;      // head-dim columns per lane
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to the value dtype for bf16 caches;
// fp32 and dequantized int8 values take it unrounded.
template <typename TKV> __device__ __forceinline__ float round_p(float p) { return p; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Q8: int8 K/V with per-row scales, dequantized in q's dtype (the JAX
// package's stacked-cache rule, models/model.py:481-485).  Under a bf16 q
// (DQ16) that is bf16(bf16(k) * bf16(scale)) and p rounds like a bf16
// cache; under an fp32 q the scales apply in fp32.
template <typename TQ, typename TKV, bool Q8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, long long q_sb, long long q_sh,
              const TKV* __restrict__ k, const TKV* __restrict__ v,
              long long kv_sb, long long kv_sh, long long kv_st,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              long long s_sb, long long s_sh, long long s_st,
              const int32_t* __restrict__ kv_len, TQ* __restrict__ out,
              long long o_sb, long long o_sh, int hq, int hkv, int t_max,
              int d, float scale, float softcap) {
  constexpr bool DQ16 = Q8 && std::is_same<TQ, __nv_bfloat16>::value;
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
    qr[i] = c < d ? to_f(q[b * q_sb + h * q_sh + c]) * scale : 0.f;
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
      if (DQ16) {
        ksc = bf16r(ksc);
        vsc = bf16r(vsc);
      }
    }
    float kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      kv[i] = c < d ? to_f(kr[c]) : 0.f;
      vv[i] = c < d ? to_f(vr[c]) : 0.f;
      if (DQ16) {
        kv[i] = bf16r(kv[i] * ksc);
        vv[i] = bf16r(vv[i] * vsc);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) s += qr[i] * kv[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (Q8 && !DQ16) s *= ksc;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float pv = DQ16 ? bf16r(p) : round_p<TKV>(p) * vsc;
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
    out[b * o_sb + h * o_sh + c] = from_f<TQ>(at / (lt == 0.f ? 1.f : lt));
  }
}

template <typename TQ, typename TKV, bool Q8>
int launch(const void* q, long long q_sb, long long q_sh, const void* k,
           const void* v, long long kv_sb, long long kv_sh, long long kv_st,
           const void* k_scale, const void* v_scale, long long s_sb,
           long long s_sh, long long s_st, const void* kv_len, void* out,
           long long o_sb, long long o_sh, int b, int hq, int hkv, int t_max,
           int d, float scale, float softcap, cudaStream_t stream) {
  decode_kernel<TQ, TKV, Q8><<<b * hq, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), q_sb, q_sh, static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kv_sb, kv_sh, kv_st,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      s_sb, s_sh, s_st, static_cast<const int32_t*>(kv_len),
      static_cast<TQ*>(out), o_sb, o_sh, hq, hkv, t_max, d, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only, with scales).
static int decode_attention_impl(
    const void* q, long long q_sb, long long q_sh, int q_dtype,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_st, int kv_dtype, const void* k_scale, const void* v_scale,
    long long s_sb, long long s_sh, long long s_st, const void* kv_len,
    void* out, long long o_sb, long long o_sh, int b, int hq, int hkv,
    int t_max, int d, float scale, float softcap, void* stream) {
  if (d > kMaxD || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, k_scale, v_scale, \
    s_sb, s_sh, s_st, kv_len, out, o_sb, o_sh, b, hq, hkv, t_max, d, scale,     \
    softcap, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, false>(DECODE_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(DECODE_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t, true>(DECODE_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(DECODE_ARGS);
#undef DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int decode_attention(const long long* args) {
  return call_packed(decode_attention_impl, args);
}
