// Paged flash-decode: one query token per (batch, q-head) attending over the
// KV pages named by that row's block table.  Built for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py · paged_decode_attention
//   (_paged_body; fp32 q with fp32 pages, bf16 q with bf16 pages, and either
//   q with int8 pages plus per-(page, head, token) fp32 scales, dequantized
//   in fp32 as the Pallas kernel does).
//
// What bounds it on the H100: bytes.  Each (batch, q-head) reads kv_len rows
//   of K and V once (8 * kv_len * D bytes in fp32, 2 * kv_len * (D + 4) for
//   int8 pages) and does 4 FLOPs per element read, far below the fp32 ridge
//   of the card (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).
//
// Design: one block of 128 threads per (batch, q-head) walks the row's pages
//   in order, keeping the online softmax (m, l) and the output accumulator
//   in registers.  Pages at or past kv_len are never loaded, so the trash
//   page and stale pool rows cannot reach the result; positions past kv_len
//   inside the last page are masked before the softmax and skipped in the
//   PV sum.  Warps score one token each (lanes read consecutive head-dim
//   elements, so every K row load is coalesced); each thread then owns up to
//   two head-dim columns of the output, so V rows are read coalesced too.
//   GQA maps q-head h to kv-head h / group; the q-heads of a group re-read
//   the same pages, which the 50 MB L2 absorbs.  Sums are fp32; over bf16
//   pages p is rounded to bf16 before the PV product (l sums the unrounded
//   p), as the Pallas kernel and the dense kernels do.  Splitting a long row across
//   blocks (split-KV with a combine pass) is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 2;            // head dim <= kThreads * kMaxCols
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to bf16 over bf16 pages; fp32 and
// dequantized int8 values take it unrounded.
template <typename TKV> __device__ __forceinline__ float round_p(float p) { return p; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q,               // (B, Hq, D)
                    const TKV* __restrict__ k_pages,        // (P, Hkv, ps, D)
                    const TKV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,      // (P, Hkv, ps)
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_tables,  // (B, nb)
                    const int32_t* __restrict__ kv_len,        // (B,)
                    TQ* __restrict__ out,                   // (B, Hq, D)
                    int hq, int hkv, int ps, int d, int nb,
                    float scale, float softcap) {
  constexpr bool Q8 = sizeof(TKV) == 1;
  extern __shared__ float smem[];
  float* qs = smem;          // d: the query row, pre-scaled
  float* sc = smem + d;      // ps: this page's scores

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int len = kv_len[b];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < d; i += kThreads) qs[i] = to_f(q[(size_t)bh * d + i]) * scale;
  __syncthreads();

  float acc[kMaxCols] = {0.f, 0.f};
  float m = kNegInf;
  float l = 0.f;
  int n_pages = (len + ps - 1) / ps;
  if (n_pages > nb) n_pages = nb;

  for (int j = 0; j < n_pages; ++j) {
    const int page = block_tables[(size_t)b * nb + j];
    const size_t row0 = ((size_t)page * hkv + kvh) * ps;   // token row of t=0

    for (int t = warp; t < ps; t += kWarps) {
      const size_t base = (row0 + t) * d;
      float part = 0.f;
      for (int i = lane; i < d; i += 32) part += qs[i] * to_f(k_pages[base + i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        float s = part;
        if (Q8) s *= k_scale[row0 + t];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        sc[t] = (j * ps + t < len) ? s : kNegInf;
      }
    }
    __syncthreads();

    float page_max = kNegInf;
    for (int t = 0; t < ps; ++t) page_max = fmaxf(page_max, sc[t]);
    const float m_new = fmaxf(m, page_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[c] *= alpha;
    float p_sum = 0.f;
    const int live = min(ps, len - j * ps);
    for (int t = 0; t < live; ++t) {
      const float p = expf(sc[t] - m_new);
      p_sum += p;
      const float pr = round_p<TKV>(p);
      const size_t base = (row0 + t) * d;
      const float vsc = Q8 ? v_scale[row0 + t] : 1.f;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int i = tid + c * kThreads;
        if (i < d) acc[c] += pr * (to_f(v_pages[base + i]) * vsc);
      }
    }
    l = l * alpha + p_sum;
    m = m_new;
    __syncthreads();         // sc is rewritten by the next page
  }

  const float denom = (l == 0.f) ? 1.f : l;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int i = tid + c * kThreads;
    if (i < d) out[(size_t)bh * d + i] = from_f<TQ>(acc[c] / denom);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* kv_len, void* out, int b, int hq, int hkv, int ps,
           int d, int nb, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)(d + ps) * sizeof(float);
  paged_decode_kernel<TQ, TKV><<<b * hq, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(kv_len), static_cast<TQ*>(out), hq, hkv, ps,
      d, nb, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pages only, with scales).
// q and out share q_dtype; fp32 and bf16 pages go with a q of their dtype.
static int paged_decode_attention_impl(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, void* out, int q_dtype, int kv_dtype, int b, int hq,
    int hkv, int ps, int d, int nb, float scale, float softcap, void* stream) {
  if (d > kThreads * kMaxCols || hkv <= 0 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS q, k_pages, v_pages, k_scale, v_scale, block_tables, kv_len, \
    out, b, hq, hkv, ps, d, nb, scale, softcap, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(PAGED_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t>(PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int paged_decode_attention(const long long* args) {
  return call_packed(paged_decode_attention_impl, args);
}
