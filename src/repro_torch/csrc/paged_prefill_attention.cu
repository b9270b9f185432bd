// Paged flash-prefill: a chunk of S query tokens starting at kv_offset[b]
// attends causally (optionally within a sliding window, optionally with a
// softcap) over the KV pages named by the row's block table.  Built for
// sm_90a.
//
// Replaces: src/repro/kernels/paged_prefill.py · paged_prefill_attention
//   (_prefill_body; fp32 q with fp32 pages, bf16 q with bf16 pages, and
//   either q with int8 pages plus per-(page, head, token) fp32 scales,
//   dequantized in fp32 as the Pallas kernel does).
//
// What bounds it on the H100: for the chunk lengths serving admits (tens to
//   a few hundred tokens) the FLOPs, 4 * S * kv * D per (batch, q-head) on the
//   fp32 CUDA cores (67 TFLOP/s), against 8 * kv * D bytes of K/V read once.
//   With S above ~20 it is compute-bound; this first kernel does not use the
//   tensor cores.
//
// Design: one block of 128 threads per (batch, q-head, tile of 16 query
//   rows).  The block walks the row's pages up to the tile's last diagonal
//   only (pages above it are causally masked for every row and never
//   loaded, which keeps the trash page and stale pool rows out), staging
//   one dequantized K and V page at a time in shared memory.  Scores for the
//   whole (16 x page_size) tile are computed into shared memory; the online
//   softmax (m, l) per row lives in shared memory, and each thread owns a
//   fixed set of (row, head-dim) accumulator entries in registers.  K is
//   staged with a padded row stride so the score loop is free of bank
//   conflicts.  Masking follows the Pallas kernel exactly (finite -1e30, so a
//   row whose window has not started carries p = 1 until the first in-window
//   page zeroes it through alpha); K/V entries past the tile's last
//   diagonal are staged as zeros, so garbage there cannot leak in.  Ragged
//   S is masked per row, no padding is needed.  Everything is staged and
//   summed in fp32; over bf16 pages p is rounded to bf16 before the PV
//   product (l sums the unrounded p), as the Pallas kernel does.  Tensor-core (wgmma) tiles
//   and TMA page loads are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 16;
constexpr int kMaxD = 256;
constexpr int kMaxAcc = kBlockQ * kMaxD / kThreads;
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
paged_prefill_kernel(const TQ* __restrict__ q,              // (B, Hq, S, D)
                     const TKV* __restrict__ k_pages,       // (P, Hkv, ps, D)
                     const TKV* __restrict__ v_pages,
                     const float* __restrict__ k_scale,     // (P, Hkv, ps)
                     const float* __restrict__ v_scale,
                     const int32_t* __restrict__ block_tables,  // (B, nb)
                     const int32_t* __restrict__ kv_offset,     // (B,)
                     TQ* __restrict__ out,                  // (B, Hq, S, D)
                     int hq, int hkv, int s_len, int ps, int d, int nb,
                     float scale, float softcap, int window) {
  constexpr bool Q8 = sizeof(TKV) == 1;
  extern __shared__ float smem[];
  const int dk = d + 1;                      // padded K row stride
  float* qs = smem;                          // kBlockQ * d
  float* ks = qs + kBlockQ * d;              // ps * dk
  float* vs = ks + ps * dk;                  // ps * d
  float* sc = vs + ps * d;                   // kBlockQ * ps
  float* m_s = sc + kBlockQ * ps;            // kBlockQ
  float* l_s = m_s + kBlockQ;                // kBlockQ
  float* a_s = l_s + kBlockQ;                // kBlockQ

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int rows = min(kBlockQ, s_len - q0);
  const int off = kv_offset[b];
  const int tid = threadIdx.x;
  const int last_pos = off + q0 + rows - 1;  // the tile's last diagonal

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d;
    qs[i] = r < rows ? to_f(q[((size_t)bh * s_len + q0 + r) * d + (i % d)]) * scale
                     : 0.f;
  }
  for (int r = tid; r < kBlockQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  int n_pages = last_pos / ps + 1;
  if (n_pages > nb) n_pages = nb;
  for (int j = 0; j < n_pages; ++j) {
    const int page = block_tables[(size_t)b * nb + j];
    const size_t row0 = ((size_t)page * hkv + kvh) * ps;
    for (int i = tid; i < ps * d; i += kThreads) {
      const int t = i / d;
      const int c = i % d;
      const bool live = j * ps + t <= last_pos;
      float kv = 0.f, vv = 0.f;
      if (live) {
        kv = to_f(k_pages[row0 * d + i]);
        vv = to_f(v_pages[row0 * d + i]);
        if (Q8) {
          kv *= k_scale[row0 + t];
          vv *= v_scale[row0 + t];
        }
      }
      ks[t * dk + c] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    for (int e = tid; e < kBlockQ * ps; e += kThreads) {
      const int r = e / ps;
      const int t = e % ps;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s += qs[r * d + c] * ks[t * dk + c];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int qpos = off + q0 + r;
      const int kpos = j * ps + t;
      bool ok = kpos <= qpos;
      if (window > 0) ok = ok && (kpos > qpos - window);
      sc[e] = ok ? s : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < kBlockQ; r += kThreads) {
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[r * ps + t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sc[r * ps + t] - m_new);
        sc[r * ps + t] = round_p<TKV>(p);
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int e = tid + k * kThreads;
      if (e < kBlockQ * d) {
        const int r = e / d;
        const int c = e % d;
        float a = acc[k] * a_s[r];
        for (int t = 0; t < ps; ++t) a += sc[r * ps + t] * vs[t * d + c];
        acc[k] = a;
      }
    }
    __syncthreads();         // ks/vs/sc are rewritten by the next page
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int e = tid + k * kThreads;
    if (e < kBlockQ * d) {
      const int r = e / d;
      if (r < rows) {
        const float l = l_s[r] == 0.f ? 1.f : l_s[r];
        out[((size_t)bh * s_len + q0 + r) * d + (e % d)] = from_f<TQ>(acc[k] / l);
      }
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* kv_offset, void* out, int b, int hq, int hkv, int s_len,
           int ps, int d, int nb, float scale, float softcap, int window,
           cudaStream_t stream) {
  const dim3 grid(b * hq, (s_len + kBlockQ - 1) / kBlockQ);
  const size_t smem = sizeof(float) *
      ((size_t)kBlockQ * d + (size_t)ps * (d + 1) + (size_t)ps * d +
       (size_t)kBlockQ * ps + 3 * kBlockQ);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_prefill_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(kv_offset), static_cast<TQ*>(out), hq, hkv,
      s_len, ps, d, nb, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pages only, with scales).
// q and out share q_dtype; fp32 and bf16 pages go with a q of their dtype.
static int paged_prefill_attention_impl(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_offset, void* out, int q_dtype, int kv_dtype, int b,
    int hq, int hkv, int s_len, int ps, int d, int nb, float scale,
    float softcap, int window, void* stream) {
  if (d > kMaxD || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS q, k_pages, v_pages, k_scale, v_scale, block_tables,      \
    kv_offset, out, b, hq, hkv, s_len, ps, d, nb, scale, softcap, window, s
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
extern "C" int paged_prefill_attention(const long long* args) {
  return call_packed(paged_prefill_attention_impl, args);
}
