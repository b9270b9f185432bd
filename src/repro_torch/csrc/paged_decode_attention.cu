// Paged flash-decode: one query token per (batch, q-head) attending over the
// KV pages named by that row's block table.  Built for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py · paged_decode_attention
//   (_paged_body; fp32 q with fp32 pages, bf16 q with bf16 pages, and either
//   q with int8 pages plus per-(page, head, token) fp32 scales, dequantized
//   in fp32 as the Pallas kernel does).
//
// What bounds it on the H100: bytes.  Each (batch, kv-head) row reads
//   kv_len rows of K and V once (4 * kv_len * D bytes in bf16, 8 * kv_len *
//   D in fp32, 2 * kv_len * (D + 4) for int8 pages) and does 4 FLOPs per
//   element and q-head, far below the card's ridge in any dtype.
//
// Every route keeps the paged rules: pages at or past kv_len (the trash
//   page, stale pool rows) are never read, so a NaN there reaches no
//   output; over bf16 pages p is rounded to bf16 before the PV product and
//   l sums the unrounded p, as the Pallas kernel and the dense kernels do;
//   int8 pages are dequantized in fp32; a row with no valid key writes 0.
//
// bf16 q (bf16 or int8 pages; head dims 16/32/64/128/256, 16-byte aligned
//   rows, refused otherwise): the split-KV kernel of csrc/split_decode.h,
//   the dense bf16 decode's design over the block tables.  One cluster of
//   1-8 blocks per (batch, kv-head, group of up to 16 q-heads): the GQA
//   group's q rows are the rows of the mma tiles, so a page leaves device
//   memory once for the group, and the blocks take contiguous ranges of
//   the row's keys, merged in rank order through distributed shared memory
//   in the one launch.  A 64-key tile is gathered row by row through the
//   block table (any page size: 64 / ps pages, or part of one) by 16-byte
//   cp.async.  int8 pages keep the fp32 rule on the tensor cores as the
//   paged prefill does: the tile widened to exact bf16, K's scale
//   multiplying the score in fp32, p * V's scale split into hi and lo bf16
//   terms for two PV products.
//
// fp32 q (fp32 or int8 pages): one block of 128 threads per (batch, q-head)
//   walks the row's pages in order, keeping the online softmax (m, l) and
//   the output accumulator in registers.  Positions past kv_len inside the
//   last page are masked before the softmax and skipped in the PV sum.
//   Warps score one token each (lanes read consecutive head-dim elements,
//   so every K row load is coalesced); each thread then owns up to two
//   head-dim columns of the output, so V rows are read coalesced too.  GQA
//   maps q-head h to kv-head h / group; the q-heads of a group re-read the
//   same pages, which the 50 MB L2 absorbs.

#include <type_traits>

#include "device_helpers.h"
#include "launch_args.h"
#include "split_decode.h"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16 q: split-KV over a cluster, tensor cores (csrc/split_decode.h)
// ---------------------------------------------------------------------------

// K/V rows (and scales) of one (batch, kv-head) through the row's block
// table: token t lies in page table[t / ps] at row t % ps.
template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const int32_t* table;
  int hkv, kvh, ps, d;
  __device__ long long sc(int t) const {
    const int j = t / ps;
    return ((long long)table[j] * hkv + kvh) * ps + (t - j * ps);
  }
  __device__ long long kv(int t) const { return sc(t) * d; }
};

// One cluster per (batch, kv-head, group of 16 q-heads).  RULE: bf16
// pages, or int8 pages with per-token fp32 scales dequantized in fp32.
template <int D, int RULE>
__global__ void __launch_bounds__(split_decode::kThreads)
paged_split_kernel(const bf16* __restrict__ q, const void* __restrict__ k_pages,
                   const void* __restrict__ v_pages, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int32_t* __restrict__ block_tables,
                   const int32_t* __restrict__ kv_len, bf16* __restrict__ out, int hq, int hkv,
                   int ps, int nb, float scale, float softcap) {
  typedef typename std::conditional<RULE == split_decode::kBf16, bf16, int8_t>::type TKV;
  const split_decode::Block blk = split_decode::block_of(hq, hkv);
  const PagedRows<TKV> rows{static_cast<const TKV*>(k_pages), static_cast<const TKV*>(v_pages),
                            k_scale, v_scale, block_tables + (long long)blk.b * nb, hkv,
                            blk.kvh, ps, D};
  const long long row0 = ((long long)blk.b * hq + blk.h0) * D;
  split_decode::run<D, RULE>(q + row0, D, out + row0, D, blk.gn,
                             max(0, min(kv_len[blk.b], nb * ps)), rows, scale, softcap);
}

template <int D, bool Q8>
int launch_split(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
                 const void* v_scale, const void* block_tables, const void* kv_len, void* out,
                 int b, int hq, int hkv, int ps, int nb, float scale, float softcap,
                 cudaStream_t stream) {
  constexpr int RULE = Q8 ? split_decode::kInt8Fp32 : split_decode::kBf16;
  static std::atomic<int> sms[kMaxDevices];
  return split_decode::launch<D, RULE>(
      paged_split_kernel<D, RULE>, sms, b, hq, hkv, nb * ps, stream,
      static_cast<const bf16*>(q), k_pages, v_pages, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(kv_len), static_cast<bf16*>(out), hq, hkv, ps, nb, scale,
      softcap);
}

// ---------------------------------------------------------------------------
// fp32 q: a block per q-head
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 2;            // head dim <= kThreads * kMaxCols
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,            // (B, Hq, D)
                    const TKV* __restrict__ k_pages,        // (P, Hkv, ps, D)
                    const TKV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,      // (P, Hkv, ps)
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_tables,  // (B, nb)
                    const int32_t* __restrict__ kv_len,        // (B,)
                    float* __restrict__ out,                // (B, Hq, D)
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

  for (int i = tid; i < d; i += kThreads) qs[i] = q[(size_t)bh * d + i] * scale;
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
      const size_t base = (row0 + t) * d;
      const float vsc = Q8 ? v_scale[row0 + t] : 1.f;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int i = tid + c * kThreads;
        if (i < d) acc[c] += p * (to_f(v_pages[base + i]) * vsc);
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
    if (i < d) out[(size_t)bh * d + i] = acc[c] / denom;
  }
}

template <typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* kv_len, void* out, int b, int hq, int hkv, int ps,
           int d, int nb, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)(d + ps) * sizeof(float);
  paged_decode_kernel<TKV><<<b * hq, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(kv_len), static_cast<float*>(out), hq, hkv, ps,
      d, nb, scale, softcap);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pages only, with scales).
// q and out share q_dtype; fp32 and bf16 pages go with a q of their dtype.
// A bf16 q takes D in {16, 32, 64, 128, 256} with q, the pages and out
// 16-byte aligned; an fp32 q D up to 256.  Anything else returns
// cudaErrorInvalidValue.
static int paged_decode_attention_impl(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, void* out, int q_dtype, int kv_dtype, int b, int hq,
    int hkv, int ps, int d, int nb, float scale, float softcap, void* stream) {
  if (d > kThreads * kMaxCols || hkv <= 0 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  const bool q8 = kv_dtype == 2;
  if (q8 ? (k_scale == nullptr || v_scale == nullptr) : kv_dtype != q_dtype)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1) {
    if (!aligned16(q) || !aligned16(k_pages) || !aligned16(v_pages) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
#define SPLIT_ARGS q, k_pages, v_pages, k_scale, v_scale, block_tables, kv_len, out, b, hq, hkv, \
    ps, nb, scale, softcap, s
#define SPLIT(D)                                                             \
  case D:                                                                    \
    return q8 ? launch_split<D, true>(SPLIT_ARGS) : launch_split<D, false>(SPLIT_ARGS);
    switch (d) {
      SPLIT(16)
      SPLIT(32)
      SPLIT(64)
      SPLIT(128)
      SPLIT(256)
    }
#undef SPLIT
#undef SPLIT_ARGS
    return (int)cudaErrorInvalidValue;
  }
#define PAGED_ARGS q, k_pages, v_pages, k_scale, v_scale, block_tables, kv_len, \
    out, b, hq, hkv, ps, d, nb, scale, softcap, s
  if (q_dtype == 0) return q8 ? launch<int8_t>(PAGED_ARGS) : launch<float>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int paged_decode_attention(const long long* args) {
  return call_packed(paged_decode_attention_impl, args);
}
