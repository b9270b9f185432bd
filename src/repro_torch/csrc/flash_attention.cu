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
//   memory ridge.  This first kernel runs on the CUDA cores in fp32; the
//   tensor cores (wgmma) are left for a later change.
//
// Design: one block of 128 threads per (batch, q-head, tile of 32 query
//   rows).  Q, K and V are addressed through (batch, head, row) strides, so
//   strided views of a KV cache (the first Skv positions of the stacked
//   (B, Hkv, T, D) cache or of the backend's (B, T, Hkv, D) buffer) are read
//   in place.  The block walks K/V tiles of 32 keys, staging each as fp32
//   in shared memory; tiles wholly above the tile's last diagonal (causal)
//   or wholly before its first row's window are never loaded.  Four threads
//   share a query row: each scores 8 of the tile's keys (Q and K rows are
//   padded by one word so the loads are free of bank conflicts), the row's
//   max and sum are reduced with two warp shuffles, and each thread keeps
//   the online softmax (m, l) and D / 4 accumulator columns of its row in
//   registers.  Masked (query, key) pairs get p = 0 exactly (a select, not
//   exp(-inf)), and key rows outside [0, Skv) or past the tile's last
//   diagonal are staged as zeros, so nothing past Skv, NaN included,
//   reaches a valid row; a row with no valid key writes 0.  p is rounded to
//   the value dtype before the PV product (bf16), as the Pallas kernel does;
//   l sums the unrounded p.
//   Ragged Sq and Skv are masked in the kernel: nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kRowThreads = kThreads / kBlockQ;      // 4 threads per row
constexpr int kKeysPerThread = kBlockK / kRowThreads;  // 8
constexpr int kMaxD = 256;
constexpr int kMaxAcc = kMaxD / kRowThreads;         // 64
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_p(float p) { return p; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, long long q_sb, long long q_sh,
             long long q_ss, const T* __restrict__ k,
             const T* __restrict__ v, long long kv_sb, long long kv_sh,
             long long kv_ss, T* __restrict__ out, long long o_sb,
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

  const T* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int rr = i / d, c = i % d;
    qs[rr * dp + c] = q0 + rr < sq ? to_f(qb[(q0 + rr) * q_ss + c]) * scale : 0.f;
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

  const T* kb = k + b * kv_sb + kvh * kv_sh;
  const T* vb = v + b * kv_sb + kvh * kv_sh;
  for (int j0 = k_lo; j0 < k_hi; j0 += kBlockK) {
    __syncthreads();             // the previous tile's K/V/P are consumed
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int t = i / d, c = i % d;
      const int kpos = j0 + t;
      const bool live = kpos < k_hi;
      ks[t * dp + c] = live ? to_f(kb[kpos * kv_ss + c]) : 0.f;
      vs[t * d + c] = live ? to_f(vb[kpos * kv_ss + c]) : 0.f;
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
      ps[r * (kBlockK + 1) + part + kRowThreads * j] = round_p<T>(p);
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
    T* ob = out + b * o_sb + h * o_sh + qpos * o_ss;
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int c = part + kRowThreads * i;
      if (c < d) ob[c] = from_f<T>(acc[i] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, long long q_sb, long long q_sh, long long q_ss,
           const void* k, const void* v, long long kv_sb, long long kv_sh,
           long long kv_ss, void* out, long long o_sb, long long o_sh,
           long long o_ss, int b, int hq, int hkv, int sq, int skv, int d,
           float scale, float softcap, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBlockQ * (d + 1) + (size_t)kBlockK * (d + 1) +
       (size_t)kBlockK * d + (size_t)kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, (sq + kBlockQ - 1) / kBlockQ);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, q_ss, static_cast<const T*>(k),
      static_cast<const T*>(v), kv_sb, kv_sh, kv_ss, static_cast<T*>(out),
      o_sb, o_sh, o_ss, hq, hkv, sq, skv, d, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out share one dtype).
extern "C" int flash_attention(
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_ss, void* out, long long o_sb, long long o_sh,
    long long o_ss, int dtype, int b, int hq, int hkv, int sq, int skv,
    int d, float scale, float softcap, int causal, int window,
    void* stream) {
  if (d > kMaxD || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_ss, out,
                         o_sb, o_sh, o_ss, b, hq, hkv, sq, skv, d, scale,
                         softcap, causal, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh,
                                 kv_ss, out, o_sb, o_sh, o_ss, b, hq, hkv, sq,
                                 skv, d, scale, softcap, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
