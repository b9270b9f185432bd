// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, or * (1 + w) for the
// gemma-style scale, with fp32 statistics.  Built for sm_90a.
//
// Replaces: src/repro/kernels/rmsnorm.py · rmsnorm (_rmsnorm_kernel).
//
// What bounds it on the H100: bytes.  Each row is read from device memory
//   once and written once (the second read of the row comes from L1/L2);
//   about 4 FLOPs per element.
//
// Design: one block of 256 threads per row.  Where the row and the weight
//   are 16-byte aligned and D is a multiple of the vector width, each thread
//   moves 16 bytes per load (8 bf16 or 4 fp32); otherwise it falls back to
//   element loads.  The sum of squares is reduced with warp shuffles and
//   one shared-memory step; the normalising pass re-reads the row.  Rows are
//   addressed through a row stride, so a strided slice such as x[:, -1:]
//   is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int V>
struct alignas(16) Vec {
  T e[V];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, long long x_rs, const T* __restrict__ w,
               T* __restrict__ out, long long o_rs, int d, float eps,
               int plus_one, int vec) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[kWarps];
  __shared__ float inv_s;
  const T* xr = x + blockIdx.x * x_rs;
  T* orow = out + blockIdx.x * o_rs;
  const int tid = threadIdx.x;

  float ss = 0.f;
  if (vec) {
    const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(xr);
    for (int i = tid; i < d / V; i += kThreads) {
      const Vec<T, V> a = xv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(a.e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = tid; i < d; i += kThreads) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tid % 32 == 0) part[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int i = 0; i < kWarps; ++i) t += part[i];
    inv_s = 1.f / sqrtf(t / d + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  const float add = plus_one ? 1.f : 0.f;

  if (vec) {
    const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(xr);
    const Vec<T, V>* wv = reinterpret_cast<const Vec<T, V>*>(w);
    Vec<T, V>* ov = reinterpret_cast<Vec<T, V>*>(orow);
    for (int i = tid; i < d / V; i += kThreads) {
      const Vec<T, V> a = xv[i];
      const Vec<T, V> g = wv[i];
      Vec<T, V> y;
#pragma unroll
      for (int j = 0; j < V; ++j)
        y.e[j] = from_f<T>(to_f(a.e[j]) * inv * (to_f(g.e[j]) + add));
      ov[i] = y;
    }
  } else {
    for (int i = tid; i < d; i += kThreads)
      orow[i] = from_f<T>(to_f(xr[i]) * inv * (to_f(w[i]) + add));
  }
}

template <typename T>
int launch(const void* x, long long x_rs, const void* w, void* out,
           long long o_rs, int rows, int d, float eps, int plus_one,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && x_rs % V == 0 && o_rs % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), x_rs, static_cast<const T*>(w),
      static_cast<T*>(out), o_rs, d, eps, plus_one, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, w and out share one dtype).
extern "C" int rmsnorm(const void* x, long long x_rs, const void* w,
                       void* out, long long o_rs, int dtype, int rows, int d,
                       float eps, int plus_one, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, x_rs, w, out, o_rs, rows, d, eps, plus_one, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, x_rs, w, out, o_rs, rows, d, eps, plus_one, s);
  return (int)cudaErrorInvalidValue;
}
