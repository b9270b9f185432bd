// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, or * (1 + w) for the
// gemma-style scale, with fp32 statistics.  Built for sm_90a.
//
// Replaces: src/repro/kernels/rmsnorm.py · rmsnorm (_rmsnorm_kernel).
//
// What bounds it on the H100: bytes.  Each row is read from device memory
//   once and written once; about 4 FLOPs per element.  At decode (4 rows)
//   the device time is a few microseconds, below the host's time to issue
//   a call, so the wrapper's launch path matters as much as the kernel.
//
// Design: one block of four warps per row.  Where the row and the weight
//   are 16-byte aligned, D is a multiple of the vector width and the row
//   fits the register budget (at most 40 16-byte vectors a thread: D up to
//   40960 in bf16, 20480 in fp32; 2560 and 5120 bf16 take 3 and 5), each
//   thread loads its share of the row once with 16-byte loads into
//   registers, the sum of squares is reduced with warp shuffles and one
//   shared-memory step, and the normalising pass runs from the registers:
//   the row is read once.  Other rows (an odd width such as 100, an
//   unaligned stride) take a two-pass loop that re-reads the row.  The
//   arithmetic follows the plain version operation by operation, each
//   rounded to fp32 as PyTorch rounds it (x^2, the mean as sum * (1 / D),
//   + eps, rsqrt, * rsqrt, * w), and the result is rounded once to the
//   output dtype, so it is bit-equal to the plain version except where the
//   order of the sum moves the rsqrt by an ulp.  Rows are addressed through
//   a row stride, so a strided slice such as x[:, -1:] is read in place.
//
// On the card (one H100, bf16, device time): one warp per row with four
//   rows a block and 20 vectors a lane at D = 5120 took 0.0078 ms at 4
//   rows and 0.019 at 2048, against 0.0031 and 0.0150 for the earlier
//   block of 256 per row that read the row twice: four rows on one SM are
//   bound by that SM's loads, and 110 registers a thread leave too few
//   rows in flight.  This design took 0.0030, 0.0150 and 0.0058 (2048 x
//   2560, against 0.0069).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kWarps = 4;  // one row a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecs = 40;  // 16-byte vectors a thread may hold

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A 16-byte vector of V = 16 / sizeof(T) elements as four 32-bit words:
// element e as fp32 (bf16 widens exactly by a shift), and V fp32 values
// rounded once into one.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float get(const uint4& u, int e) {
    return __uint_as_float(e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w);
  }
  static __device__ __forceinline__ uint4 put(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float get(const uint4& u, int e) {
    const uint32_t w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint4 put(const float (&f)[8]) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
  }
};

// The row's sum over the block: warp shuffles, then the four warps' sums
// through shared memory; every thread gets the total.
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += part[i];
  return t;
}

// rsqrt(sum / d + eps), each step rounded as the plain version rounds it
__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / (float)d), eps));
}

// x * rsqrt * w, with w + 1 for the gemma-style scale
__device__ __forceinline__ float norm(float x, float inv, float w, int plus_one) {
  return __fmul_rn(__fmul_rn(x, inv), plus_one ? __fadd_rn(w, 1.f) : w);
}

// The row in registers: NV vectors a thread, one read.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_regs_kernel(const T* __restrict__ x, long long x_rs, const T* __restrict__ w,
                    T* __restrict__ out, long long o_rs, int d, float eps, int plus_one) {
  using P = Vec16<T>;
  constexpr int V = P::V;
  const int tid = threadIdx.x;
  const int nvec = d / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + blockIdx.x * x_rs);
  uint4 a[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (tid + kThreads * j < nvec) a[j] = xv[tid + kThreads * j];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (tid + kThreads * j < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = P::get(a[j], e);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  const float inv = inv_rms(block_sum(ss), d, eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* ov = reinterpret_cast<uint4*>(out + blockIdx.x * o_rs);
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (tid + kThreads * j < nvec) {
      // the row's words, opaque to the compiler: it widens them again here
      // instead of keeping every widened value of the sum's loop live
      asm volatile("" : "+r"(a[j].x), "+r"(a[j].y), "+r"(a[j].z), "+r"(a[j].w));
      const uint4 g = wv[tid + kThreads * j];
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = norm(P::get(a[j], e), inv, P::get(g, e), plus_one);
      ov[tid + kThreads * j] = P::put(y);
    }
}

// Any row: element loads, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop_kernel(const T* __restrict__ x, long long x_rs, const T* __restrict__ w,
                    T* __restrict__ out, long long o_rs, int d, float eps, int plus_one) {
  const T* xr = x + blockIdx.x * x_rs;
  T* orow = out + blockIdx.x * o_rs;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float f = to_f(xr[i]);
    ss = __fadd_rn(ss, __fmul_rn(f, f));
  }
  const float inv = inv_rms(block_sum(ss), d, eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f<T>(norm(to_f(xr[i]), inv, to_f(w[i]), plus_one));
}

template <typename T>
int launch(const void* x, long long x_rs, const void* w, void* out, long long o_rs, int rows,
           int d, float eps, int plus_one, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && x_rs % V == 0 && o_rs % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int thread_vecs = (d / V + kThreads - 1) / kThreads;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
#define RMS_REGS(NV)                                                                        \
  if (thread_vecs <= NV) {                                                                  \
    rmsnorm_regs_kernel<T, NV><<<rows, kThreads, 0, stream>>>(xt, x_rs, wt, ot, o_rs, d, eps, \
                                                              plus_one);                    \
    return (int)cudaGetLastError();                                                         \
  }
  if (vec) {
    RMS_REGS(1)
    RMS_REGS(2)
    RMS_REGS(3)
    RMS_REGS(4)
    RMS_REGS(5)
    RMS_REGS(6)
    RMS_REGS(8)
    RMS_REGS(10)
    RMS_REGS(16)
    RMS_REGS(20)
    RMS_REGS(kMaxVecs)
  }
#undef RMS_REGS
  rmsnorm_loop_kernel<T><<<rows, kThreads, 0, stream>>>(xt, x_rs, wt, ot, o_rs, d, eps, plus_one);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, w and out share one dtype).
static int rmsnorm_impl(const void* x, long long x_rs, const void* w,
                        void* out, long long o_rs, int dtype, int rows, int d,
                        float eps, int plus_one, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, x_rs, w, out, o_rs, rows, d, eps, plus_one, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, x_rs, w, out, o_rs, rows, d, eps, plus_one, s);
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int rmsnorm(const long long* args) {
  return call_packed(rmsnorm_impl, args);
}
