// Helpers shared by the kernels built for sm_90a: cp.async copies into
// shared memory, the ldmatrix and mma.sync fragment ops of the bf16
// tensor-core kernels (and the hi/lo bf16 split of an fp32 value), an
// exact int8 -> fp32 conversion, and the launch
// side's once-per-device setup.  build.target's digest covers this header,
// so an edit here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

constexpr int kMaxDevices = 64;

// The head dims the bf16 tensor-core attention kernels are instantiated at:
// every multiple of 16 from 16 to 256 (their tiles are 16 columns wide).
// X(D) is expanded once for each.
#define BF16_ATTENTION_HEAD_DIMS(X)                                                      \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192) X(208) \
      X(224) X(240) X(256)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled, and nothing read, when `valid` is
// false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, zero-filled without a read when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
// The commit and the wait clobber memory, so that a thread reading what it
// copied itself, with no barrier in between, reads it after the wait.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.  Not
// volatile: a register-only op the compiler may schedule between the next
// fragments' loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// w as hi + lo, two bf16 each rounded to nearest: 16 significant bits of w
__device__ __forceinline__ void split_bf16(float w0, float w1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(w0 - __low2float(h), w1 - __high2float(h));
}

// Four int8 values (little-endian in `w`) as exact fp32: each byte, biased
// by 128, becomes the low mantissa byte of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The first launch of `kernel` on the current device raises its dynamic
// shared-memory limit to `smem_bytes` and reads the device's SM count into
// `sms`; every later launch there reads the count back, so a launch costs
// one cudaGetDevice.  Returns a cudaError_t (0: the count is in `sm_count`).
template <typename Kernel>
int kernel_setup(Kernel kernel, int smem_bytes, std::atomic<int> (&sms)[kMaxDevices],
                 int& sm_count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  sm_count = sms[dev].load(std::memory_order_acquire);
  if (sm_count > 0) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  sms[dev].store(sm_count, std::memory_order_release);
  return 0;
}
