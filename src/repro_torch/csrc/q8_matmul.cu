// Int8-weight matmul with per-column scales: y = (x @ q) * scale[col], fp32
// accumulate.  The device share of every alpha-split linear when weights
// stream as int8 (wstream="q8").  Built for sm_90a.
//
// Replaces: src/repro/kernels/q8_matmul.py · q8_matmul (_q8_kernel).
//
// What bounds it on the H100: at decode (M = batch, a handful of rows) the
//   bytes, K * N int8 weight bytes read once against 2 * M FLOPs per byte;
//   at prefill (M = batch * chunk, hundreds of rows) the FLOPs on the fp32
//   CUDA cores, 2 * M * N * K at 67 TFLOP/s.
//
// Design: a classic shared-memory tiled SGEMM.  A block of 256 threads owns
//   a 64 x 64 output tile and walks K in steps of 16; each step stages the
//   x tile (transposed) and the int8 weight tile, dequantized to fp32 as it
//   lands in shared memory, so device memory only ever moves int8 weights.
//   Each thread accumulates a 4 x 4 register tile and applies the column
//   scale once in the epilogue, as the Pallas kernel does.  Every edge is
//   masked in the kernel: the Pallas version asserts M, N and K divide its
//   blocks, but prefill M = B * S rarely does.  Small-M decode launches only
//   ceil(N / 64) blocks; split-K and a W8A16 tensor-core (wgmma) path are
//   left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const float* __restrict__ x,        // (M, K)
                 const int8_t* __restrict__ q,       // (K, N)
                 const float* __restrict__ scale,    // (N,)
                 float* __restrict__ y,              // (M, N)
                 int m, int n, int k) {
  __shared__ float xs[kBK][kBM + 4];
  __shared__ float ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < m && gk < k) ? x[(size_t)gm * k + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      ws[r][c] = (gk < k && gn < n)
                     ? static_cast<float>(q[(size_t)gk * n + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
      float w[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = ws[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += a[i] * w[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * (kBM / kTM);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * (kBN / kTN);
      if (gm < m && gn < n) y[(size_t)gm * n + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

static int q8_matmul_f32_impl(const void* x, const void* q, const void* scale,
                              void* y, int m, int n, int k, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  q8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale, (float*)y, m, n,
      k);
  return (int)cudaGetLastError();
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int q8_matmul_f32(const long long* args) {
  return call_packed(q8_matmul_f32_impl, args);
}
