// The step of the register-tiled fp32 attention kernels (the fp32 routes
// of flash_attention.cu and paged_prefill_attention.cu) over one tile of
// 32 keys: a block of 128 threads owns 32 query rows, thread (tr, tk) =
// (tid / 16, tid % 16) the rows tr + 8i (i < 4).  S = Q K^T by float4
// reads of Q (a broadcast within the half-warp) and K (rows padded so that
// the 16 lanes hit distinct banks), the keys tk + 16j (j < 2); scale,
// softcap and mask in fp32, base 2, masked pairs p = 0 by a select; the
// rows' max and sum over the 16 lanes of the half-warp; P through shared
// memory to the same 16 lanes (a __syncwarp, no barrier); O = alpha O + P
// V over the columns tk * 4 + 64c.

#pragma once

#include "device_helpers.h"

constexpr int kF32Keys = 32;           // keys a tile
constexpr int kF32PS = 32 + 4;         // padded row of the P tile (floats)

// qs: 32 rows of Q, kt / vt: the tile's K and V, all with rows of DP + 4
// floats, zeros past D; ps: the P tile (32 x kF32PS floats).  j0: the
// tile's first key; valid(i, kpos): whether row tr + 8i sees key kpos.
template <int DP, typename Valid>
__device__ __forceinline__ void f32_attention_tile(const float* qs, const float* kt,
                                                   const float* vt, float* ps, int j0, int tr,
                                                   int tk, float scale, float softcap,
                                                   Valid valid, float (&o)[4][DP / 16],
                                                   float (&m)[4], float (&l)[4]) {
  constexpr float kNegInf = -1.0e30f;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int RS = DP + 4, CG = DP / 64;
  const float scale_log2 = scale * kLog2e;
  // S = Q K^T: rows tr + 8i, keys tk + 16j
  float s[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 qv[4], kv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (tr + 8 * i) * RS + c);
#pragma unroll
    for (int j = 0; j < 2; ++j) kv[j] = *reinterpret_cast<const float4*>(kt + (tk + 16 * j) * RS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }

  // scale, softcap and mask in fp32, base 2; the rows' max and sum over
  // the 16 lanes of this half-warp
  float alpha[4], p[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kpos = j0 + tk + 16 * j;
      float x = s[i][j] * scale_log2;
      if (softcap > 0.f) x = softcap * tanhf(s[i][j] * scale / softcap) * kLog2e;
      s[i][j] = valid(i, kpos) ? x : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int sh = 1; sh < 16; sh *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    alpha[i] = exp2f(m[i] - mx);
    m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      p[i][j] = s[i][j] == kNegInf ? 0.f : exp2f(s[i][j] - mx);
      sum += p[i][j];
    }
#pragma unroll
    for (int sh = 1; sh < 16; sh *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
    l[i] = l[i] * alpha[i] + sum;
  }
  // P to this half-warp's 16 lanes: P[key][tr * 4 + i]
#pragma unroll
  for (int j = 0; j < 2; ++j)
    *reinterpret_cast<float4*>(ps + (tk + 16 * j) * kF32PS + tr * 4) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
  __syncwarp();

  // O = alpha O + P V: rows tr + 8i, columns tk * 4 + 64c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) o[i][c] *= alpha[i];
#pragma unroll 4
  for (int key = 0; key < kF32Keys; ++key) {
    const float4 pv = *reinterpret_cast<const float4*>(ps + key * kF32PS + tr * 4);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const float4 vv = *reinterpret_cast<const float4*>(vt + key * RS + cg * 64 + tk * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][4 * cg] = fmaf(pr[i], vv.x, o[i][4 * cg]);
        o[i][4 * cg + 1] = fmaf(pr[i], vv.y, o[i][4 * cg + 1]);
        o[i][4 * cg + 2] = fmaf(pr[i], vv.z, o[i][4 * cg + 2]);
        o[i][4 * cg + 3] = fmaf(pr[i], vv.w, o[i][4 * cg + 3]);
      }
    }
  }
  __syncwarp();  // P is read; the next tile's P may overwrite it
}
