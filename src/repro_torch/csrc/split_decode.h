// Flash-decode under a bf16 q, split across a thread-block cluster: the
// kernel body shared by the dense cache (csrc/decode_attention.cu) and the
// paged pool (csrc/paged_decode_attention.cu).  The two differ only in
// where a token's K/V row lies (a `Rows` type: `kv(t)`, the element offset
// of token t's row, and `sc(t)`, the index of its scales) and in how int8
// values reach the tensor cores (`Rule`).
//
// One cluster per (batch, kv-head, group of up to 16 q-heads).  The
// cluster's blocks (1-8, chosen so that the grid holds about one block per
// SM) take contiguous ranges of the row's kv_len tokens; the q-heads of the
// GQA group (the rows of one mma tile; a larger group takes several
// clusters) share every K/V row the block reads, so each row leaves device
// memory once instead of once per q-head.  A block of four warps streams
// tiles of 64 tokens through two cp.async stages (16-byte copies; tokens
// past the block's range are zero-filled without a read, so a row at or
// past kv_len, a page past it included, is never touched) and each warp
// takes 16 of a tile's tokens: S = Q K^T on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate, the group's q rows in the A
// fragments), scores scaled and softcapped in fp32, one online-softmax
// update a tile in base 2, p into the PV A fragments, O += P V on the
// tensor cores; l sums the unrounded p.  An int8 tile (its per-token
// scales staged with it) is widened by the warp that uses it into a bf16
// buffer first.  The four warps' (m, l, O) merge through shared memory in
// warp order, then the blocks' through distributed shared memory in rank
// order, each block finishing a share of the outputs, all inside the one
// launch; a block whose range lies past kv_len reads nothing and
// contributes l = 0, which the merge weights by 0 (it never forms
// exp(-inf - -inf)), and a row with no valid key writes 0.  No atomics:
// two calls give the same bits.
//
// The cluster's parts do not depend on bf16 and serve the fp32-q paged
// decode too (csrc/paged_decode_attention.cu), whose tile step runs on
// the CUDA cores: the block's place and key range (block_of, range_of),
// the warps' and the ranks' merges (merge_warps, merge_ranks) and the
// launch (launch_clusters).

#pragma once

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "device_helpers.h"

namespace split_decode {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // tokens a tile, 16 a warp
constexpr int kStages = 2;          // K/V tiles in shared memory
constexpr int kRows = 16;           // q-heads a block: the rows of an mma tile
constexpr int kMaxCluster = 8;
constexpr int kBlocksPerSm = 1;     // the grid aims at this many blocks an SM

// The K/V values and how they reach the tensor cores.
enum Rule {
  kBf16 = 0,      // bf16 K/V as they are; p rounded to bf16 before P V
  kInt8Bf16 = 1,  // int8 with per-token scales dequantized in bf16,
                  // bf16(bf16(k) * bf16(scale)), then as bf16 (a dense
                  // cache under a bf16 q: the JAX stacked path's rule)
  kInt8Fp32 = 2,  // int8 dequantized in fp32 (the paged rule): the value
                  // widened to exact bf16, K's scale multiplying the score
                  // in fp32, and p * V's scale split into hi and lo bf16
                  // terms for two P V products (16 significant bits)
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D, int RULE>
struct Cfg {
  static constexpr bool Q8 = RULE != kBf16;
  static constexpr int RS = D + 8;                // padded bf16 row (elements)
  static constexpr int KT = D / 16;               // k-steps of Q K^T
  static constexpr int DT = D / 8;                // n8 tiles of O
  static constexpr bool QREGS = D <= 128;         // Q fragments in registers
  static constexpr int ROW_BYTES = Q8 ? D : 2 * RS;                    // a staged row
  static constexpr int TILE = kTile * ROW_BYTES;                       // a K or V tile
  static constexpr int STAGE = 2 * TILE + (Q8 ? 2 * kTile * 4 : 0);    // K, V (and scales)
  static constexpr int WBUF = Q8 ? kWarps * 2 * 16 * RS * 2 : 0;       // widened slices
  static constexpr int OS = D + 4;                                     // merge row (floats)
  static constexpr int MERGE = kWarps * kRows * (OS + 2) * 4;          // warps' (m, l, O)
  static constexpr int PART = (kRows * D + 2 * kRows) * 4;             // the block's (m, l, O)
  // the tiles while the block streams; the warps' states and the block's
  // after it
  static constexpr int WORK = (kStages * STAGE + WBUF) > MERGE + PART
                                  ? kStages * STAGE + WBUF : MERGE + PART;
  static constexpr int QBYTES = kRows * RS * 2;
  static constexpr int SMEM = QBYTES + WORK;
  static_assert(D % 16 == 0 && D <= 256, "head dim");
};

// The block's place: batch b, kv-head kvh, q-heads h0 .. h0 + gn - 1.
struct Block {
  int b, kvh, h0, gn;
};

__device__ __forceinline__ Block block_of(int hq, int hkv, int rows = kRows) {
  const int cs = (int)cg::this_cluster().num_blocks();
  const int bk = blockIdx.x / cs;
  const int group = hq / hkv;
  Block blk;
  blk.b = bk / hkv;
  blk.kvh = bk % hkv;
  blk.h0 = blk.kvh * group + blockIdx.y * rows;
  blk.gn = min(rows, group - (int)blockIdx.y * rows);
  return blk;
}

// This block's contiguous share [lo, hi) of a row's `len` tokens: the
// cluster's ranks split them in shares rounded up to 16.
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range range_of(int len) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int chunk = ((len + cs - 1) / cs + 15) / 16 * 16;
  Range r;
  r.lo = min(len, (int)cluster.block_rank() * chunk);
  r.hi = min(len, r.lo + chunk);
  return r;
}

// The warps' (m, l, O) states in shared memory, wm / wl [kWarps][rows]
// and wo [kWarps][rows][os] (rows < gn, columns < d, m in base 2), merged
// in warp order into the block's pm / pl [rows] and po [rows][d]; a warp
// with l = 0 weighs 0 (it never forms exp(-inf - -inf)).
__device__ __forceinline__ void merge_warps(const float* wm, const float* wl, const float* wo,
                                            int rows, int os, int d, int gn, float* pm,
                                            float* pl, float* po) {
  for (int i = threadIdx.x; i < gn * d; i += kThreads) {
    const int row = i / d, c = i % d;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * rows + row]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = wl[w * rows + row];
      const float f = lw == 0.f ? 0.f : exp2f(wm[w * rows + row] - mm);
      ll += lw * f;
      oo += wo[(w * rows + row) * os + c] * f;
    }
    po[row * d + c] = oo;
    if (c == 0) {
      pm[row] = mm;
      pl[row] = ll;
    }
  }
}

// The cluster's blocks merge their (pm, pl, po) in rank order through
// distributed shared memory, each finishing every cs-th group of the
// outputs: store(row, c, o / l), 0 for a row with no valid key.  A
// non-null lse[row] gets the row's natural log-sum-exp of its scores
// (m in base 2: ln 2 * (m + log2 l)), -inf for a row with no valid key.
template <class Store>
__device__ __forceinline__ void merge_ranks(float* pm, float* pl, float* po, int d, int gn,
                                            float* lse, Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  for (int i = rank * kThreads + (int)threadIdx.x; i < gn * d; i += cs * kThreads) {
    const int row = i / d, c = i % d;
    // every rank's (m, l, o) read at once, so the remote loads overlap
    float rm[kMaxCluster], rl[kMaxCluster], ro[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < cs) {
        rm[j] = cluster.map_shared_rank(pm, j)[row];
        rl[j] = cluster.map_shared_rank(pl, j)[row];
        ro[j] = cluster.map_shared_rank(po, j)[row * d + c];
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < cs) mm = fmaxf(mm, rm[j]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < cs) {
        const float f = rl[j] == 0.f ? 0.f : exp2f(rm[j] - mm);
        ll += rl[j] * f;
        oo += ro[j] * f;
      }
    }
    store(row, c, ll == 0.f ? 0.f : oo / ll);
    if (lse != nullptr && c == 0)
      lse[row] = ll == 0.f ? __int_as_float(0xff800000) : (mm + log2f(ll)) * 0.69314718055994531f;
  }
  cluster.sync();  // no block leaves while another reads its state
}

// One block's share of the decode: q rows qg + r * q_sh and output rows
// og + r * o_sh (r < gn, D contiguous elements each; a non-null lse[r]
// gets each row's log-sum-exp, merge_ranks), `len` valid tokens
// of `rows` (a Rows type over TKV values: bf16, or int8 with per-token
// fp32 scales).  Launched with kThreads threads, Cfg::SMEM bytes of
// dynamic shared memory and a cluster dimension (split_decode::launch).
template <int D, int RULE, class Rows>
__device__ __forceinline__ void run(const bf16* __restrict__ qg, long long q_sh,
                                    bf16* __restrict__ og, long long o_sh, int gn, int len,
                                    const Rows& rows, float scale, float softcap,
                                    float* lse = nullptr) {
  using C = Cfg<D, RULE>;
  constexpr bool Q8 = C::Q8;
  constexpr int RS = C::RS, CPR = D / 8;  // 16-byte chunks a bf16 row
  typedef typename std::conditional<Q8, int8_t, bf16>::type TKV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                 // kRows x RS
  unsigned char* work = smem_raw + C::QBYTES;                   // stages (+ buffers) / merge
  float* part = reinterpret_cast<float*>(work + C::MERGE);      // m[16], l[16], O[16][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  // this block's tokens: a contiguous share of the row's len
  const Range range = range_of(len);
  const int t_lo = range.lo, t_hi = range.hi;
  const int n_tiles = (t_hi - t_lo + kTile - 1) / kTile;

  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < gn;
    cp_async16(qs + r * RS + c, ok ? qg + r * q_sh + c : qg, ok);
  }
  cp_async_commit();

  auto stage_k = [&](int st) { return work + st * C::STAGE; };
  auto stage_v = [&](int st) { return work + st * C::STAGE + C::TILE; };
  // an int8 tile's per-token scales, K then V
  auto stage_s = [&](int st) { return reinterpret_cast<float*>(work + st * C::STAGE + 2 * C::TILE); };
  // tokens [j0, j0 + kTile) into `st`; those at or past t_hi are
  // zero-filled without a read
  auto load_kv = [&](int st, int j0) {
    constexpr int CH = Q8 ? D / 16 : CPR;  // 16-byte chunks a row
    unsigned char* kd = stage_k(st);
    unsigned char* vd = stage_v(st);
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 16 / (int)sizeof(TKV);
      const bool ok = j0 + r < t_hi;
      const long long off = ok ? rows.kv(j0 + r) + c : 0;
      cp_async16(kd + r * C::ROW_BYTES + c * sizeof(TKV), rows.k + off, ok);
      cp_async16(vd + r * C::ROW_BYTES + c * sizeof(TKV), rows.v + off, ok);
    }
    if constexpr (Q8) {
      if (tid < 2 * kTile) {
        const int r = tid % kTile;
        const bool ok = j0 + r < t_hi;
        const float* src = tid < kTile ? rows.ks : rows.vs;
        cp_async4(stage_s(st) + tid, ok ? src + rows.sc(j0 + r) : src, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, t_lo + st * kTile);
    cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  uint32_t qf[C::QREGS ? C::KT : 1][4];
  float o[C::DT][4];
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  // ldmatrix lane addressing: A (Q) fragments, B (K) fragments of two n8
  // tiles, B (V, transposed) fragments of two n8 tiles
  const int a_row = (lane / 8 % 2) * 8 + lane % 8, a_col = lane / 16 * 8;
  const int k_row = lane / 16 * 8 + lane % 8, k_col = lane / 8 % 2 * 8;
  const int v_row = lane / 8 % 2 * 8 + lane % 8, v_col = lane / 16 * 8;
  bf16* wk = reinterpret_cast<bf16*>(work + kStages * C::STAGE) + warp * 2 * 16 * RS;
  bf16* wv = wk + 16 * RS;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = t_lo + it * kTile;
    // Q and tile `it` have landed, and every warp is done with tile it - 1,
    // whose stage the next load refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      load_kv((it + kStages - 1) % kStages, j0 + (kStages - 1) * kTile);
    cp_async_commit();
    if constexpr (C::QREGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::KT; ++kk) ldmatrix_x4(qf[kk], qs + a_row * RS + kk * 16 + a_col);
      }
    }
    const int w0 = j0 + warp * 16;  // the warp's first token
    if (w0 >= t_hi) continue;
    const int st = it % kStages;
    const bf16* kt;
    const bf16* vt;
    const float* ksc = nullptr;  // kInt8Fp32: the warp's tokens' scales
    const float* vsc = nullptr;
    if constexpr (Q8) {
      // widen the warp's 16 rows (zeros past t_hi, whose scales are zero):
      // to bf16(bf16(k) * bf16(scale)) under kInt8Bf16, exactly under
      // kInt8Fp32
      const int8_t* ki = reinterpret_cast<const int8_t*>(stage_k(st)) + warp * 16 * D;
      const int8_t* vi = reinterpret_cast<const int8_t*>(stage_v(st)) + warp * 16 * D;
      const float* sc = stage_s(st) + warp * 16;
      for (int i = lane; i < 16 * D / 16; i += 32) {
        const int r = i / (D / 16), c = (i % (D / 16)) * 16;
        const float ks = RULE == kInt8Bf16 ? bf16r(sc[r]) : 1.f;
        const float vs = RULE == kInt8Bf16 ? bf16r(sc[kTile + r]) : 1.f;
        const uint4 kw = *reinterpret_cast<const uint4*>(ki + r * D + c);
        const uint4 vw = *reinterpret_cast<const uint4*>(vi + r * D + c);
        const uint32_t kq[4] = {kw.x, kw.y, kw.z, kw.w}, vq[4] = {vw.x, vw.y, vw.z, vw.w};
        uint32_t kp[8], vp[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float kf[4], vf[4];
          i8x4_to_f32(kq[e], kf);
          i8x4_to_f32(vq[e], vf);
          kp[2 * e] = pack_bf16(kf[0] * ks, kf[1] * ks);
          kp[2 * e + 1] = pack_bf16(kf[2] * ks, kf[3] * ks);
          vp[2 * e] = pack_bf16(vf[0] * vs, vf[1] * vs);
          vp[2 * e + 1] = pack_bf16(vf[2] * vs, vf[3] * vs);
        }
        *reinterpret_cast<uint4*>(wk + r * RS + c) = make_uint4(kp[0], kp[1], kp[2], kp[3]);
        *reinterpret_cast<uint4*>(wk + r * RS + c + 8) = make_uint4(kp[4], kp[5], kp[6], kp[7]);
        *reinterpret_cast<uint4*>(wv + r * RS + c) = make_uint4(vp[0], vp[1], vp[2], vp[3]);
        *reinterpret_cast<uint4*>(wv + r * RS + c + 8) = make_uint4(vp[4], vp[5], vp[6], vp[7]);
      }
      __syncwarp();
      kt = wk;
      vt = wv;
      if constexpr (RULE == kInt8Fp32) {
        ksc = sc;
        vsc = sc + kTile;
      }
    } else {
      kt = reinterpret_cast<const bf16*>(stage_k(st)) + warp * 16 * RS;
      vt = reinterpret_cast<const bf16*>(stage_v(st)) + warp * 16 * RS;
    }

    // S (q-heads x the warp's 16 tokens) = Q K^T
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KT; ++kk) {
      uint32_t a[4];
      if constexpr (C::QREGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qs + a_row * RS + kk * 16 + a_col);
      }
      uint32_t bk[4];
      ldmatrix_x4(bk, kt + k_row * RS + kk * 16 + k_col);
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }

    // K's scale (kInt8Fp32), scale, softcap and mask in fp32, in base 2;
    // the tile's row max
    const bool edge = w0 + 16 > t_hi;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * tig + (e & 1);  // of the warp's 16
        float raw = s[j][e];
        if constexpr (RULE == kInt8Fp32) raw *= ksc[key];
        float x = raw * scale_log2;
        if (softcap > 0.f) x = softcap * tanhf(raw * scale / softcap) * kLog2e;
        if (edge && w0 + key >= t_hi) x = kNegInf;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < C::DT; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // p (fp32 into l; into the PV A fragments rounded to bf16, or times
    // V's scale as hi and lo bf16 terms), then O += P V
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
        l[e / 2] += pe;
        p[j][e] = pe;
        if constexpr (RULE == kInt8Fp32) p[j][e] = pe * vsc[j * 8 + 2 * tig + (e & 1)];
      }
    uint32_t pa[4], pl[4];
    if constexpr (RULE == kInt8Fp32) {
      split_bf16(p[0][0], p[0][1], pa[0], pl[0]);
      split_bf16(p[0][2], p[0][3], pa[1], pl[1]);
      split_bf16(p[1][0], p[1][1], pa[2], pl[2]);
      split_bf16(p[1][2], p[1][3], pa[3], pl[3]);
    } else {
      pa[0] = pack_bf16(p[0][0], p[0][1]);
      pa[1] = pack_bf16(p[0][2], p[0][3]);
      pa[2] = pack_bf16(p[1][0], p[1][1]);
      pa[3] = pack_bf16(p[1][2], p[1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < C::DT / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + v_row * RS + dp * 16 + v_col);
      mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      if constexpr (RULE == kInt8Fp32) {
        mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    if constexpr (Q8) __syncwarp();  // the buffer is refilled next tile
  }

  // the warps' states (rows < gn) into shared memory, merged in warp order
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  float* wm = reinterpret_cast<float*>(work);  // [warps][16]
  float* wl = wm + kWarps * kRows;             // [warps][16]
  float* wo = wl + kWarps * kRows;             // [warps][16][OS]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = g + 8 * r;
    if (row >= gn) continue;
    if (tig == 0) {
      wm[warp * kRows + row] = m[r];
      wl[warp * kRows + row] = l[r];
    }
    float* orow = wo + (warp * kRows + row) * C::OS + 2 * tig;
#pragma unroll
    for (int j = 0; j < C::DT; ++j) {
      orow[j * 8] = o[j][2 * r];
      orow[j * 8 + 1] = o[j][2 * r + 1];
    }
  }
  __syncthreads();
  float* pm = part;                // [16]
  float* pls = part + kRows;       // [16]
  float* po = part + 2 * kRows;    // [16][D]
  merge_warps(wm, wl, wo, kRows, C::OS, D, gn, pm, pls, po);
  merge_ranks(pm, pls, po, D, gn, lse,
              [&](int row, int c, float v) { og[row * o_sh + c] = __float2bfloat16(v); });
}

// Launches `kernel` with one cluster of 1-8 blocks of kThreads threads and
// `smem` bytes per (batch, kv-head, group of up to `rows` q-heads): as
// many as give the grid about kBlocksPerSm blocks an SM, and no more than
// `t_max` keys fill a tile of `tile` keys each.  Returns a cudaError_t.
template <typename... P, typename... A>
int launch_clusters(void (*kernel)(P...), std::atomic<int> (&sms)[kMaxDevices], int smem,
                    int rows, int tile, int b, int hq, int hkv, int t_max,
                    cudaStream_t stream, A... args) {
  int sm_count = 0;
  const int err = kernel_setup(kernel, smem, sms, sm_count);
  if (err) return err;
  const int groups = (hq / hkv + rows - 1) / rows;
  const int clusters = b * hkv * groups;
  const int want = (kBlocksPerSm * sm_count + clusters - 1) / clusters;
  const int most = max(1, (t_max + tile - 1) / tile);  // a tile a block at least
  const int cs = max(1, min(kMaxCluster, min(want, most)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * hkv * cs, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// run<D, RULE>'s launch: a cluster per (batch, kv-head, group of kRows).
template <int D, int RULE, typename... P, typename... A>
int launch(void (*kernel)(P...), std::atomic<int> (&sms)[kMaxDevices], int b, int hq, int hkv,
           int t_max, cudaStream_t stream, A... args) {
  return launch_clusters(kernel, sms, Cfg<D, RULE>::SMEM, kRows, kTile, b, hq, hkv, t_max,
                         stream, args...);
}

}  // namespace split_decode
