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
// What bounds it on the H100: the operations, 4 * D FLOPs per unmasked
//   (query, key) pair, against 2 * D elements of K/V a key read once; a
//   chunk of S rows reuses each key S times, so above a few dozen rows the
//   kernel is far above the memory ridge.  Cell 3's chunks (32 rows or
//   fewer over at most 71 keys, one q-head a block) are a few hundred
//   nanoseconds of work each: there the launch and the first loads set the
//   time, so both kernels walk the keys in few, wide tiles.
//
// Both kernels: one block per (batch, group of q-heads that share a
//   kv-head, query tile).  A block's rows are `hb` q-heads x (rows / hb)
//   positions, hb the largest of 4, 2, 1 that divides the GQA group, so a
//   page of K/V is loaded once for the heads that read it.  The block reads
//   each page's block-table entry itself; a page of one kv-head is one
//   contiguous ps x D run.  K/V tiles of 32 keys go through a two-stage
//   cp.async ring in shared memory (one barrier a tile; over int8 pages a
//   second one after the tile is widened).  The walk covers only the
//   block's key range: it ends at the tile's last valid row (never at a
//   padded row), pages above the last diagonal are never loaded, and keys
//   past it are staged as zeros without being read (cp.async with src-size
//   0), so NaN or the trash page never reaches a valid row.  With a window,
//   tiles wholly before the first row's window are skipped too.  Masked
//   (query, key) pairs get p = 0 exactly (a select, not exp(-inf)); l sums
//   the unrounded p.  Ragged S is masked in the kernel, nothing is padded.
//   The query tiles run heaviest first.  No atomics: two calls give the
//   same bits.
//
// bf16 q (bf16 or int8 pages): the tensor cores, as the bf16 flash kernel
//   (csrc/flash_attention.cu): mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), four warps of 16 query rows with Q fragments in registers
//   (D <= 128), K by ldmatrix and V by ldmatrix.trans from rows padded by 16
//   bytes.  S and P stay in the accumulator layout; scores are scaled in
//   fp32 after the product (q is not pre-scaled into bf16) and taken in base
//   2.  Over bf16 pages p is rounded to bf16 into the PV fragments, as the
//   Pallas kernel rounds it to the value dtype.  Over int8 pages the tile is
//   widened in shared memory to int8-valued bf16 (exact), and the semantics
//   are the Pallas kernel's fp32 dequantization with p not rounded: K's
//   scale multiplies the score column in fp32, and V's is folded into p,
//   whose product p * scale_v is split into two bf16 terms (hi, and the
//   remainder lo) fed to two mma, so it keeps 16 significant bits.  Head
//   dims a multiple of 16 up to 256; every row is 16-byte aligned.
//
// fp32 q (fp32 or int8 pages): the CUDA cores, no TF32 (the plain
//   version's limit allows fp32 reordering only).  A block of 128 threads
//   owns 32 rows.  Thread (tr, tk) = (tid / 16, tid % 16) owns rows tr + 8i
//   (i < 4) throughout: in Q K^T the keys tk + 16j (j < 2) of each 32-key
//   tile, a 4 x 2 register patch summed over D by float4 reads (Q rows are a
//   broadcast within the half-warp, K rows padded so the 16 lanes hit
//   distinct banks); in P V the columns tk * 4 + 64c, a 4 x D/16 patch of
//   the output.  The row max and sum are reduced over the 16 lanes of the
//   half-warp with shuffles, and P goes through shared memory to the same
//   16 lanes, so it needs a __syncwarp and no barrier (the step over a tile
//   is csrc/f32_attention.h, shared with flash attention's fp32 route).
//   int8 pages are
//   widened and scaled in fp32 as they leave the ring (k * scale, as the
//   plain version dequantizes).  D a multiple of 4 up to 256 (of 16 over
//   int8 pages), computed at a padded width of 64, 128 or 256 with zeros
//   staged past D.

#include "device_helpers.h"
#include "f32_attention.h"
#include "launch_args.h"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // four warps, either kernel
constexpr int kKeys = 32;     // keys a tile
constexpr int kStages = 2;    // tiles in the ring

struct Args {
  const void* q;              // (B, Hq, S, D)
  const void* k_pages;        // (P, Hkv, ps, D)
  const void* v_pages;
  const float* k_scale;       // (P, Hkv, ps), int8 pages only
  const float* v_scale;
  const int32_t* block_tables;  // (B, nb)
  const int32_t* kv_offset;   // (B,)
  void* out;                  // (B, Hq, S, D)
  int hq, hkv, s_len, ps, d, nb, hb;
  float scale, softcap;
  int window;
};

// The rows a block owns: `rows` = hb q-heads x `pos` positions.  Row r is
// q-head h0 + r / pos at chunk position q0 + r % pos.
struct Tile {
  int b, h0, kvh, q0, pos;
  int off;                    // kv_offset[b]
  int k_lo, k_hi;             // keys [k_lo, k_hi) some valid row can see
  int n_tiles;
};

__device__ __forceinline__ Tile block_tile(const Args& a, int rows) {
  Tile t;
  const int groups = a.hq / a.hb;
  t.b = blockIdx.x / groups;
  t.h0 = (blockIdx.x % groups) * a.hb;
  t.kvh = t.h0 / (a.hq / a.hkv);
  t.pos = rows / a.hb;
  t.q0 = (gridDim.y - 1 - blockIdx.y) * t.pos;  // heaviest first
  t.off = a.kv_offset[t.b];
  const int last = t.off + min(t.q0 + t.pos, a.s_len) - 1;  // the last valid row's diagonal
  t.k_hi = min(last + 1, a.nb * a.ps);
  int lo = a.window > 0 ? max(0, t.off + t.q0 - a.window + 1) : 0;
  t.k_lo = (lo / kKeys) * kKeys;
  t.n_tiles = t.k_hi > t.k_lo ? (t.k_hi - t.k_lo + kKeys - 1) / kKeys : 0;
  return t;
}

// Element offset of key `kpos`'s row (of this tile's kv-head) in the pages.
__device__ __forceinline__ size_t page_row(const Args& a, const Tile& t, int kpos) {
  const int j = kpos / a.ps;
  const int page = a.block_tables[(size_t)t.b * a.nb + j];
  return (((size_t)page * a.hkv + t.kvh) * a.ps + (kpos - j * a.ps)) * a.d;
}

// One tile of K and V, keys [j0, j0 + 32), into `kd` / `vd` (rows of `rs`
// elements): 16-byte chunks by cp.async, zero-filled without a read at
// keys >= k_hi and at columns >= D (up to `width`).  Over int8 pages, the
// tile's scales too.
template <typename T>
__device__ __forceinline__ void load_kv(const Args& a, const Tile& t, int j0, T* kd, T* vd,
                                        int rs, int width, float* ksc, float* vsc) {
  constexpr int E = 16 / sizeof(T);           // elements a chunk
  const int cpr = width / E;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  for (int i = threadIdx.x; i < kKeys * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * E;
    const int kpos = j0 + r;
    const bool ok = kpos < t.k_hi && c < a.d;
    const size_t src = ok ? page_row(a, t, kpos) + c : 0;
    cp_async16(kd + r * rs + c, kp + src, ok);
    cp_async16(vd + r * rs + c, vp + src, ok);
  }
  if (ksc != nullptr && (int)threadIdx.x < kKeys) {
    const int kpos = j0 + threadIdx.x;
    const bool ok = kpos < t.k_hi;
    const size_t src = ok ? page_row(a, t, kpos) / a.d : 0;
    cp_async4(ksc + threadIdx.x, a.k_scale + src, ok);
    cp_async4(vsc + threadIdx.x, a.v_scale + src, ok);
  }
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;  // 16 a warp

template <int D, bool Q8>
struct TcCfg {
  static constexpr int RS = D + 8;         // padded bf16 row (elements)
  static constexpr int KT = D / 16;        // k-steps of Q K^T
  static constexpr int NT = kKeys / 8;     // n8 tiles of S
  static constexpr int DT = D / 8;         // n8 tiles of O
  static constexpr bool QREGS = D <= 128;  // Q fragments in registers
  static constexpr int MIN_BLOCKS = D == 128 ? 3 : 1;
  static constexpr int Q_BYTES = kTcRows * RS * 2;
  static constexpr int TILE = kKeys * RS;  // one bf16 K or V tile (elements)
  static constexpr int RAW = kKeys * D;    // one int8 K or V tile (bytes)
  // Q; bf16 pages: the ring of K/V tiles; int8 pages: the ring of raw
  // tiles and their scales, and one widened K/V tile
  static constexpr int SMEM =
      Q_BYTES + (Q8 ? kStages * (2 * RAW + 2 * kKeys * 4) + 2 * TILE * 2
                    : kStages * 2 * TILE * 2);
  static_assert(D % 16 == 0 && D <= 256, "head dim");
};

template <int D, bool Q8>
__global__ void __launch_bounds__(kThreads, TcCfg<D, Q8>::MIN_BLOCKS)
paged_tc_kernel(Args a) {
  using C = TcCfg<D, Q8>;
  constexpr int RS = C::RS, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // kTcRows x RS
  unsigned char* ring = smem_raw + C::Q_BYTES;
  // bf16 pages: stage s holds K at ring + s * 2 TILE, V after it.
  // int8 pages: stage s holds raw K, raw V, K scales, V scales; the widened
  // tile follows the ring.
  constexpr int STAGE_BYTES = Q8 ? 2 * C::RAW + 2 * kKeys * 4 : 2 * C::TILE * 2;
  bf16* wide = reinterpret_cast<bf16*>(ring + kStages * STAGE_BYTES);

  const Tile t = block_tile(a, kTcRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q);

  for (int i = tid; i < kTcRows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int p = t.q0 + r % t.pos;
    const bool ok = p < a.s_len;
    const size_t src = ok ? (((size_t)t.b * a.hq + t.h0 + r / t.pos) * a.s_len + p) * D + c : 0;
    cp_async16(qs + r * RS + c, q + src, ok);
  }
  cp_async_commit();

  auto stage_load = [&](int st, int j0) {
    unsigned char* base = ring + st * STAGE_BYTES;
    if constexpr (Q8) {
      int8_t* kd = reinterpret_cast<int8_t*>(base);
      float* sc = reinterpret_cast<float*>(base + 2 * C::RAW);
      load_kv<int8_t>(a, t, j0, kd, kd + C::RAW, D, D, sc, sc + kKeys);
    } else {
      bf16* kd = reinterpret_cast<bf16*>(base);
      load_kv<bf16>(a, t, j0, kd, kd + C::TILE, RS, D, nullptr, nullptr);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < t.n_tiles) stage_load(st, t.k_lo + st * kKeys);
    cp_async_commit();
  }

  const float scale_log2 = a.scale * kLog2e;
  // this warp's 16 rows: one q-head, positions wp .. wp + 15 of the chunk
  const int wrow = warp * 16;
  const int wp = t.q0 + wrow % t.pos;
  const int head = t.h0 + wrow / t.pos;
  const int qabs[2] = {t.off + wp + g, t.off + wp + g + 8};  // this thread's rows
  uint32_t qf[C::QREGS ? C::KT : 1][4];
  float o[C::DT][4];
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  const int a_row = wrow + (lane / 8 % 2) * 8 + lane % 8, a_col = lane / 16 * 8;
  const int k_row = lane / 16 * 8 + lane % 8, k_col = lane / 8 % 2 * 8;
  const int v_row = lane / 8 % 2 * 8 + lane % 8, v_col = lane / 16 * 8;

  for (int it = 0; it < t.n_tiles; ++it) {
    const int j0 = t.k_lo + it * kKeys;
    // Q and tile `it` have landed, and every warp is done with tile it - 1
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < t.n_tiles)
      stage_load((it + kStages - 1) % kStages, j0 + (kStages - 1) * kKeys);
    cp_async_commit();
    const unsigned char* cur = ring + (it % kStages) * STAGE_BYTES;
    const bf16* kt;
    const bf16* vt;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (Q8) {
      // widen the raw tile to int8-valued bf16 (exact) for ldmatrix
      for (int i = tid; i < 2 * kKeys * D / 16; i += kThreads) {
        const int r = i / (D / 16), c = (i % (D / 16)) * 16;  // r: K rows, then V rows
        const uint4 w = *reinterpret_cast<const uint4*>(cur + r * D + c);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t packed[8];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float f[4];
          i8x4_to_f32(ws[h], f);
          packed[2 * h] = pack_bf16(f[0], f[1]);
          packed[2 * h + 1] = pack_bf16(f[2], f[3]);
        }
        uint4* dst = reinterpret_cast<uint4*>(wide + r * RS + c);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncthreads();
      kt = wide;
      vt = wide + C::TILE;
      ksc = reinterpret_cast<const float*>(cur + 2 * C::RAW);
      vsc = ksc + kKeys;
    } else {
      kt = reinterpret_cast<const bf16*>(cur);
      vt = kt + C::TILE;
    }
    if constexpr (C::QREGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::KT; ++kk) ldmatrix_x4(qf[kk], qs + a_row * RS + kk * 16 + a_col);
      }
    }
    // does any (row, key) pair of this warp and tile survive the masks?
    const int wlast = t.off + wp + 15, wfirst = t.off + wp;
    const bool live = j0 <= wlast && (a.window <= 0 || j0 + kKeys - 1 > wfirst - a.window);
    if (!live) continue;

    float s[C::NT][4];
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KT; ++kk) {
      uint32_t af[4];
      if constexpr (C::QREGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
      } else {
        ldmatrix_x4(af, qs + a_row * RS + kk * 16 + a_col);
      }
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (np * 16 + k_row) * RS + kk * 16 + k_col);
        mma_bf16(s[2 * np], af, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], af, bk[2], bk[3]);
      }
    }

    // scale (and K's int8 scale), softcap and mask in fp32, in base 2
    const bool edge = j0 + kKeys - 1 > wfirst || (a.window > 0 && j0 <= wlast - a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * tig + (e & 1);
        float raw = s[j][e];
        if constexpr (Q8) raw *= ksc[key];
        float x = raw * scale_log2;
        if (a.softcap > 0.f) x = a.softcap * tanhf(raw * a.scale / a.softcap) * kLog2e;
        if (edge) {
          const int kpos = j0 + key, qpos = qabs[e / 2];
          bool ok = kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          x = ok ? x : kNegInf;
        }
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

    // p (fp32 into l), then O += P V
#pragma unroll
    for (int u = 0; u < kKeys / 16; ++u) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[2 * u + jj][e];
          const float pe = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
          l[e / 2] += pe;
          p[jj][e] = pe;
          if constexpr (Q8) p[jj][e] = pe * vsc[u * 16 + jj * 8 + 2 * tig + (e & 1)];
        }
      uint32_t pa[4], pl[4];
      if constexpr (Q8) {
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
        ldmatrix_x4_trans(bv, vt + (u * 16 + v_row) * RS + dp * 16 + v_col);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
        if constexpr (Q8) {
          mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int p = wp + g + 8 * r;
    if (p >= a.s_len) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = out + (((size_t)t.b * a.hq + head) * a.s_len + p) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// fp32 q: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFRows = 32;
static_assert(kKeys == kF32Keys, "f32_attention_tile walks tiles of kKeys");

template <int DP, bool Q8>
struct F32Cfg {
  static constexpr int RS = DP + 4;        // padded fp32 row (floats)
  static constexpr int CG = DP / 64;       // float4 column groups of P V
  static constexpr int TILE = kKeys * RS;  // one fp32 K or V tile (floats)
  static constexpr int RAW = kKeys * DP;   // one int8 K or V tile (bytes)
  static constexpr int Q_BYTES = kFRows * RS * 4;
  static constexpr int P_BYTES = kKeys * kF32PS * 4;
  // Q, P; fp32 pages: the ring of K/V tiles; int8 pages: the ring of raw
  // tiles and their scales, and one widened K/V tile
  static constexpr int STAGE_BYTES = Q8 ? 2 * RAW + 2 * kKeys * 4 : 2 * TILE * 4;
  static constexpr int SMEM = Q_BYTES + P_BYTES + kStages * STAGE_BYTES + (Q8 ? 2 * TILE * 4 : 0);
  static constexpr int MIN_BLOCKS = DP <= 128 ? 2 : 1;
  static_assert(DP % 64 == 0 && DP <= 256, "padded head dim");
};

template <int DP, bool Q8>
__global__ void __launch_bounds__(kThreads, F32Cfg<DP, Q8>::MIN_BLOCKS)
paged_f32_kernel(Args a) {
  using C = F32Cfg<DP, Q8>;
  constexpr int RS = C::RS, CPR = DP / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                   // kFRows x RS
  float* ps = reinterpret_cast<float*>(smem_raw + C::Q_BYTES);      // kKeys x kF32PS
  unsigned char* ring = smem_raw + C::Q_BYTES + C::P_BYTES;
  float* wide = reinterpret_cast<float*>(ring + kStages * C::STAGE_BYTES);

  const Tile t = block_tile(a, kFRows);
  const int tid = threadIdx.x, tr = tid / 16, tk = tid % 16;
  const float* q = static_cast<const float*>(a.q);
  const int d = a.d;

  for (int i = tid; i < kFRows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const int p = t.q0 + r % t.pos;
    const bool ok = p < a.s_len && c < d;
    const size_t src = ok ? (((size_t)t.b * a.hq + t.h0 + r / t.pos) * a.s_len + p) * d + c : 0;
    cp_async16(qs + r * RS + c, q + src, ok);
  }
  cp_async_commit();

  auto stage_load = [&](int st, int j0) {
    unsigned char* base = ring + st * C::STAGE_BYTES;
    if constexpr (Q8) {
      int8_t* kd = reinterpret_cast<int8_t*>(base);
      float* sc = reinterpret_cast<float*>(base + 2 * C::RAW);
      load_kv<int8_t>(a, t, j0, kd, kd + C::RAW, DP, DP, sc, sc + kKeys);
    } else {
      float* kd = reinterpret_cast<float*>(base);
      load_kv<float>(a, t, j0, kd, kd + C::TILE, RS, DP, nullptr, nullptr);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < t.n_tiles) stage_load(st, t.k_lo + st * kKeys);
    cp_async_commit();
  }

  int qabs[4];  // this thread's rows tr + 8i, as kv positions
#pragma unroll
  for (int i = 0; i < 4; ++i) qabs[i] = t.off + t.q0 + (tr + 8 * i) % t.pos;
  float o[4][4 * C::CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * C::CG; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int it = 0; it < t.n_tiles; ++it) {
    const int j0 = t.k_lo + it * kKeys;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every thread is done with it - 1
    if (it + kStages - 1 < t.n_tiles)
      stage_load((it + kStages - 1) % kStages, j0 + (kStages - 1) * kKeys);
    cp_async_commit();
    const unsigned char* cur = ring + (it % kStages) * C::STAGE_BYTES;
    const float* kt;
    const float* vt;
    if constexpr (Q8) {
      // widen and scale in fp32, k * scale as the plain version dequantizes
      const float* sc = reinterpret_cast<const float*>(cur + 2 * C::RAW);
      for (int i = tid; i < 2 * kKeys * DP / 16; i += kThreads) {
        const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;  // K rows, then V rows
        const uint4 w = *reinterpret_cast<const uint4*>(cur + r * DP + c);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        const float f_sc = sc[r];
        float4* dst = reinterpret_cast<float4*>(wide + r * RS + c);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float f[4];
          i8x4_to_f32(ws[h], f);
          dst[h] = make_float4(f[0] * f_sc, f[1] * f_sc, f[2] * f_sc, f[3] * f_sc);
        }
      }
      __syncthreads();
      kt = wide;
      vt = wide + C::TILE;
    } else {
      kt = reinterpret_cast<const float*>(cur);
      vt = kt + C::TILE;
    }

    f32_attention_tile<DP>(qs, kt, vt, ps, j0, tr, tk, a.scale, a.softcap,
                           [&](int i, int kpos) {
                             bool ok = kpos <= qabs[i];
                             if (a.window > 0) ok = ok && kpos > qabs[i] - a.window;
                             return ok;
                           },
                           o, m, l);
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 8 * i;
    const int p = t.q0 + r % t.pos;
    if (p >= a.s_len) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + (((size_t)t.b * a.hq + t.h0 + r / t.pos) * a.s_len + p) * d;
#pragma unroll
    for (int cg = 0; cg < C::CG; ++cg) {
      const int c = cg * 64 + tk * 4;
      if (c < d)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(o[i][4 * cg] / denom, o[i][4 * cg + 1] / denom,
                        o[i][4 * cg + 2] / denom, o[i][4 * cg + 3] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int smem, std::atomic<int> (&sms)[kMaxDevices], const Args& a,
           int b, int rows, cudaStream_t stream) {
  int sm_count = 0;
  const int err = kernel_setup(kernel, smem, sms, sm_count);
  if (err) return err;
  const int pos = rows / a.hb;
  const dim3 grid(b * (a.hq / a.hb), (a.s_len + pos - 1) / pos);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool Q8>
int launch_tc(const Args& a, int b, cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  return launch(paged_tc_kernel<D, Q8>, TcCfg<D, Q8>::SMEM, sms, a, b, kTcRows, stream);
}

template <int DP, bool Q8>
int launch_f32(const Args& a, int b, cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  return launch(paged_f32_kernel<DP, Q8>, F32Cfg<DP, Q8>::SMEM, sms, a, b, kFRows, stream);
}

template <bool Q8>
int dispatch_tc(const Args& a, int b, cudaStream_t s) {
#define PREFILL_TC(D) \
  case D:               \
    return launch_tc<D, Q8>(a, b, s);
  switch (a.d) {
    BF16_ATTENTION_HEAD_DIMS(PREFILL_TC)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PREFILL_TC
}

template <bool Q8>
int dispatch_f32(const Args& a, int b, cudaStream_t s) {
  if (a.d % 4 || a.d > 256 || (Q8 && a.d % 16)) return (int)cudaErrorInvalidValue;
  if (a.d <= 64) return launch_f32<64, Q8>(a, b, s);
  if (a.d <= 128) return launch_f32<128, Q8>(a, b, s);
  return launch_f32<256, Q8>(a, b, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pages only, with scales).
// q and out share q_dtype; fp32 and bf16 pages go with a q of their dtype.
// One kernel per q dtype: bf16 takes D a multiple of 16 up to 256, fp32 D a
// multiple of 4 up to 256 (of 16 over int8 pages); q, the pages and out
// 16-byte aligned.  Anything else returns cudaErrorInvalidValue.
static int paged_prefill_attention_impl(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_offset, void* out, int q_dtype, int kv_dtype, int b,
    int hq, int hkv, int s_len, int ps, int d, int nb, float scale,
    float softcap, int window, void* stream) {
  if (hkv <= 0 || hq % hkv || ps <= 0 || nb <= 0 || b <= 0 || s_len <= 0 ||
      !aligned16(q) || !aligned16(k_pages) || !aligned16(v_pages) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const bool q8 = kv_dtype == 2;
  if (q8 ? (k_scale == nullptr || v_scale == nullptr) : kv_dtype != q_dtype)
    return (int)cudaErrorInvalidValue;
  const int group = hq / hkv;
  const int hb = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int32_t*>(block_tables),
               static_cast<const int32_t*>(kv_offset), out, hq, hkv, s_len, ps, d, nb, hb,
               scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1) return q8 ? dispatch_tc<true>(a, b, s) : dispatch_tc<false>(a, b, s);
  if (q_dtype == 0) return q8 ? dispatch_f32<true>(a, b, s) : dispatch_f32<false>(a, b, s);
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int paged_prefill_attention(const long long* args) {
  return call_packed(paged_prefill_attention_impl, args);
}
