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
// bf16 q (bf16 or int8 pages; head dims in multiples of 16 up to 256, 16-byte aligned
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
// fp32 q (fp32 or int8 pages; head dims in multiples of 4, of 16 over int8
//   pages, up to 256, 16-byte aligned q and pages, refused otherwise): the
//   same cluster layout on the CUDA cores, all in fp32 without TF32 (the
//   fp32 limits reject TF32 scores).  One cluster per (batch, kv-head,
//   group of up to 8 q-heads); its blocks take contiguous key ranges,
//   gathered in 32-key tiles through the block table by 16-byte cp.async
//   (four threads a row, one table lookup each) into a ring of three
//   stages (four over int8 pages), and merge in rank order through
//   distributed shared memory (split_decode.h's merges and launch).  Each
//   warp takes 8 keys of a tile: four lanes a key sum q . k over
//   interleaved float4 columns and meet by shuffles, so a K row is read
//   once for the group's q rows; the online softmax runs in base 2 per
//   tile; then each lane owns four columns of O (eight past D 128) and
//   adds p V over the warp's keys.  Over int8 pages each value is widened
//   exactly, K's scale multiplies the score and V's scale p, in fp32.

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
// fp32 q: split-KV over a cluster, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 32;                                 // keys a tile
constexpr int kWarpKeys = kF32Tile / split_decode::kWarps;   // 8 a warp
constexpr int kParts = 32 / kWarpKeys;                       // lanes a key's dot product

// GR: q-heads a block (1, 2, 4 or 8); CG: float4 columns a lane of O (head
// dims up to 128 * CG); Q8: int8 pages with per-token fp32 scales.
template <int GR, int CG, bool Q8>
struct F32Cfg {
  static constexpr int DP = 128 * CG;                        // the widest head dim
  static constexpr int STAGES = Q8 ? 4 : 3;
  static constexpr int ROW = Q8 ? DP + 16 : 4 * (DP + 4);    // bytes a staged K or V row
  static constexpr int TILE = kF32Tile * ROW;
  static constexpr int STAGE = 2 * TILE + (Q8 ? 2 * kF32Tile * 4 : 0);  // K, V (and scales)
  static constexpr int QBYTES = GR * DP * 4;
  static constexpr int MERGE = split_decode::kWarps * GR * (DP + 2) * 4;  // warps' (m, l, O)
  static constexpr int PART = (GR * DP + 2 * GR) * 4;                     // the block's
  static constexpr int WORK = STAGES * STAGE > MERGE + PART ? STAGES * STAGE : MERGE + PART;
  static constexpr int SMEM = QBYTES + WORK;
};

// One cluster per (batch, kv-head, group of GR q-heads).  A warp takes 8
// keys of each 32-key tile: lane (key k, part p) sums q . K over the
// columns 4 (p + 4 i), the four parts meet by shuffles; the online softmax
// in base 2 per tile; then each lane owns the columns 4 lane + 128 c of O
// and adds p V over the warp's keys, p broadcast by shuffles.
template <int GR, int CG, bool Q8>
__global__ void __launch_bounds__(split_decode::kThreads)
paged_f32_kernel(const float* __restrict__ q, const void* __restrict__ k_pages,
                 const void* __restrict__ v_pages, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int32_t* __restrict__ block_tables,
                 const int32_t* __restrict__ kv_len, float* __restrict__ out, int hq, int hkv,
                 int ps, int d, int nb, float scale, float softcap) {
  using C = F32Cfg<GR, CG, Q8>;
  using split_decode::kNegInf;
  using split_decode::kLog2e;
  using split_decode::kThreads;
  using split_decode::kWarps;
  typedef typename std::conditional<Q8, int8_t, float>::type TKV;
  constexpr int DP = C::DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // GR x DP
  unsigned char* work = smem_raw + C::QBYTES;       // stages / merge

  const split_decode::Block blk = split_decode::block_of(hq, hkv, GR);
  const PagedRows<TKV> rows{static_cast<const TKV*>(k_pages), static_cast<const TKV*>(v_pages),
                            k_scale, v_scale, block_tables + (long long)blk.b * nb, hkv,
                            blk.kvh, ps, d};
  const split_decode::Range range = split_decode::range_of(max(0, min(kv_len[blk.b], nb * ps)));
  const int t_lo = range.lo, t_hi = range.hi;
  const int n_tiles = (t_hi - t_lo + kF32Tile - 1) / kF32Tile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qg = q + ((long long)blk.b * hq + blk.h0) * d;

  for (int i = tid; i < GR * (d / 4); i += kThreads) {
    const int r = i / (d / 4), c = (i % (d / 4)) * 4;
    const bool ok = r < blk.gn;
    cp_async16(qs + r * DP + c, ok ? qg + r * d + c : qg, ok);
  }
  cp_async_commit();

  auto stage_k = [&](int st) { return work + st * C::STAGE; };
  auto stage_v = [&](int st) { return work + st * C::STAGE + C::TILE; };
  auto stage_s = [&](int st) { return reinterpret_cast<float*>(work + st * C::STAGE + 2 * C::TILE); };
  // tokens [j0, j0 + kF32Tile) into `st`, four threads a row (one
  // block-table lookup each), 16 bytes a copy; those at or past t_hi are
  // zero-filled without a read
  static_assert(kF32Tile * 4 == kThreads, "four threads a row");
  const int row_bytes = d * (int)sizeof(TKV);
  auto load_kv = [&](int st, int j0) {
    const int r = tid / 4;
    const bool ok = j0 + r < t_hi;
    const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(rows.k);
    const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(rows.v);
    if (ok) {
      const long long off = rows.kv(j0 + r) * (long long)sizeof(TKV);
      ksrc += off;
      vsrc += off;
    }
    unsigned char* kd = stage_k(st) + r * C::ROW;
    unsigned char* vd = stage_v(st) + r * C::ROW;
    for (int c = (tid % 4) * 16; c < row_bytes; c += 64) {
      cp_async16(kd + c, ok ? ksrc + c : ksrc, ok);
      cp_async16(vd + c, ok ? vsrc + c : vsrc, ok);
    }
    if constexpr (Q8) {
      if (tid < 2 * kF32Tile) {
        const int r = tid % kF32Tile;
        const bool ok = j0 + r < t_hi;
        const float* src = tid < kF32Tile ? rows.ks : rows.vs;
        cp_async4(stage_s(st) + tid, ok ? src + rows.sc(j0 + r) : src, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, t_lo + st * kF32Tile);
    cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  const int kk = lane % kWarpKeys, part = lane / kWarpKeys;
  float o[GR][CG][4];
  float m[GR], l[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < CG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][j][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = t_lo + it * kF32Tile;
    // q and tile `it` have landed, and every warp is done with tile
    // it - 1, whose stage the next load refills
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (it + C::STAGES - 1 < n_tiles)
      load_kv((it + C::STAGES - 1) % C::STAGES, j0 + (C::STAGES - 1) * kF32Tile);
    cp_async_commit();
    const int w0 = j0 + warp * kWarpKeys;  // the warp's first token
    if (w0 >= t_hi) continue;
    const int st = it % C::STAGES;
    const int key = warp * kWarpKeys + kk;  // this lane's key in the tile

    // scores: this lane's part of q . k for each q row, then the parts'
    // sum over the lanes of the key
    float s[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) s[r] = 0.f;
    const unsigned char* krow = stage_k(st) + key * C::ROW;
    for (int c = 4 * part; c < d; c += 4 * kParts) {
      float kf[4];
      if constexpr (Q8) {
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(krow + c), kf);
      } else {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * c);
        kf[0] = kv.x;
        kf[1] = kv.y;
        kf[2] = kv.z;
        kf[3] = kv.w;
      }
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * DP + c);
        s[r] = fmaf(qv.x, kf[0], s[r]);
        s[r] = fmaf(qv.y, kf[1], s[r]);
        s[r] = fmaf(qv.z, kf[2], s[r]);
        s[r] = fmaf(qv.w, kf[3], s[r]);
      }
    }
    const bool live = w0 + kk < t_hi;
    const float ksc = Q8 ? stage_s(st)[key] : 1.f;
    const float vsc = Q8 ? stage_s(st)[kF32Tile + key] : 1.f;
    // K's scale, scale, softcap and mask in fp32, in base 2; one
    // online-softmax update a tile; p (times V's scale) for P V
    float pv[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], kWarpKeys);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2 * kWarpKeys);
      float raw = s[r];
      if constexpr (Q8) raw *= ksc;
      float x = raw * scale_log2;
      if (softcap > 0.f) x = softcap * tanhf(raw * scale / softcap) * kLog2e;
      if (!live) x = kNegInf;
      float mx = fmaxf(m[r], x);
#pragma unroll
      for (int sh = 1; sh < kWarpKeys; sh *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float alpha = exp2f(m[r] - mx);
      const float p = x == kNegInf ? 0.f : exp2f(x - mx);
      float sum = p;
#pragma unroll
      for (int sh = 1; sh < kWarpKeys; sh *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
      pv[r] = Q8 ? p * vsc : p;
#pragma unroll
      for (int j = 0; j < CG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][j][e] *= alpha;
    }

    // O += P V over the warp's live keys, in key order
    for (int k2 = 0; k2 < kWarpKeys && w0 + k2 < t_hi; ++k2) {
      const unsigned char* vrow = stage_v(st) + (warp * kWarpKeys + k2) * C::ROW;
      float pk[GR];
#pragma unroll
      for (int r = 0; r < GR; ++r) pk[r] = __shfl_sync(0xffffffffu, pv[r], k2);
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const int c = 4 * lane + 128 * j;
        if (c >= d) continue;
        float vf[4];
        if constexpr (Q8) {
          i8x4_to_f32(*reinterpret_cast<const uint32_t*>(vrow + c), vf);
        } else {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * c);
          vf[0] = vv.x;
          vf[1] = vv.y;
          vf[2] = vv.z;
          vf[3] = vv.w;
        }
#pragma unroll
        for (int r = 0; r < GR; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[r][j][e] = fmaf(pk[r], vf[e], o[r][j][e]);
      }
    }
  }

  // the warps' states (rows < gn) into shared memory, then merged in warp
  // order and across the cluster in rank order
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  float* wm = reinterpret_cast<float*>(work);  // [warps][GR]
  float* wl = wm + kWarps * GR;                // [warps][GR]
  float* wo = wl + kWarps * GR;                // [warps][GR][DP]
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (r >= blk.gn) continue;
    if (lane == 0) {
      wm[warp * GR + r] = m[r];
      wl[warp * GR + r] = l[r];
    }
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int c = 4 * lane + 128 * j;
      if (c < d)
        *reinterpret_cast<float4*>(wo + (warp * GR + r) * DP + c) =
            make_float4(o[r][j][0], o[r][j][1], o[r][j][2], o[r][j][3]);
    }
  }
  __syncthreads();
  float* pm = wo + kWarps * GR * DP;  // [GR]
  float* pl = pm + GR;                // [GR]
  float* po = pl + GR;                // [GR][d]
  split_decode::merge_warps(wm, wl, wo, GR, DP, d, blk.gn, pm, pl, po);
  float* og = out + ((long long)blk.b * hq + blk.h0) * d;
  split_decode::merge_ranks(pm, pl, po, d, blk.gn, nullptr,
                            [&](int row, int c, float v) { og[row * d + c] = v; });
}

template <int GR, int CG, bool Q8>
int launch_f32(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
               const void* v_scale, const void* block_tables, const void* kv_len, void* out,
               int b, int hq, int hkv, int ps, int d, int nb, float scale, float softcap,
               cudaStream_t stream) {
  static std::atomic<int> sms[kMaxDevices];
  return split_decode::launch_clusters(
      paged_f32_kernel<GR, CG, Q8>, sms, F32Cfg<GR, CG, Q8>::SMEM, GR, kF32Tile, b, hq, hkv,
      nb * ps, stream, static_cast<const float*>(q), k_pages, v_pages,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_tables), static_cast<const int32_t*>(kv_len),
      static_cast<float*>(out), hq, hkv, ps, d, nb, scale, softcap);
}

// The fp32 kernel for a group of `group` q-heads a kv-head: GR the least
// of 1, 2, 4, 8 that holds the group (8 beyond it: several clusters a
// kv-head), CG by the head dim.
template <bool Q8, typename... A>
int dispatch_f32(int group, int d, A... args) {
#define F32_GR(GR)                                              \
  return d <= 128 ? launch_f32<GR, 1, Q8>(args...) : launch_f32<GR, 2, Q8>(args...);
  if (group == 1) F32_GR(1)
  if (group == 2) F32_GR(2)
  if (group <= 4) F32_GR(4)
  F32_GR(8)
#undef F32_GR
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pages only, with scales).
// q and out share q_dtype; fp32 and bf16 pages go with a q of their dtype.
// A bf16 q takes D a multiple of 16 up to 256 with q, the pages and out
// 16-byte aligned; an fp32 q D a multiple of 4 (of 16 over int8 pages) up
// to 256 with q and the pages 16-byte aligned.  Anything else returns
// cudaErrorInvalidValue.
static int paged_decode_attention_impl(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, void* out, int q_dtype, int kv_dtype, int b, int hq,
    int hkv, int ps, int d, int nb, float scale, float softcap, void* stream) {
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv || ps <= 0)
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
      BF16_ATTENTION_HEAD_DIMS(SPLIT)
    }
#undef SPLIT
#undef SPLIT_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (q_dtype != 0 || d % (q8 ? 16 : 4) || !aligned16(q) || !aligned16(k_pages) ||
      !aligned16(v_pages))
    return (int)cudaErrorInvalidValue;
#define F32_ARGS q, k_pages, v_pages, k_scale, v_scale, block_tables, kv_len, out, b, hq, hkv, \
    ps, d, nb, scale, softcap, s
  return q8 ? dispatch_f32<true>(hq / hkv, d, F32_ARGS) : dispatch_f32<false>(hq / hkv, d, F32_ARGS);
#undef F32_ARGS
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int paged_decode_attention(const long long* args) {
  return call_packed(paged_decode_attention_impl, args);
}
