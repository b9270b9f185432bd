// Dense flash-decode: one query token per (batch, q-head) attending over the
// first kv_len[b] rows of a dense KV cache.  Built for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py · decode_attention
//   (_decode_body; fp and bf16 caches, and int8 caches with per-(b, head,
//   token) fp32 scales dequantized inside the kernel in q's dtype, as the
//   JAX package's stacked whole model dequantizes its int8 cache before
//   attending: in fp32 under an fp32 q, in bf16 under a bf16 q).
//
// What bounds it on the H100: bytes.  Each (batch, kv-head) row of kv_len
//   tokens must be read once (2 * kv_len * D elements, and the scales of an
//   int8 cache) for 4 FLOPs per element and q-head, far below the card's
//   ridge in any dtype.
//
// K/V are addressed through (batch, head, token) strides, so the stacked
//   (B, Hkv, T, D) cache and the backend's (B, T, Hkv, D) buffer seen
//   through transpose(1, 2) are both read in place, without a copy.  Every
//   route keeps these rules: p is rounded to the value dtype before the PV
//   product (bf16 caches, and int8 caches under a bf16 q), l sums the
//   unrounded p; an int8 cache under a bf16 q is dequantized as
//   bf16(bf16(k) * bf16(scale)); rows at or past kv_len are never read, so
//   a NaN there reaches no output; a row with no valid key writes 0.
//
// bf16 q over a bf16 or int8 cache (head dims 16/32/64/128/256, 16-byte
//   aligned rows; the wrapper refuses any other bf16 shape): a split-KV
//   kernel with one thread-block cluster per (batch, kv-head).  The
//   cluster's blocks (1-8, chosen so that the grid
//   holds about one block per SM) take contiguous ranges of the row's
//   kv_len tokens; the q-heads of the GQA group (up to 16, the rows of one
//   mma tile; a larger group takes several clusters) share every K/V row
//   the block reads, so each row leaves device memory once instead of once
//   per q-head.  A block of four warps streams tiles of 64 tokens through
//   two cp.async stages (16-byte copies; tokens past the range are
//   zero-filled without a read) and each warp takes 16 of a tile's tokens:
//   S = Q K^T on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate, the group's q rows in the A fragments), one online-softmax
//   update a tile in base 2, p rounded to bf16 straight into the PV A
//   fragments, O += P V on the tensor cores.  An int8 tile (its scales
//   staged with it) is dequantized by the warp that uses it into a bf16
//   buffer first.  The four warps' (m, l, O) merge through shared memory
//   in warp order, then the blocks' through distributed shared memory in
//   rank order, each block finishing a share of the outputs, all inside
//   the one launch; a block whose range lies past kv_len reads nothing and
//   contributes l = 0, which the merge weights by 0 (it never forms
//   exp(-inf - -inf)).  No atomics: two calls give the same bits.
//
// fp32 q over an fp32 or int8 cache: one block of 16 warps per (batch,
//   q-head); warp w takes tokens w, w + 16, ..., its lanes own head-dim
//   columns lane + 32 i, each warp keeps its own online softmax in
//   registers, and the 16 partial states merge once through shared
//   memory.  The q-heads of a GQA group re-read the same rows, which the
//   50 MB L2 absorbs.

#include <cooperative_groups.h>

#include <type_traits>

#include "device_helpers.h"
#include "launch_args.h"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// bf16 q: split-KV over a cluster, tensor cores
// ---------------------------------------------------------------------------

constexpr int kSpWarps = 4;
constexpr int kSpThreads = kSpWarps * 32;
constexpr int kSpTile = 16 * kSpWarps;  // tokens a tile, 16 a warp
constexpr int kSpStages = 2;            // K/V tiles in shared memory
constexpr int kSpRows = 16;             // q-heads a block: the rows of an mma tile
constexpr int kMaxCluster = 8;
constexpr int kSpBlocksPerSm = 1;       // the grid aims at this many blocks an SM

template <int D, bool Q8>
struct SpCfg {
  static constexpr int RS = D + 8;                // padded bf16 row (elements)
  static constexpr int KT = D / 16;               // k-steps of Q K^T
  static constexpr int DT = D / 8;                // n8 tiles of O
  static constexpr bool QREGS = D <= 128;         // Q fragments in registers
  static constexpr int ROW_BYTES = Q8 ? D : 2 * RS;                     // a staged row
  static constexpr int TILE = kSpTile * ROW_BYTES;                      // a K or V tile
  static constexpr int STAGE = 2 * TILE + (Q8 ? 2 * kSpTile * 4 : 0);   // K, V (and scales)
  static constexpr int WBUF = Q8 ? kSpWarps * 2 * 16 * RS * 2 : 0;      // dequantized slices
  static constexpr int OS = D + 4;                                      // merge row (floats)
  static constexpr int MERGE = kSpWarps * kSpRows * (OS + 2) * 4;       // warps' (m, l, O)
  static constexpr int PART = (kSpRows * D + 2 * kSpRows) * 4;          // the block's (m, l, O)
  // the tiles while the block streams; the warps' states and the block's
  // after it
  static constexpr int WORK = (kSpStages * STAGE + WBUF) > MERGE + PART
                                  ? kSpStages * STAGE + WBUF : MERGE + PART;
  static constexpr int QBYTES = kSpRows * RS * 2;
  static constexpr int SMEM = QBYTES + WORK;
  static_assert(D % 16 == 0 && D <= kMaxD, "head dim");
};

// One cluster per (batch, kv-head, group of 16 q-heads); see the notes at
// the top.  Q8: int8 K/V with per-token fp32 scales, dequantized in bf16.
template <int D, bool Q8>
__global__ void __launch_bounds__(kSpThreads)
decode_split_kernel(const bf16* __restrict__ q, long long q_sb, long long q_sh,
                    const void* __restrict__ k, const void* __restrict__ v, long long kv_sb,
                    long long kv_sh, long long kv_st, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, long long s_sb, long long s_sh,
                    long long s_st, const int32_t* __restrict__ kv_len, bf16* __restrict__ out,
                    long long o_sb, long long o_sh, int hq, int hkv, int t_max, float scale,
                    float softcap) {
  using C = SpCfg<D, Q8>;
  constexpr int RS = C::RS, CPR = D / 8;  // 16-byte chunks a bf16 row
  typedef typename std::conditional<Q8, int8_t, bf16>::type TKV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                 // kSpRows x RS
  unsigned char* work = smem_raw + C::QBYTES;                   // stages (+ buffers) / merge
  float* part = reinterpret_cast<float*>(work + C::MERGE);      // m[16], l[16], O[16][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.x / cs;
  const int b = bk / hkv, kvh = bk % hkv;
  const int group = hq / hkv;
  const int h0 = kvh * group + blockIdx.y * kSpRows;
  const int gn = min(kSpRows, group - (int)blockIdx.y * kSpRows);  // q-heads here
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  // this block's tokens: a contiguous share of the row's kv_len
  const int len = max(0, min(kv_len[b], t_max));
  const int chunk = ((len + cs - 1) / cs + 15) / 16 * 16;
  const int t_lo = min(len, rank * chunk), t_hi = min(len, t_lo + chunk);
  const int n_tiles = (t_hi - t_lo + kSpTile - 1) / kSpTile;

  const bf16* qb = q + b * q_sb;
  for (int i = tid; i < kSpRows * CPR; i += kSpThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < gn;
    cp_async16(qs + r * RS + c, ok ? qb + (h0 + r) * q_sh + c : qb, ok);
  }
  cp_async_commit();

  const TKV* kb = static_cast<const TKV*>(k) + b * kv_sb + kvh * kv_sh;
  const TKV* vb = static_cast<const TKV*>(v) + b * kv_sb + kvh * kv_sh;
  auto stage_k = [&](int st) { return work + st * C::STAGE; };
  auto stage_v = [&](int st) { return work + st * C::STAGE + C::TILE; };
  // an int8 tile's per-token scales, K then V
  auto stage_s = [&](int st) { return reinterpret_cast<float*>(work + st * C::STAGE + 2 * C::TILE); };
  const float* ksb = k_scale + b * s_sb + kvh * s_sh;
  const float* vsb = v_scale + b * s_sb + kvh * s_sh;
  // tokens [j0, j0 + kSpTile) into `st`; those at or past t_hi are
  // zero-filled without a read
  auto load_kv = [&](int st, int j0) {
    constexpr int CH = Q8 ? D / 16 : CPR;  // 16-byte chunks a row
    unsigned char* kd = stage_k(st);
    unsigned char* vd = stage_v(st);
    for (int i = tid; i < kSpTile * CH; i += kSpThreads) {
      const int r = i / CH, c = (i % CH) * 16 / (int)sizeof(TKV);
      const bool ok = j0 + r < t_hi;
      const long long off = ok ? (long long)(j0 + r) * kv_st + c : 0;
      cp_async16(kd + r * C::ROW_BYTES + c * sizeof(TKV), kb + off, ok);
      cp_async16(vd + r * C::ROW_BYTES + c * sizeof(TKV), vb + off, ok);
    }
    if constexpr (Q8) {
      if (tid < 2 * kSpTile) {
        const int r = tid % kSpTile;
        const bool ok = j0 + r < t_hi;
        const float* src = tid < kSpTile ? ksb : vsb;
        cp_async4(stage_s(st) + tid, ok ? src + (long long)(j0 + r) * s_st : src, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kSpStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, t_lo + st * kSpTile);
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
  bf16* wk = reinterpret_cast<bf16*>(work + kSpStages * C::STAGE) + warp * 2 * 16 * RS;
  bf16* wv = wk + 16 * RS;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = t_lo + it * kSpTile;
    // Q and tile `it` have landed, and every warp is done with tile it - 1,
    // whose stage the next load refills
    cp_async_wait<kSpStages - 2>();
    __syncthreads();
    if (it + kSpStages - 1 < n_tiles)
      load_kv((it + kSpStages - 1) % kSpStages, j0 + (kSpStages - 1) * kSpTile);
    cp_async_commit();
    if constexpr (C::QREGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::KT; ++kk) ldmatrix_x4(qf[kk], qs + a_row * RS + kk * 16 + a_col);
      }
    }
    const int w0 = j0 + warp * 16;  // the warp's first token
    if (w0 >= t_hi) continue;
    const int st = it % kSpStages;
    const bf16* kt;
    const bf16* vt;
    if constexpr (Q8) {
      // dequantize the warp's 16 rows: bf16(bf16(k) * bf16(scale)), zeros
      // past t_hi (whose scales are not read)
      const int8_t* ki = reinterpret_cast<const int8_t*>(stage_k(st)) + warp * 16 * D;
      const int8_t* vi = reinterpret_cast<const int8_t*>(stage_v(st)) + warp * 16 * D;
      const float* sc = stage_s(st) + warp * 16;  // zero past t_hi
      for (int i = lane; i < 16 * D / 16; i += 32) {
        const int r = i / (D / 16), c = (i % (D / 16)) * 16;
        const float ks = bf16r(sc[r]);
        const float vs = bf16r(sc[kSpTile + r]);
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

    // scale, softcap and mask in fp32, in base 2; the tile's row max
    const bool edge = w0 + 16 > t_hi;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (softcap > 0.f) x = softcap * tanhf(s[j][e] * scale / softcap) * kLog2e;
        if (edge && w0 + j * 8 + 2 * tig + (e & 1) >= t_hi) x = kNegInf;
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

    // p (fp32 into l, bf16 into the PV A fragments), then O += P V
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
        l[e / 2] += pe;
        p[j][e] = pe;
      }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dp = 0; dp < C::DT / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + v_row * RS + dp * 16 + v_col);
      mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
    if constexpr (Q8) __syncwarp();  // the buffer is refilled next tile
  }

  // the warps' states (rows < gn) into shared memory, merged in warp order
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  float* wm = reinterpret_cast<float*>(work);  // [warps][16]
  float* wl = wm + kSpWarps * kSpRows;         // [warps][16]
  float* wo = wl + kSpWarps * kSpRows;         // [warps][16][OS]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = g + 8 * r;
    if (row >= gn) continue;
    if (tig == 0) {
      wm[warp * kSpRows + row] = m[r];
      wl[warp * kSpRows + row] = l[r];
    }
    float* orow = wo + (warp * kSpRows + row) * C::OS + 2 * tig;
#pragma unroll
    for (int j = 0; j < C::DT; ++j) {
      orow[j * 8] = o[j][2 * r];
      orow[j * 8 + 1] = o[j][2 * r + 1];
    }
  }
  __syncthreads();
  float* pm = part;                  // [16]
  float* pl = part + kSpRows;        // [16]
  float* po = part + 2 * kSpRows;    // [16][D]
  for (int i = tid; i < gn * D; i += kSpThreads) {
    const int row = i / D, c = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kSpWarps; ++w) mm = fmaxf(mm, wm[w * kSpRows + row]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kSpWarps; ++w) {
      const float lw = wl[w * kSpRows + row];
      const float f = lw == 0.f ? 0.f : exp2f(wm[w * kSpRows + row] - mm);
      ll += lw * f;
      oo += wo[(w * kSpRows + row) * C::OS + c] * f;
    }
    po[row * D + c] = oo;
    if (c == 0) {
      pm[row] = mm;
      pl[row] = ll;
    }
  }

  // the cluster's blocks merge in rank order, each finishing every cs-th
  // group of the outputs
  cluster.sync();
  for (int i = rank * kSpThreads + tid; i < gn * D; i += cs * kSpThreads) {
    const int row = i / D, c = i % D;
    // every rank's (m, l, o) read at once, so the remote loads overlap
    float rm[kMaxCluster], rl[kMaxCluster], ro[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < cs) {
        rm[j] = cluster.map_shared_rank(pm, j)[row];
        rl[j] = cluster.map_shared_rank(pl, j)[row];
        ro[j] = cluster.map_shared_rank(po, j)[row * D + c];
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
    out[b * o_sb + (h0 + row) * o_sh + c] = __float2bfloat16(ll == 0.f ? 0.f : oo / ll);
  }
  cluster.sync();  // no block leaves while another reads its state
}

template <int D, bool Q8>
int launch_split(const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
                 long long kv_sb, long long kv_sh, long long kv_st, const void* k_scale,
                 const void* v_scale, long long s_sb, long long s_sh, long long s_st,
                 const void* kv_len, void* out, long long o_sb, long long o_sh, int b, int hq,
                 int hkv, int t_max, float scale, float softcap, cudaStream_t stream) {
  using C = SpCfg<D, Q8>;
  static std::atomic<int> sms[kMaxDevices];
  int sm_count = 0;
  const int err = kernel_setup(decode_split_kernel<D, Q8>, C::SMEM, sms, sm_count);
  if (err) return err;
  const int groups = (hq / hkv + kSpRows - 1) / kSpRows;
  const int rows = b * hkv * groups;
  const int want = (kSpBlocksPerSm * sm_count + rows - 1) / rows;
  const int most = max(1, (t_max + kSpTile - 1) / kSpTile);  // a tile a block at least
  const int cs = max(1, min(kMaxCluster, min(want, most)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * hkv * cs, groups);
  cfg.blockDim = dim3(kSpThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_split_kernel<D, Q8>, static_cast<const bf16*>(q), q_sb, q_sh, k, v, kv_sb,
      kv_sh, kv_st, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      s_sb, s_sh, s_st, static_cast<const int32_t*>(kv_len), static_cast<bf16*>(out), o_sb,
      o_sh, hq, hkv, t_max, scale, softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 q: a block per q-head
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = kMaxD / 32;      // head-dim columns per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// Q8: int8 K/V with per-row scales applied in fp32 (the JAX package's
// stacked-cache rule under an fp32 q, models/model.py:481-485).
template <typename TKV, bool Q8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, long long q_sb, long long q_sh,
              const TKV* __restrict__ k, const TKV* __restrict__ v,
              long long kv_sb, long long kv_sh, long long kv_st,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              long long s_sb, long long s_sh, long long s_st,
              const int32_t* __restrict__ kv_len, float* __restrict__ out,
              long long o_sb, long long o_sh, int hq, int hkv, int t_max,
              int d, float scale, float softcap) {
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxD];

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(kv_len[b], t_max);

  float qr[kCols];
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? q[b * q_sb + h * q_sh + c] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const TKV* kb = k + b * kv_sb + kvh * kv_sh;
  const TKV* vb = v + b * kv_sb + kvh * kv_sh;
  for (int t = warp; t < len; t += kWarps) {
    const TKV* kr = kb + t * kv_st;
    const TKV* vr = vb + t * kv_st;
    float ksc = 1.f, vsc = 1.f;
    if (Q8) {
      const long long si = b * s_sb + kvh * s_sh + t * s_st;
      ksc = k_scale[si];
      vsc = v_scale[si];
    }
    float kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      kv[i] = c < d ? to_f(kr[c]) : 0.f;
      vv[i] = c < d ? to_f(vr[c]) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) s += qr[i] * kv[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (Q8) s *= ksc;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float pv = p * vsc;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = acc[i] * alpha + pv * vv[i];
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = lane + 32 * i;
    if (c < d) acc_s[warp][c] = acc[i];
  }
  __syncthreads();

  for (int c = threadIdx.x; c < d; c += kThreads) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = (l_s[w] == 0.f) ? 0.f : expf(m_s[w] - mx);
      lt += l_s[w] * f;
      at += acc_s[w][c] * f;
    }
    out[b * o_sb + h * o_sh + c] = at / (lt == 0.f ? 1.f : lt);
  }
}

template <typename TKV, bool Q8>
int launch(const void* q, long long q_sb, long long q_sh, const void* k,
           const void* v, long long kv_sb, long long kv_sh, long long kv_st,
           const void* k_scale, const void* v_scale, long long s_sb,
           long long s_sh, long long s_st, const void* kv_len, void* out,
           long long o_sb, long long o_sh, int b, int hq, int hkv, int t_max,
           int d, float scale, float softcap, cudaStream_t stream) {
  decode_kernel<TKV, Q8><<<b * hq, kThreads, 0, stream>>>(
      static_cast<const float*>(q), q_sb, q_sh, static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kv_sb, kv_sh, kv_st,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      s_sb, s_sh, s_st, static_cast<const int32_t*>(kv_len),
      static_cast<float*>(out), o_sb, o_sh, hq, hkv, t_max, d, scale, softcap);
  return (int)cudaGetLastError();
}

// Does a bf16 q over this cache fit the split kernel: a head dim it is
// instantiated for, and every row it copies 16-byte aligned (a stride of a
// dim of size 1 is never used).  The wrapper refuses anything else first.
bool split_shape(const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
                 long long kv_sb, long long kv_sh, long long kv_st, int kv_el, int b, int hq,
                 int hkv, int t_max, int d) {
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 256) return false;
  auto al = [](long long x) { return x % 16 == 0; };
  if (!al((long long)(uintptr_t)q) || !al((long long)(uintptr_t)k) ||
      !al((long long)(uintptr_t)v))
    return false;
  if ((b > 1 && !al(2 * q_sb)) || (hq > 1 && !al(2 * q_sh))) return false;
  if ((b > 1 && !al(kv_el * kv_sb)) || (hkv > 1 && !al(kv_el * kv_sh)) ||
      (t_max > 1 && !al(kv_el * kv_st)))
    return false;
  return true;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only, with scales).
// A bf16 q takes the split kernel or is refused; an fp32 q the per-q-head
// kernel.
static int decode_attention_impl(
    const void* q, long long q_sb, long long q_sh, int q_dtype,
    const void* k, const void* v, long long kv_sb, long long kv_sh,
    long long kv_st, int kv_dtype, const void* k_scale, const void* v_scale,
    long long s_sb, long long s_sh, long long s_st, const void* kv_len,
    void* out, long long o_sb, long long o_sh, int b, int hq, int hkv,
    int t_max, int d, float scale, float softcap, void* stream) {
  if (d > kMaxD || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1) {
    if ((kv_dtype != 1 && kv_dtype != 2) ||
        !split_shape(q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, kv_dtype == 1 ? 2 : 1, b, hq,
                     hkv, t_max, d))
      return (int)cudaErrorInvalidValue;
#define SPLIT_ARGS q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, k_scale, v_scale, s_sb, s_sh, \
    s_st, kv_len, out, o_sb, o_sh, b, hq, hkv, t_max, scale, softcap, s
#define SPLIT(D)                                                   \
  case D:                                                          \
    return kv_dtype == 2 ? launch_split<D, true>(SPLIT_ARGS)       \
                         : launch_split<D, false>(SPLIT_ARGS);
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
#define DECODE_ARGS q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_st, k_scale, v_scale, \
    s_sb, s_sh, s_st, kv_len, out, o_sb, o_sh, b, hq, hkv, t_max, d, scale,     \
    softcap, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, false>(DECODE_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<int8_t, true>(DECODE_ARGS);
#undef DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

// Entry points: the arguments of the functions above, packed (launch_args.h).
extern "C" int decode_attention(const long long* args) {
  return call_packed(decode_attention_impl, args);
}
