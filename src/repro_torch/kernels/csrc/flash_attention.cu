// K6: flash attention for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py:flash_attention_bhsd
// (_flash_kernel) and the GQA expansion of repro/kernels/ops.py:
// flash_attention. q is read as (B,S,H,hd) and K/V as (B,S,Hkv,hd) by KV
// head h / (H / Hkv): the expanded copy the reference builds never exists.
// Both kernels compute the reference's step, key block by key block of
// blk_k keys in its order: s = (q . k^T) x scale in f32 (the scale after
// the product), masked to -1e30; m_new = max(m, the block's row max);
// p = exp(s - m_new) zeroed where masked; alpha = exp(max(m - m_new, -80));
// l = l alpha + sum p; acc = acc alpha + p V; at the end acc / max(l,
// 1e-20) in q's dtype (round to nearest). The mask is the reference's
// (causal & window) | prefix: with a prefix (prefix-LM, the vision
// frontend's patch embeddings) every row also sees the first `prefix`
// keys, so a tile's key range reaches the prefix's last key whatever its
// rows and starts at key 0 whatever the window. A key block that the mask
// removes for every row a tile holds is skipped: there the reference's
// step leaves m, l and acc exactly as they were (so does a 64-key
// sub-tile of the bf16 kernel's that the mask removes: skipped in a block
// wider than 128 keys, computed with p = 0 in a narrower one). The library
// is built with --fmad=false, and exp is expf (not __expf, not exp2f with
// log2(e) folded into the scale).
//
// Bound on this card: at the glm4-9b prefill (B 4, S 2048, H 32, Hkv 2,
// hd 128, causal) the two products are ~137.5 GFLOP, ~139 us at the
// tensor cores' bf16 rate and ~2.05 ms at the f32 rate outside them; the
// bytes (q, k, v read once, o written once) take ~43 us. At the
// paligemma-3b prefill (H 8, Hkv 1, hd 256, prefix 256) the kept pairs
// give ~69.8 GFLOP, ~70.6 us at the bf16 rate, against ~22.5 us of bytes.
// Both kernels are bound by the operations.
//
// bf16: flash_attention_kernel_wgmma, on the tensor cores (its TMA,
// mbarrier and wgmma helpers are csrc/hopper.cuh's, shared with the
// backward). One CTA of
// three warpgroups per (128 query rows, head, batch row), launched with
// the query tiles that walk the most key blocks first (a causal prefill's
// long tiles do not form the tail). Warpgroup 2 gives up its registers
// (setmaxnreg 24) and one of its threads issues every load: Q once, then
// K and V in sub-tiles of 64 keys through two rings of 4 stages (2 at head
// dim 256, where Q's 64 KB and four 32 KB sub-tiles a ring would pass the
// 227 KB a CTA may hold: a key block is then at most 128 keys), each a TMA
// copy (cp.async.bulk.tensor, 128-byte swizzle, 64-column panels: four at
// head dim 256) that completes on an mbarrier; each consumer warp
// releases a stage on another. Warpgroups 0 and 1 (setmaxnreg 240) own 64
// query rows each:
//   scores  wgmma m64n64k16 bf16 x bf16 -> f32, Q and the K sub-tile both
//           from shared memory (K-major, hd contiguous), hd / 16 k-steps
//           per sub-tile; a block of up to 128 keys (the model's) keeps
//           both sub-tiles' scores in registers until its max is known; a
//           wider block (up to 256 keys, 4 sub-tiles, all in the K ring),
//           and at head dim 256 a block of two sub-tiles, takes its max
//           over every sub-tile first and computes each sub-tile's scores
//           again for p, since its f32 score tile beside the accumulator
//           (64 x 128, or 64 x 256: 128 registers a thread) spills;
//   softmax on the accumulator fragment: a row lives on the 4 threads of
//           a quad, so its max and sum take two __shfl_xor_sync steps;
//   p V     wgmma m64nHDk16 with A = p from registers and B = the V
//           sub-tile from shared memory in its (key, hd) layout, which is
//           MN-major (the transpose bit); at head dim 256 two m64n128k16
//           products, one per half of the columns. p is split as p_hi =
//           bf16(p), p_lo = bf16(p - p_hi), and both products go into the
//           same f32 accumulator: p keeps 16 of f32's 24 significand bits
//           (2^-17 relative) where one bf16 rounding keeps 8 (2^-9), so
//           the result stays within one bf16 ulp of the f32 reference; the
//           split costs half again the tensor work of an unsplit p V.
//           Sub-tile 1's exponentials run while sub-tile 0's p V does.
// Each consumer warp hands a K stage back once its scores are done and a V
// stage once its p V is. The products are not what bounds this kernel:
// taking either away saves less of its time than taking expf away
// (scripts/k6_probe.py times the parts by removal); its CUDA-core work
// per score (an accurate expf, the mask where a block needs one, the
// split) sets the pace.
// Keys past a block's end or past S inside a sub-tile get p = 0 (past S
// the TMA copy fills K and V with zeros). Query rows past S are computed
// on zero rows of Q and never stored. The TMA maps are 4-D (column, head,
// row, batch), so a 64-column box ends at its head's last column: head
// dims 16, 32 and 96 fill their last panel with zeros past hd (nothing of
// the next head is read), the scores take hd / 16 k-steps, and the p V
// columns past hd come out zero and are not stored. Head dim 96 runs p V
// at n = 128, a third more tensor work than its 96 columns need. The
// kernel is instantiated for head dims 16, 32, 64, 96, 128 and 256, each
// without and with a prefix.
//
// f32: flash_attention_kernel, on the CUDA cores. The tensor cores would
// take f32 only as TF32 (10 significand bits), which the port does not use.
// One CTA of 256 threads per (64 query rows, head, batch row). The key
// axis is walked in blocks of blk_k keys, each staged through shared
// memory in sub-tiles of 64 keys (K for the scores, then V for the
// accumulator). Per block:
//   scores   each thread a 4 x 4 register tile of the 64 x 64 sub-tile,
//            dot over hd, then x scale, into the block's score tile;
//   softmax  4 threads per query row, the reference's step above, acc the
//            row's hd / 4 columns (64 floats at head dim 256).
// Shared-memory rows are padded to hd + 1 floats so the column-strided
// reads fall in distinct banks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>

#include <type_traits>

#include "attention_mask.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxBlkK = 256;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kQT = 64;       // query rows per CTA
constexpr int kKT = 64;       // keys per staged sub-tile
constexpr int kThreads = 256;

// (kThreads, 1): ptxas may take the registers it needs (at most 146, at
// head dim 256) rather than spill to keep more CTAs on an SM
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv, int BK, int causal,
    int window, int prefix, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  constexpr int ND = HD / 4;
  const int LS = BK + 1;
  float* sQ = smem;              // kQT x LD
  float* sKV = sQ + kQT * LD;    // kKT x LD: a K, then a V, sub-tile
  float* sS = sKV + kKT * LD;    // kQT x LS: the block's scores, then p

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t rowq = (size_t)H * HD;
  const size_t rowk = (size_t)Hkv * HD;
  const float* qb = q + (size_t)b * S * rowq + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * rowk + (size_t)hk * HD;
  const float* vb = v + (size_t)b * S * rowk + (size_t)hk * HD;
  float* ob = o + (size_t)b * S * rowq + (size_t)h * HD;

  for (int i = tid; i < kQT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * LD + d] = q0 + r < S ? qb[(size_t)(q0 + r) * rowq + d] : 0.f;
  }
  // softmax / accumulator layout: query row pr, a quarter ps of its keys
  // and of its hd columns (columns ps, ps + 4, ...)
  const int pr = tid >> 2, ps = tid & 3;
  const int qrow = q0 + pr;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;
  // score layout: rows sr0..sr0+3, columns sc0 + 16 j
  const int sr0 = (tid >> 4) * 4, sc0 = tid & 15;

  const int q_last = min(q0 + kQT, S) - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    if (causal && k0 > max(q_last, prefix - 1)) break;
    if (keys_dead(k0, k0 + BK, q0, q_last, causal, window, prefix))
      continue;
    for (int t0 = 0; t0 < BK; t0 += kKT) {
      const int nk = min(kKT, BK - t0);
      __syncthreads();
      for (int i = tid; i < kKT * HD; i += kThreads) {
        const int r = i / HD, d = i % HD;
        sKV[r * LD + d] = r < nk ? kb[(size_t)(k0 + t0 + r) * rowk + d] : 0.f;
      }
      __syncthreads();
      float s4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(sr0 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = sKV[(sc0 + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s4[i][j] = s4[i][j] + a[i] * bk[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc0 + 16 * j;
          if (c < nk) sS[(sr0 + i) * LS + t0 + c] = s4[i][j] * scale;
        }
    }
    __syncthreads();
    float* srow = sS + pr * LS;
    float mb = kNegInf;
    for (int c = ps; c < BK; c += 4) {
      const bool kept = keep(qrow, k0 + c, causal, window, prefix);
      const float s = kept ? srow[c] : kNegInf;
      srow[c] = s;
      mb = fmaxf(mb, s);
    }
    mb = fmaxf(mb, __shfl_xor_sync(FULL_MASK, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(FULL_MASK, mb, 2));
    const float m_new = fmaxf(m, mb);
    float ls = 0.f;
    for (int c = ps; c < BK; c += 4) {
      const bool kept = keep(qrow, k0 + c, causal, window, prefix);
      const float p = kept ? expf(srow[c] - m_new) : 0.f;
      srow[c] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(FULL_MASK, ls, 1);
    ls += __shfl_xor_sync(FULL_MASK, ls, 2);
    const float alpha = expf(fmaxf(m - m_new, -80.f));
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] = acc[j] * alpha;
    for (int t0 = 0; t0 < BK; t0 += kKT) {
      const int nk = min(kKT, BK - t0);
      __syncthreads();
      for (int i = tid; i < kKT * HD; i += kThreads) {
        const int r = i / HD, d = i % HD;
        sKV[r * LD + d] = r < nk ? vb[(size_t)(k0 + t0 + r) * rowk + d] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nk; ++c) {
        const float p = srow[t0 + c];
        const float* vr = sKV + c * LD + ps;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] = acc[j] + p * vr[4 * j];
      }
    }
  }
  if (qrow < S) {
    const float denom = fmaxf(l, 1e-20f);
    float* orow = ob + (size_t)qrow * rowq + ps;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[4 * j] = acc[j] / denom;
    if (lse != nullptr && ps == 0)
      lse[((size_t)b * H + h) * S + qrow] = row_lse(m, l);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int Hkv, int blk_k,
               int causal, int window, int prefix, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)(kQT + kKT) * (HD + 1) +
                       (size_t)kQT * (blk_k + 1));
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((S + kQT - 1) / kQT, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, S,
      H, Hkv, blk_k, causal, window, prefix, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA-staged K/V
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 128;     // query rows per CTA: 2 consumer warpgroups
constexpr int kKeys = 64;      // keys per staged K/V sub-tile
constexpr int kThreads = 384;  // warpgroups 0-1 consume, 2 loads
constexpr int kEmptyArrivals = 8;  // one per consumer warp

// query row `row` keeps key `col` of a block that ends at `kend`
__device__ __forceinline__ bool keep_key(int row, int col, int kend,
                                         int causal, int window, int prefix) {
  return col < kend && keep(row, col, causal, window, prefix);
}

template <int HD>
struct Tile {
  // 64-column panels (head dims 96 and 128 pad to two, 256 is four)
  static constexpr int NP = (HD + kPanel - 1) / kPanel;
  static constexpr int HDP = NP * kPanel;  // columns p V computes
  // stages of each ring: four (a 256-key block) up to head dim 128; two
  // (a 128-key block) at 256, where Q (64 KB) and two rings of four
  // 32 KB sub-tiles would pass the 227 KB a CTA may hold
  static constexpr int kStages = HD > 128 ? 2 : 4;
  // a block's scores in registers, one sub-tile (64 x 64 f32: 32 a
  // thread) for each of its sub-tiles; at head dim 256 the 64 x 256
  // accumulator (128 a thread) leaves room for one
  static constexpr int kScoreTiles = HD > 128 ? 1 : 2;
  static constexpr uint32_t kQPanel = kRows * 128;
  static constexpr uint32_t kKVPanel = kKeys * 128;
  static constexpr uint32_t kKV = NP * kKVPanel;  // one K or V sub-tile
  static constexpr uint32_t kBars = NP * kQPanel + 2 * kStages * kKV;
  // + 1024 to align the base; barriers: full K, empty K, full V, empty V
  // rings, then Q's
  static constexpr uint32_t kSmem = 1024 + kBars + 8 * (4 * kStages + 1);
  static_assert(kSmem <= (uint32_t)kMaxSmem, "shared memory");
};

// Where a 64-key sub-tile of a key block stands for a warpgroup's rows:
// some key kept for some row (live), every key kept for every row (whole:
// no mask to apply).
struct Sub {
  int kb, kend;  // its first key; the end of its key block
  bool live, whole;
};

__device__ __forceinline__ Sub sub_tile(int k0, int kend, int i, int qlo,
                                        int qhi, bool rows_live,
                                        int causal, int window, int prefix) {
  Sub t;
  t.kb = k0 + i * kKeys;
  t.kend = kend;
  const int ke = min(t.kb + kKeys, kend);
  t.live =
      rows_live && !keys_dead(t.kb, ke, qlo, qhi, causal, window, prefix);
  t.whole = ke == t.kb + kKeys &&
            keys_whole(t.kb, ke, qlo, qhi, causal, window, prefix);
  return t;
}

// The fragment of a 64 x 64 f32 tile a thread holds: rows row0 (elements
// e with e & 2 == 0) and row0 + 8, columns 8 (e / 4) + col0 + (e & 1).
struct Frag {
  int row0, row1, col0;
  __device__ __forceinline__ int row(int e) const {
    return (e & 2) ? row1 : row0;
  }
  __device__ __forceinline__ int col(int e) const {
    return 8 * (e / 4) + col0 + (e & 1);
  }
};

// issue s = Q K^T for one sub-tile: hd / 16 k-steps of 16 columns, the
// second 64-column panel of Q and K after the first
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_base,
                                         uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da =
        sw128_desc(q_base + (kk / 4) * Tile<HD>::kQPanel + off, 16, 1024);
    const uint64_t db =
        sw128_desc(kt + (kk / 4) * Tile<HD>::kKVPanel + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_n64_first(s, da, db);
    else
      wgmma_ss_n64_acc(s, da, db);
  }
}

// s = s x scale, -1e30 where masked (everywhere in a sub-tile that is not
// live); the running row maxima. A whole sub-tile skips the mask; either
// way the code is straight-line, with no branch per element.
__device__ __forceinline__ void scale_mask(float (&s)[32], const Sub& t,
                                           const Frag& f, int causal,
                                           int window, int prefix,
                                           float scale, float& mb0,
                                           float& mb1) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = s[e] * scale;
  if (!(t.live && t.whole)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool kept = t.live && keep_key(f.row(e), t.kb + f.col(e),
                                           t.kend, causal, window, prefix);
      s[e] = kept ? s[e] : kNegInf;
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if (e & 2)
      mb1 = fmaxf(mb1, s[e]);
    else
      mb0 = fmaxf(mb0, s[e]);
  }
}

// s = p = exp(s - m_new), 0 where masked; the running row sums. The
// exponential is taken everywhere and the mask selects after it (exp of a
// masked -1e30 is 0 or, in a row with nothing kept yet, 1, and is dropped).
__device__ __forceinline__ void exponentiate(float (&s)[32], const Sub& t,
                                             const Frag& f, int causal,
                                             int window, int prefix,
                                             float mn0, float mn1,
                                             float& ls0, float& ls1) {
  const bool whole = t.live && t.whole;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float p = expf(s[e] - ((e & 2) ? mn1 : mn0));
    s[e] = p;
  }
  if (!whole) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool kept = t.live && keep_key(f.row(e), t.kb + f.col(e),
                                           t.kend, causal, window, prefix);
      s[e] = kept ? s[e] : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if (e & 2)
      ls1 += s[e];
    else
      ls0 += s[e];
  }
}

// k-step kk of p as two bf16 A fragments, p_hi = bf16(p) and p_lo =
// bf16(p - p_hi): the accumulator's (row, 2 columns) pairs are the A
// fragment's, and k-step kk takes column groups 2 kk and 2 kk + 1
__device__ __forceinline__ void split_step(const float (&s)[32], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // r: (row0, group 2kk), (row1, 2kk), (row0, 2kk+1), (row1, 2kk+1)
    const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(s[e], s[e + 1]);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[r] = pack_bf16(s[e] - __low2float(h2), s[e + 1] - __high2float(h2));
  }
}

// every k-step of p as p_hi / p_lo fragments
__device__ __forceinline__ void split_p(const float (&s)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) split_step(s, kk, hi[kk], lo[kk]);
}

// issue acc += p_hi V + p_lo V for one sub-tile: 16 keys (rows of 128
// bytes) per k-step; V's second 64-column panel is the leading-byte-offset
// step of the MN-major layout, its 8-row groups the stride-byte-offset
// step
template <int NA>
__device__ __forceinline__ void issue_pv(float (&acc)[NA],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t vt, uint32_t panel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = sw128_desc(vt + kk * 16 * 128, panel, 1024);
    if constexpr (NA == 64) {
      wgmma_rs_n128<0>(acc, hi[kk], dv);
      wgmma_rs_n128<0>(acc, lo[kk], dv);
    } else {
      wgmma_rs_n64(acc, hi[kk], dv);
      wgmma_rs_n64(acc, lo[kk], dv);
    }
  }
}

// acc (64 x 256) += p_hi V + p_lo V for one sub-tile at head dim 256,
// from p in f32 (fenced, issued and waited here). 256 columns are two
// n = 128 products, the second from V's third panel into the
// accumulator's second half (its fragment is two 128-column ones side by
// side). Each k-step's fragments are split just before its four products
// and retired with them, so 8 fragment registers, not 32, stand beside
// the 128-float accumulator and p (with all 32, a consumer thread needs
// more than its 240).
__device__ __forceinline__ void pv_256(float (&acc)[128],
                                       const float (&s)[32], uint32_t vt,
                                       uint32_t panel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    split_step(s, kk, hi, lo);
    const uint64_t dv0 = sw128_desc(vt + kk * 16 * 128, panel, 1024);
    const uint64_t dv1 =
        sw128_desc(vt + 2 * panel + kk * 16 * 128, panel, 1024);
    fence_regs(acc);
    wgmma_fence();
    wgmma_rs_n128<0>(acc, hi, dv0);
    wgmma_rs_n128<64>(acc, hi, dv1);
    wgmma_rs_n128<0>(acc, lo, dv0);
    wgmma_rs_n128<64>(acc, lo, dv1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL_MASK, x, 1);
  return x + __shfl_xor_sync(FULL_MASK, x, 2);
}

// a block's max known (mb, this thread's part of each row's): m_new =
// max(m, block max), alpha = exp(max(m - m_new, -80)); acc and l scaled
// by alpha (the block's sum of p is added to l afterwards), m = m_new
template <int NA>
__device__ __forceinline__ void rescale(float (&acc)[NA], float& m0,
                                        float& m1, float& l0, float& l1,
                                        float mb0, float mb1) {
  const float mn0 = fmaxf(m0, quad_max(mb0));
  const float mn1 = fmaxf(m1, quad_max(mb1));
  const float a0 = expf(fmaxf(m0 - mn0, -80.f));
  const float a1 = expf(fmaxf(m1 - mn1, -80.f));
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = acc[e] * ((e & 2) ? a1 : a0);
  l0 = l0 * a0;
  l1 = l1 * a1;
  m0 = mn0;
  m1 = mn1;
}

// One consumer warpgroup's whole life: its 64 query rows over the key
// blocks below jb1 that the tile does not skip, each of nsub sub-tiles
// taken from the rings in the order the producer fills them.
template <int HD>
__device__ __forceinline__ void consume(
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t full_k,
    uint32_t empty_k, uint32_t full_v, uint32_t empty_v, uint32_t bar_q,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H,
    int BK, int causal, int window, int prefix, float scale, int h, int b,
    int q0, int q_last, int jb1, int nsub) {
  using T = Tile<HD>;
  constexpr int NA = T::HDP / 2;  // accumulator floats per thread
  constexpr int kStages = T::kStages;
  const int g = warpgroup();
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qlo = q0 + 64 * g;
  const Frag f{qlo + 16 * w + lane / 4, qlo + 16 * w + lane / 4 + 8,
               2 * (lane % 4)};
  const int qhi = min(qlo + 63, S - 1);
  const bool rows_live = qlo < S;
  auto kslot = [&](int n) { return sK + (n % kStages) * T::kKV; };
  auto vslot = [&](int n) { return sV + (n % kStages) * T::kKV; };
  auto parity = [](int n) { return (uint32_t)((n / kStages) & 1); };

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  const uint32_t q_base = sQ + g * 64 * 128;
  auto release = [&](uint32_t empty, int n) {
    if (lane == 0) mbar_arrive(empty + 8 * (n % kStages));
  };
  auto sub = [&](int j, int i) {
    return sub_tile(j * BK, j * BK + BK, i, qlo, qhi, rows_live, causal,
                    window, prefix);
  };

  // A block of one or two sub-tiles (up to 128 keys, the model's) keeps its
  // scores in registers. Both sub-tiles are computed, live or not (the mask
  // makes p = 0 there, an exact no-op), so no branch splits a wgmma stage;
  // sub-tile 1's exponentials overlap sub-tile 0's p V.
  auto in_registers = [&](auto n_subs, int j, int c) {
    constexpr int N = decltype(n_subs)::value;
    const Sub t0 = sub(j, 0), t1 = sub(j, N - 1);
    if (!t0.live && !(N == 2 && t1.live)) {
      // nothing of the block is kept for these rows: hand its stages back
#pragma unroll
      for (int i = 0; i < N; ++i) {
        release(empty_k, c + i);
        mbar_wait(full_v + 8 * ((c + i) % kStages), parity(c + i));
        release(empty_v, c + i);
      }
      return;
    }
    float s0[32], s1[32];  // the sub-tiles' scores, then p
    wgmma_fence();
    issue_qk<HD>(s0, q_base, kslot(c));
    if constexpr (N == 2) issue_qk<HD>(s1, q_base, kslot(c + 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s0);
    if constexpr (N == 2) fence_regs(s1);
#pragma unroll
    for (int i = 0; i < N; ++i) release(empty_k, c + i);
    float mb0 = kNegInf, mb1 = kNegInf;
    scale_mask(s0, t0, f, causal, window, prefix, scale, mb0, mb1);
    if constexpr (N == 2)
      scale_mask(s1, t1, f, causal, window, prefix, scale, mb0, mb1);
    rescale(acc, m0, m1, l0, l1, mb0, mb1);
    float ls0 = 0.f, ls1 = 0.f;
    exponentiate(s0, t0, f, causal, window, prefix, m0, m1, ls0, ls1);
    if constexpr (NA == 128) {
      mbar_wait(full_v + 8 * (c % kStages), parity(c));
      pv_256(acc, s0, vslot(c), T::kKVPanel);
    } else {
      uint32_t hi0[4][4], lo0[4][4];
      split_p(s0, hi0, lo0);
      mbar_wait(full_v + 8 * (c % kStages), parity(c));
      fence_regs(acc);
      wgmma_fence();
      issue_pv(acc, hi0, lo0, vslot(c), T::kKVPanel);
      wgmma_commit();
    }
    if constexpr (N == 2) {
      uint32_t hi1[4][4], lo1[4][4];
      exponentiate(s1, t1, f, causal, window, prefix, m0, m1, ls0, ls1);
      split_p(s1, hi1, lo1);
      mbar_wait(full_v + 8 * ((c + 1) % kStages), parity(c + 1));
      wgmma_fence();
      issue_pv(acc, hi1, lo1, vslot(c + 1), T::kKVPanel);
      wgmma_commit();
    }
    l0 = l0 + quad_sum(ls0);
    l1 = l1 + quad_sum(ls1);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < N; ++i) release(empty_v, c + i);
  };

  // A block of more sub-tiles than the registers hold scores for (up to
  // 256 keys, 4 sub-tiles, below head dim 256; 128 keys, 2, at 256), all
  // in the K ring: its max over every sub-tile first, then each sub-tile's
  // scores again for p and p V, since the block's f32 score tile beside
  // the accumulator spills. Sub-tiles the mask removes are skipped.
  auto two_pass = [&](int j, int c) {
    float s0[32];  // one sub-tile's scores, then p
    float mb0 = kNegInf, mb1 = kNegInf;
    bool any = false;
    for (int i = 0; i < nsub; ++i) {
      const Sub t = sub(j, i);
      if (!t.live) continue;
      any = true;
      wgmma_fence();
      issue_qk<HD>(s0, q_base, kslot(c + i));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s0);
      scale_mask(s0, t, f, causal, window, prefix, scale, mb0, mb1);
    }
    if (any) rescale(acc, m0, m1, l0, l1, mb0, mb1);
    float ls0 = 0.f, ls1 = 0.f;
    for (int i = 0; i < nsub; ++i) {
      const Sub t = sub(j, i);
      uint32_t hi[4][4], lo[4][4];
      if (t.live) {
        wgmma_fence();
        issue_qk<HD>(s0, q_base, kslot(c + i));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s0);
        float unused0 = kNegInf, unused1 = kNegInf;
        scale_mask(s0, t, f, causal, window, prefix, scale, unused0,
                   unused1);
        exponentiate(s0, t, f, causal, window, prefix, m0, m1, ls0, ls1);
        if constexpr (NA != 128) split_p(s0, hi, lo);
      }
      release(empty_k, c + i);
      mbar_wait(full_v + 8 * ((c + i) % kStages), parity(c + i));
      if (t.live) {
        if constexpr (NA == 128) {
          pv_256(acc, s0, vslot(c + i), T::kKVPanel);
        } else {
          fence_regs(acc);
          wgmma_fence();
          issue_pv(acc, hi, lo, vslot(c + i), T::kKVPanel);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
      }
      release(empty_v, c + i);
    }
    if (any) {
      l0 = l0 + quad_sum(ls0);
      l1 = l1 + quad_sum(ls1);
    }
  };

  int c = 0;  // sub-tiles consumed so far
  for (int j = 0; j < jb1; ++j) {
    if (keys_dead(j * BK, j * BK + BK, q0, q_last, causal, window, prefix))
      continue;
    for (int i = 0; i < nsub; ++i)
      mbar_wait(full_k + 8 * ((c + i) % kStages), parity(c + i));
    if (nsub == 1)
      in_registers(std::integral_constant<int, 1>{}, j, c);
    else if (nsub > T::kScoreTiles)
      two_pass(j, c);
    else if constexpr (T::kScoreTiles == 2)
      in_registers(std::integral_constant<int, 2>{}, j, c);
    c += nsub;
  }

  // ---- out = acc / max(l, 1e-20) in bf16; rows past S are not stored --
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  const size_t rs = (size_t)H * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * rs + (size_t)h * HD;
#pragma unroll
  for (int jj = 0; jj < NA / 4; ++jj) {
    const int col = 8 * jj + f.col0;
    if (col >= HD) continue;
    if (f.row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)f.row0 * rs + col) =
          __floats2bfloat162_rn(acc[4 * jj] / d0, acc[4 * jj + 1] / d0);
    if (f.row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)f.row1 * rs + col) =
          __floats2bfloat162_rn(acc[4 * jj + 2] / d1, acc[4 * jj + 3] / d1);
  }
  // each row's log-sum-exp, where asked for: m and l are the same on the
  // four threads of a row's quad, and its first thread writes them
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((size_t)b * H + h) * S;
    if (f.row0 < S) lb[f.row0] = row_lse(m0, l0);
    if (f.row1 < S) lb[f.row1] = row_lse(m1, l1);
  }
}

// PREFIX: the instance takes a prefix. Without one the prefix is INT_MIN,
// so every prefix term of the mask (col < prefix, max(k0, prefix)) folds
// away at compile time and the mask is the causal and window form; a
// prefix of 0 does not fold (nothing tells the compiler a key index is not
// negative) and made the prefix-free layouts slower.
template <int HD, bool PREFIX>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int B, int S, int H, int Hkv, int BK,
    int causal, int window, int prefix_len, float scale) {
  using T = Tile<HD>;
  const int prefix = PREFIX ? prefix_len : INT_MIN;
  constexpr int NP = T::NP;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + NP * T::kQPanel;
  const uint32_t sV = sK + kStages * T::kKV;
  const uint32_t bars = sQ + T::kBars;
  const uint32_t full_k = bars, empty_k = bars + 8 * kStages,
                 full_v = bars + 16 * kStages, empty_v = bars + 24 * kStages,
                 bar_q = bars + 32 * kStages;

  // the query tiles that walk the most key blocks first; heads that share
  // a KV head side by side
  const int nqt = (S + kRows - 1) / kRows;
  const int hb = (int)(blockIdx.x % (unsigned)(H * B));
  const int tile = nqt - 1 - (int)(blockIdx.x / (unsigned)(H * B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = tile * kRows;
  const int q_last = min(q0 + kRows, S) - 1;
  // the key blocks a row of this tile sees: up to the block that holds
  // q_last or the prefix's last key (causal); below that, a block the mask
  // removes for every row of the tile (older than the window, past the
  // prefix) is skipped by producer and consumers alike
  int jb1 = S / BK;
  if (causal)
    jb1 = min(jb1, (PREFIX ? max(q_last, prefix - 1) : q_last) / BK + 1);
  const int nsub = (BK + kKeys - 1) / kKeys;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kEmptyArrivals);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, kEmptyArrivals);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 2) {
    // ---- producer warpgroup: one thread issues every TMA copy ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 2 * 128) {
      mbar_expect_tx(bar_q, NP * T::kQPanel);
      for (int p = 0; p < NP; ++p)
        tma_load(sQ + p * T::kQPanel, &map_q, bar_q, p * kPanel, h, q0, b);
      int c = 0;  // sub-tiles issued so far
      for (int j = 0; j < jb1; ++j) {
        if (keys_dead(j * BK, j * BK + BK, q0, q_last, causal, window,
                      prefix))
          continue;
        for (int kv = 0; kv < 2; ++kv) {  // the block's K, then its V
          const CUtensorMap* map = kv ? &map_v : &map_k;
          const uint32_t full = kv ? full_v : full_k;
          const uint32_t empty = kv ? empty_v : empty_k;
          const uint32_t ring = kv ? sV : sK;
          for (int i = 0; i < nsub; ++i) {
            const int slot = (c + i) % kStages;
            mbar_wait(empty + 8 * slot, (((c + i) / kStages) & 1) ^ 1);
            mbar_expect_tx(full + 8 * slot, T::kKV);
            for (int p = 0; p < NP; ++p)
              tma_load(ring + slot * T::kKV + p * T::kKVPanel, map,
                       full + 8 * slot, p * kPanel, hk, j * BK + i * kKeys,
                       b);
          }
        }
        c += nsub;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<HD>(sQ, sK, sV, full_k, empty_k, full_v, empty_v, bar_q, o,
                lse, S, H, BK, causal, window, prefix, scale, h, b, q0,
                q_last, jb1, nsub);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Hkv, int blk_k, int causal, int window,
           int prefix, cudaStream_t stream) {
  // every sub-tile of a key block sits in the K ring at once
  if ((blk_k + kKeys - 1) / kKeys > Tile<HD>::kStages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mkey, mv;
  if (!encode(&mq, q, B, S, H, HD, kRows) ||
      !encode(&mkey, k, B, S, Hkv, HD, kKeys) ||
      !encode(&mv, v, B, S, Hkv, HD, kKeys))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)((S + kRows - 1) / kRows) * H * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = prefix > 0 ? flash_attention_kernel_wgmma<HD, true>
                         : flash_attention_kernel_wgmma<HD, false>;
  const uint32_t bytes = Tile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)HD));
  kern<<<(unsigned)grid, kThreads, bytes, stream>>>(
      mq, mkey, mv, (__nv_bfloat16*)o, lse, B, S, H, Hkv, blk_k, causal,
      window, prefix, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <bool TC>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int Hkv, int hd, int blk_k,
              int causal, int window, int prefix, cudaStream_t stream) {
#define FA_LAUNCH(HD)                                                      \
  return TC ? tc::launch<HD>(q, k, v, o, lse, B, S, H, Hkv, blk_k, causal, \
                             window, prefix, stream)                       \
            : launch_f32<HD>(q, k, v, o, lse, B, S, H, Hkv, blk_k, causal, \
                             window, prefix, stream)
  switch (hd) {
    case 16:
      FA_LAUNCH(16);
    case 32:
      FA_LAUNCH(32);
    case 64:
      FA_LAUNCH(64);
    case 96:
      FA_LAUNCH(96);
    case 128:
      FA_LAUNCH(128);
    case 256:
      FA_LAUNCH(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,Hkv,hd), o (B,S,H,hd), all contiguous, dtype 0 =
// f32 (CUDA cores), 1 = bf16 (tensor cores); keys walked in blocks of
// blk_k (S % blk_k == 0; at head dim 256 in bf16 at most 128, the K ring);
// every row sees the first `prefix` keys (0 <= prefix <= S). Where lse is
// not null, each row's log-sum-exp m + log(l) of its scaled scores goes to
// lse (B,H,S) f32 (+inf for a row that keeps no key): the backward's
// (flash_attention_bwd.cu) p = exp(s - lse).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int S, int H, int Hkv, int hd,
                                      int blk_k, int causal, int window,
                                      int prefix, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || blk_k < 1 ||
      blk_k > kMaxBlkK || S % blk_k != 0 || prefix < 0 || prefix > S)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<false>(q, k, v, o, (float*)lse, B, S, H, Hkv, hd, blk_k,
                            causal, window, prefix, st);
  if (dtype == 1)
    return launch_hd<true>(q, k, v, o, (float*)lse, B, S, H, Hkv, hd, blk_k,
                           causal, window, prefix, st);
  return (int)cudaErrorInvalidValue;
}
