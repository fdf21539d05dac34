// K6's backward: dq, dk and dv of flash attention (csrc/flash_attention.cu)
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its jnp attention
// (src/repro/models/layers.py attention) with XLA, and its Pallas kernel
// (src/repro/kernels/flash_attention.py:73) has no backward. It computes
// what kernels/flash_attention.py's flash_attention_bshd_bwd_ref computes,
// under K6's mask (causal & window) | (key < prefix) over grouped KV heads
// (query head h reads KV head h / (H / Hkv)), from the log-sum-exp K6
// saved for each row (lse, (B,H,S) f32; +inf where a row keeps no key):
//
//   D  = rowsum(dout * out)               (f32, (B,H,S): the pre-pass)
//   s  = q k^T scale,  p = exp(s - lse)   (0 where masked)
//   dv = p^T dout,     dp = dout v^T,     ds = (dp - D) p scale
//   dq = ds k,         dk = ds^T q
//
// Three kernels on the caller's stream:
//   flash_attention_bwd_dot   D, eight threads a row (16-byte loads), their
//                             sums combined by a fixed xor tree;
//   a dk/dv kernel            one CTA per (key tile, KV head, batch row)
//                             with its K and V tiles in shared memory; it
//                             walks the query tiles that see one of its
//                             keys (flash_attention.py's _bwd_rows), for
//                             each of the group's rep query heads in turn,
//                             and writes dk and dv once;
//   a dq kernel               one CTA per (query tile, head, batch row), the
//                             tiles that walk the most keys first, with its
//                             q and dout rows in shared memory; it walks the
//                             key tiles the mask does not remove for all its
//                             rows (keys_dead) and writes dq once.
// No float atomics: every output element is summed by one thread in a fixed
// order, so the gradient is bit for bit the same from run to run. The price
// is that s and dp are computed in both kernels: 7 products a (query, key)
// pair in place of the 5 the function needs (roofline/work.py's
// attention_bwd_flops), so the least time of this design is 1.4x the bound.
//
// Bound on this card: at musicgen-medium's training layout (B 4, S 4096,
// 24 heads of 64, causal) the 5 products are 515.5 GFLOP, 0.521 ms at the
// bf16 tensor-core rate (this design's 7: 0.73 ms); the bytes (q, k, v,
// out, dout and lse read once, dq, dk, dv written once: 0.404 GB) take
// 0.121 ms. Bound by the operations; of the CUDA-core work, one
// exponential a pair in each kernel (805 M pairs on the MUFU unit's 16 a
// clock an SM: ~0.22 ms a kernel at 1.75 GHz) is the largest part.
//
// bf16 at head dims 16, 32, 64, 96 and 128: flash_attention_bwd_dkdv_wgmma
// and flash_attention_bwd_dq_wgmma, on wgmma with TMA-fed rings
// (csrc/hopper.cuh, the forward's machinery). Each CTA has three
// warpgroups: warpgroup 2 gives up its registers (setmaxnreg 24) and loads,
// warpgroups 0 and 1 (setmaxnreg 240) own 64 rows each of the CTA's 128.
// A streamed tile has SUB rows: 128 where the registers allow, 64 where
// they do not (Shape::kSubKV, kSubQ); its ring has 4 stages.
//   dk/dv: 128 keys a CTA, K and V loaded once by TMA. Query tiles of SUB
//          rows (128 up to head dim 64, 64 at 96 and 128) stream through
//          the ring: the q and dout tiles by TMA, each row's lse and D by
//          the loading warp's 32 lanes with cp.async, each stage's full
//          barrier completing on the copies' bytes and the lanes'
//          arrivals. Per tile, a warpgroup's 64 keys:
//            s^T  = K q^T        wgmma SS m64nSUBk16 (K and q K-major);
//            dp^T = V dout^T     SS, issued behind s^T;
//            p^T  = 2^(s^T scale log2 e - lse log2 e), masked, while dp^T
//                   runs;
//            ds^T = p^T (dp^T - D);
//            dv  += p^T dout     wgmma RS m64nNk16: A = p^T rounded to
//                                bf16 from the accumulator's registers, B
//                                the dout tile in its (row, hd) layout,
//                                MN-major (the transpose bit);
//            dk  += ds^T q       RS, B the q tile, MN-major.
//          Both products wait for ds^T, so that s^T and dp^T are free
//          before p^T's and ds^T's fragments exist (issuing dv's before
//          ds^T is formed read slower); dv's runs while ds^T's fragments
//          are formed. dk x scale and dv are written once, in bf16.
//   dq:    128 query rows a CTA, q and dout loaded once by TMA, each
//          thread's two rows' lse and D in registers; K and V sub-tiles of
//          SUB keys (128 at head dim 64, 64 otherwise) stream through two
//          rings, skipping the sub-tiles the mask removes for every row.
//          Per sub-tile, a warpgroup's 64 rows: s = q K^T and dp = dout V^T
//          (SS, the second behind the first), p while dp runs, ds = p (dp -
//          D), dq += ds K (RS, K MN-major); dq x scale is written once.
// At musicgen-medium's layout a call with both kernels' score products at
// N = 128 takes 0.83x the time of one at N = 64 (scripts/k6_bwd_probe.py
// --variants); issuing the next tile's products before the current
// tile's last one is waited for, keeping the score products' A operand
// in registers, and dv's product before ds^T is formed, read slower or
// no faster. N of the RS
// products is 64 up to head dim 64 and 128 above: head dims 16 and 32
// fill their one 64-column panel with zeros past hd and 96 its second (the
// TMA boxes are 64 columns of one head), and those columns come out zero
// and are not stored. A key range (or query tile) the mask removes for all
// of a warpgroup's rows is skipped by that warpgroup; one it keeps whole
// skips the mask. In the dq kernel, rows past S read zeros and an lse of
// +inf (p = 0) and keys past S read zeros and are masked; in the dk/dv
// kernel, rows past S read zeros for q, dout, lse and D (p^T = 1, ds^T =
// 0: nothing added) and keys past S are not stored. p and ds are rounded
// to bf16 as product operands (each once, as the forward's tensor-core
// products do with q and k); every sum is f32; the exponential is
// ex2.approx (2 ulp) of s scale log2 e - lse log2 e, that argument one
// fused multiply-add up to head dim 64, below p's bf16 rounding.
//
// bf16 at head dim 256: flash_attention_bwd_dkdv and flash_attention_bwd_dq
// on mma.sync m16n8k16 from ldmatrix (a 64-key dk/dv tile's dk and dv
// alone would take 256 registers a thread at M = 64 on wgmma): 8 warps, two
// to each 16 keys, each summing dk and dv for half the columns, over query
// tiles of 32 rows staged by cp.async in two stages; the dq kernel walks
// key tiles of 32.
//
// f32: on the CUDA cores in f32 (the tensor cores would take f32 only as
// TF32), in the same two-kernel structure: CTAs of 256 threads over tiles
// of 32 keys and 32 query rows staged in shared memory (rows padded to
// hd + 1 floats), s and dp a 4-element register tile per thread, p and ds
// through shared memory, dk, dv or dq rows accumulated in registers; exp
// as expf.
//
// Built with --fmad=false, as the forward: the products' sums run in
// another order than the plain version's matmuls.
//
// ptxas (-Xptxas -v, sm_90a; CUDA 12.8), registers a thread and dynamic
// shared memory a CTA at head dims 16 / 32 / 64 / 96 / 128 / 256:
//   dkdv_wgmma  168 at launch (384 threads), then 240 a consumer thread and
//               24 a loading one (setmaxnreg); 169,096 / 169,096 /
//               169,096 / 199,816 / 199,816 B
//   dq_wgmma    the same registers; 101,512 / 101,512 / 169,096 / 199,816
//               / 199,816 B
//   dkdv, dq    (mma.sync, head dim 256) 250 and 243; 135,680 and 135,168 B
//   dkdv f32    32 / 40 / 64 / 64 / 80 / 128;  dq f32  48 / 48 / 64 / 64 /
//               80 / 80; both 17,408 / 25,600 / 41,984 / 58,368 / 74,752 /
//               140,288 B
//   dot         30 (f32) / 32 (bf16), no shared memory
// Nothing spills but the f32 dq kernel at head dim 32 (8 bytes of stack).
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mask.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxSmem = 232448;
constexpr int kKeyTile = 64;   // keys per dk/dv CTA (bf16, head dim 256)
constexpr int kRowTile = 64;   // query rows per dq CTA (bf16, head dim 256)
constexpr int kPad = 8;        // bf16 elements of padding per shared row
constexpr int kDotThreads = 8; // threads per row of the pre-pass
constexpr int kF32Tile = 32;   // keys and query rows per f32 tile
constexpr int kF32Threads = 256;

typedef __nv_bfloat16 bf16;

using tc::pack_bf16;
using tc::smem_u32;

// 16 bytes global -> shared, zeros where !ok (nothing is read then)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zeros where !ok
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N committed groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// R rows [r0, r0 + R) of a (B,S,heads,HD) bf16 tensor (base: its batch
// row's and head's first element; row stride `stride` elements) into
// shared memory at dst, rows of HD + kPad elements; rows past S are zeros
template <int HD, int R, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* base,
                                          size_t stride, int r0, int S,
                                          int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
#pragma unroll 2
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S;
    cp16(dst + (uint32_t)(r * (HD + kPad) + c * 8) * 2,
         base + (size_t)(ok ? r0 + r : 0) * stride + c * 8, ok);
  }
}

// acc (16 x 8 NT) = A . B^T: A the 16 rows at sA, B the 8 NT rows at sB,
// both K-major (HD contiguous bf16 columns, rows of HD + kPad), over HD
template <int HD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], uint32_t sA,
                                        uint32_t sB, int lane) {
  constexpr int LD = HD + kPad;
  static_assert(NT % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sA + (uint32_t)((lane % 16) * LD + kk * 16 + (lane / 16) * 8)
                        * 2);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      ldsm_x4(b, sB + (uint32_t)((j * 16 + lane % 8 + (lane / 16) * 8) * LD +
                                 kk * 16 + ((lane / 8) % 2) * 8) * 2);
      mma16816(acc[2 * j], a, b[0], b[1]);
      mma16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8 NC) += P . B: P as KS k-steps of bf16 A fragments, B the
// 16 KS rows at sB in its (k, n) layout (n contiguous, rows of LD), its
// columns from sB's first on (transposed by ldmatrix)
template <int KS, int NC, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[NC][4],
                                       const uint32_t (&p)[KS][4],
                                       uint32_t sB, int lane) {
  static_assert(NC % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) {
      uint32_t b[4];
      ldsm_x4_t(b, sB + (uint32_t)((kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * LD + j * 16 + (lane / 16) * 8) * 2);
      mma16816(acc[2 * j], p[kk], b[0], b[1]);
      mma16816(acc[2 * j + 1], p[kk], b[2], b[3]);
    }
}

// an accumulator (16 x 8 NT, f32) as the A fragments of NT / 2 k-steps:
// k-step kk takes n-tiles 2 kk and 2 kk + 1, each element rounded to bf16
template <int NT>
__device__ __forceinline__ void to_a(const float (&c)[NT][4],
                                     uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// the query rows [r0, r1) that see a key of [c0, c1) (flash_attention.py's
// _bwd_rows)
__device__ __forceinline__ void bwd_rows(int c0, int c1, int S, int causal,
                                         int window, int prefix, int& r0,
                                         int& r1) {
  r0 = 0;
  r1 = S;
  if (c0 < prefix) return;
  if (causal) r0 = c0;
  if (window > 0) r1 = min(S, c1 - 1 + window);
}

// ---------------------------------------------------------------------------
// the pre-pass: D = rowsum(dout * out) in f32
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add_chunk(float& s, const float* a,
                                          const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  s = s + x.x * y.x;
  s = s + x.y * y.y;
  s = s + x.z * y.z;
  s = s + x.w * y.w;
}

__device__ __forceinline__ void add_chunk(float& s, const bf16* a,
                                          const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xs[i]);
    const float2 w = __bfloat1622float2(ys[i]);
    s = s + u.x * w.x;
    s = s + u.y * w.y;
  }
}

// one row (b, s, h) per kDotThreads threads; each sums its 16-byte chunks
// of the row in order, then the threads' sums combine by an xor tree
template <typename T>
__global__ void __launch_bounds__(256) flash_attention_bwd_dot(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ D, int rows, int S, int H, int hd) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = i / kDotThreads;
  const int sub = (int)(i % kDotThreads);
  constexpr int kPer = 16 / sizeof(T);  // elements of a chunk
  float s = 0.f;
  if (row < rows) {
    const T* a = dout + row * hd;
    const T* b = out + row * hd;
    for (int c = sub * kPer; c < hd; c += kDotThreads * kPer)
      add_chunk(s, a + c, b + c);
  }
#pragma unroll
  for (int m = kDotThreads / 2; m > 0; m >>= 1)
    s += __shfl_xor_sync(FULL_MASK, s, m);
  if (row < rows && sub == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;  // b S + s
    const long long b = bs / S;
    D[(b * H + h) * S + bs % S] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dim 256: dk and dv on mma.sync
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  int B, S, H, Hkv, causal, window, prefix;
  float scale;
};

template <int HD, int BR, int NSPLIT>
struct Dkdv {
  static constexpr int LD = HD + kPad;
  static constexpr int kWarps = 4 * NSPLIT;  // 4 groups of 16 keys
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = HD / NSPLIT;  // dk / dv columns of a warp
  static constexpr uint32_t kKV = kKeyTile * LD * 2;  // a K or V tile
  static constexpr uint32_t kQ = BR * LD * 2;         // a q or dout tile
  // K, V; two stages of (q, dout); two stages of lse, then of D
  static constexpr uint32_t kSmem = 2 * kKV + 4 * kQ + 4 * BR * 4;
  static_assert(kSmem <= (uint32_t)kMaxSmem, "shared memory");
};

template <int HD, int BR, int NSPLIT>
__global__ void __launch_bounds__(Dkdv<HD, BR, NSPLIT>::kThreads)
    flash_attention_bwd_dkdv(BwdArgs a) {
  using T = Dkdv<HD, BR, NSPLIT>;
  constexpr int LD = T::LD;
  constexpr int NT = BR / 8;           // n-tiles of s^T over the queries
  constexpr int NC = T::kCols / 8;     // n-tiles of dk / dv
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sK = smem_u32(smem), sV = sK + T::kKV;
  const uint32_t sQ = sV + T::kKV;  // stage st: q at sQ + 2 st kQ, dout kQ on
  float* sL = reinterpret_cast<float*>(smem + 2 * T::kKV + 4 * T::kQ);
  const uint32_t sL_u = smem_u32(sL);  // lse [2][BR], then D [2][BR]

  const int S = a.S, H = a.H, Hkv = a.Hkv;
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale = a.scale;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kg = warp % 4, cg = warp / 4;
  const int kt = (int)(blockIdx.x / (unsigned)(Hkv * a.B));
  const int hb = (int)(blockIdx.x % (unsigned)(Hkv * a.B));
  const int hk = hb % Hkv, b = hb / Hkv;
  const int rep = H / Hkv;
  const int c0 = kt * kKeyTile;

  int r0, r1;
  bwd_rows(c0, c0 + kKeyTile, S, causal, window, prefix, r0, r1);
  const int qt0 = r0 / BR;
  const int nqt = r0 < r1 ? (r1 + BR - 1) / BR - qt0 : 0;
  const int n_it = rep * nqt;

  const size_t rowq = (size_t)H * HD, rowk = (size_t)Hkv * HD;
  const bf16* q = (const bf16*)a.q + (size_t)b * S * rowq;
  const bf16* dout = (const bf16*)a.dout + (size_t)b * S * rowq;
  load_rows<HD, kKeyTile, T::kThreads>(
      sK, (const bf16*)a.k + (size_t)b * S * rowk + (size_t)hk * HD, rowk, c0,
      S, tid);
  load_rows<HD, kKeyTile, T::kThreads>(
      sV, (const bf16*)a.v + (size_t)b * S * rowk + (size_t)hk * HD, rowk, c0,
      S, tid);
  // iteration `it`: query head hk rep + it / nqt, query tile qt0 + it % nqt
  auto issue = [&](int it) {
    const int h = hk * rep + it / nqt;
    const int q0 = (qt0 + it % nqt) * BR;
    const int st = it & 1;
    load_rows<HD, BR, T::kThreads>(sQ + 2 * st * T::kQ, q + (size_t)h * HD,
                                   rowq, q0, S, tid);
    load_rows<HD, BR, T::kThreads>(sQ + (2 * st + 1) * T::kQ,
                                   dout + (size_t)h * HD, rowq, q0, S, tid);
    const size_t lrow = ((size_t)b * H + h) * S;
    for (int i = tid; i < 2 * BR; i += T::kThreads) {
      const int r = i % BR, isD = i / BR;
      const bool ok = q0 + r < S;
      cp4(sL_u + (uint32_t)((2 * isD + st) * BR + r) * 4,
          (isD ? a.D : a.lse) + lrow + (ok ? q0 + r : 0), ok);
    }
  };

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int g = lane / 4, t4 = lane % 4;
  const int key0 = c0 + kg * 16 + g;  // this thread's keys: key0, key0 + 8
  const uint32_t tK = sK + (uint32_t)(kg * 16 * LD) * 2;
  const uint32_t tV = sV + (uint32_t)(kg * 16 * LD) * 2;
  if (n_it > 0) issue(0);
  cp_commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const int q0 = (qt0 + it % nqt) * BR;
    const uint32_t tQ = sQ + 2 * st * T::kQ, tO = tQ + T::kQ;
    const float* tl = sL + st * BR;
    const float* td = sL + (2 + st) * BR;
    const bool whole = c0 + kKeyTile <= S && q0 + BR <= S &&
                       keys_whole(c0, c0 + kKeyTile, q0, q0 + BR - 1, causal,
                                  window, prefix);
    // p^T = exp(k q^T scale - lse), 0 where masked
    float p[NT][4];
    mma_abt<HD, NT>(p, tK, tQ, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        const int key = key0 + (e & 2 ? 8 : 0);
        const float x = expf(p[j][e] * scale - tl[col]);
        const bool kept = whole || (key < S && q0 + col < S &&
                                    keep(q0 + col, key, causal, window,
                                         prefix));
        p[j][e] = kept ? x : 0.f;
      }
    uint32_t fa[NT / 2][4];
    to_a(p, fa);
    // dv += p^T dout (this warp's columns)
    mma_ab<NT / 2, NC, LD>(dv, fa, tO + (uint32_t)(cg * T::kCols) * 2, lane);
    // ds^T = (v dout^T - D) p scale
    float ds[NT][4];
    mma_abt<HD, NT>(ds, tV, tO, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        ds[j][e] = (ds[j][e] - td[col]) * p[j][e] * scale;
      }
    to_a(ds, fa);
    // dk += ds^T q
    mma_ab<NT / 2, NC, LD>(dk, fa, tQ + (uint32_t)(cg * T::kCols) * 2, lane);
    __syncthreads();
  }
  cp_wait<0>();

  bf16* dkb = (bf16*)a.dk + (size_t)b * S * rowk + (size_t)hk * HD;
  bf16* dvb = (bf16*)a.dv + (size_t)b * S * rowk + (size_t)hk * HD;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = cg * T::kCols + j * 8 + 2 * t4;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + 8 * hf;
      if (key >= S) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key * rowk + col) =
          __floats2bfloat162_rn(dk[j][2 * hf], dk[j][2 * hf + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key * rowk + col) =
          __floats2bfloat162_rn(dv[j][2 * hf], dv[j][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dim 256: dq on mma.sync
// ---------------------------------------------------------------------------

template <int HD, int BC>
struct Dq {
  static constexpr int LD = HD + kPad;
  static constexpr int kThreads = 128;  // 4 warps of 16 query rows
  static constexpr uint32_t kQ = kRowTile * LD * 2;  // the q or dout rows
  static constexpr uint32_t kKV = BC * LD * 2;       // a K or V tile
  // q, dout; two stages of (K, V)
  static constexpr uint32_t kSmem = 2 * kQ + 4 * kKV;
  static_assert(kSmem <= (uint32_t)kMaxSmem, "shared memory");
};

template <int HD, int BC>
__global__ void __launch_bounds__(Dq<HD, BC>::kThreads)
    flash_attention_bwd_dq(BwdArgs a) {
  using T = Dq<HD, BC>;
  constexpr int LD = T::LD;
  constexpr int NT = BC / 8;   // n-tiles of s over the keys
  constexpr int NC = HD / 8;   // n-tiles of dq
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem), sO = sQ + T::kQ;
  const uint32_t sKV = sO + T::kQ;  // stage st: K at sKV + 2 st kKV, V kKV on

  const int S = a.S, H = a.H, Hkv = a.Hkv;
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale = a.scale;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the query tiles that walk the most key tiles first
  const int nqt = (S + kRowTile - 1) / kRowTile;
  const int hb = (int)(blockIdx.x % (unsigned)(H * a.B));
  const int qt = nqt - 1 - (int)(blockIdx.x / (unsigned)(H * a.B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kRowTile;
  const int q_last = min(q0 + kRowTile, S) - 1;

  const size_t rowq = (size_t)H * HD, rowk = (size_t)Hkv * HD;
  load_rows<HD, kRowTile, T::kThreads>(
      sQ, (const bf16*)a.q + (size_t)b * S * rowq + (size_t)h * HD, rowq, q0,
      S, tid);
  load_rows<HD, kRowTile, T::kThreads>(
      sO, (const bf16*)a.dout + (size_t)b * S * rowq + (size_t)h * HD, rowq,
      q0, S, tid);
  const bf16* kb = (const bf16*)a.k + (size_t)b * S * rowk + (size_t)hk * HD;
  const bf16* vb = (const bf16*)a.v + (size_t)b * S * rowk + (size_t)hk * HD;
  const int nkt = (S + BC - 1) / BC;
  const int jend =
      causal ? min(nkt, max(q_last, prefix - 1) / BC + 1) : nkt;
  auto live_from = [&](int j) {  // the first key tile >= j not removed
    while (j < jend && keys_dead(j * BC, j * BC + BC, q0, q_last, causal,
                                 window, prefix))
      ++j;
    return j;
  };
  auto issue = [&](int j, int st) {
    load_rows<HD, BC, T::kThreads>(sKV + 2 * st * T::kKV, kb, rowk, j * BC, S,
                                   tid);
    load_rows<HD, BC, T::kThreads>(sKV + (2 * st + 1) * T::kKV, vb, rowk,
                                   j * BC, S, tid);
  };

  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float lse_r[2], D_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    const size_t at = ((size_t)b * H + h) * S + r;
    lse_r[hf] = r < S ? a.lse[at] : INFINITY;
    D_r[hf] = r < S ? a.D[at] : 0.f;
  }
  float dq[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const uint32_t tQ = sQ + (uint32_t)(warp * 16 * LD) * 2;
  const uint32_t tO = sO + (uint32_t)(warp * 16 * LD) * 2;

  int j = live_from(0);
  if (j < jend) issue(j, 0);
  cp_commit();
  for (int n = 0; j < jend; ++n) {
    const int jn = live_from(j + 1);
    if (jn < jend) issue(jn, (n + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = n & 1;
    const uint32_t tK = sKV + 2 * st * T::kKV, tV = tK + T::kKV;
    const int k0 = j * BC;
    const bool whole = k0 + BC <= S && q0 + kRowTile <= S &&
                       keys_whole(k0, k0 + BC, q0, q0 + kRowTile - 1, causal,
                                  window, prefix);
    // p = exp(q k^T scale - lse), 0 where masked
    float p[NT][4];
    mma_abt<HD, NT>(p, tQ, tK, lane);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int row = row0 + 8 * hf;
        const int key = k0 + jj * 8 + 2 * t4 + (e & 1);
        const float x = expf(p[jj][e] * scale - lse_r[hf]);
        const bool kept = whole || (key < S && row < S &&
                                    keep(row, key, causal, window, prefix));
        p[jj][e] = kept ? x : 0.f;
      }
    // ds = (dout v^T - D) p scale
    float ds[NT][4];
    mma_abt<HD, NT>(ds, tO, tV, lane);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[jj][e] = (ds[jj][e] - D_r[e >> 1]) * p[jj][e] * scale;
    uint32_t fa[NT / 2][4];
    to_a(ds, fa);
    // dq += ds k
    mma_ab<NT / 2, NC, LD>(dq, fa, tK, lane);
    __syncthreads();
    j = jn;
  }
  cp_wait<0>();

  bf16* dqb = (bf16*)a.dq + (size_t)b * S * rowq + (size_t)h * HD;
#pragma unroll
  for (int jj = 0; jj < NC; ++jj) {
    const int col = jj * 8 + 2 * t4;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 8 * hf;
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row * rowq + col) =
            __floats2bfloat162_rn(dq[jj][2 * hf], dq[jj][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dims 16-128: wgmma, TMA-fed rings
// ---------------------------------------------------------------------------

namespace wg {

using tc::kPanel;
constexpr int kThreads = 384;      // warpgroups 0-1 consume, 2 loads
constexpr int kTile = 128;         // a CTA's keys (dk/dv) or query rows (dq)
constexpr int kEmptyArrivals = 8;  // one per consumer warp
// dk/dv: a stage's full barrier takes the loading warp's 32 cp.async
// arrivals (lse, D) and lane 0's arrival with the TMA copies' bytes
constexpr int kFullArrivals = 33;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Shape {
  // 64-column panels (head dim 96 pads to two, 16 and 32 fill one)
  static constexpr int NP = (HD + kPanel - 1) / kPanel;
  static constexpr int NA = NP * kPanel / 2;  // dk, dv or dq floats a thread
  // rows of a streamed tile: query rows a dk/dv stage, keys a dq stage.
  // 128 where the registers allow, so that the score products run at
  // N = 128 (64 f32 accumulators a thread each for s and dp; with both
  // kernels' at N = 64 a call took 1.2x the time at head dim 64,
  // scripts/k6_bwd_probe.py --variants); 64 where dk and dv take 64
  // accumulators a thread each (head dims 96 and 128), and in the dq
  // kernel at every head dim but 64, where ptxas spilled the 128-key form
  static constexpr int kSubKV = NP == 1 ? 128 : 64;
  static constexpr int kSubQ = HD == 64 ? 128 : 64;
  // the exponent's argument s scale log2 e - lse log2 e by one fused
  // multiply-add up to head dim 64; a multiply and a subtract above, where
  // the fused form read slower (scripts/k6_bwd_probe.py --variants)
  static constexpr bool kFma = NP == 1;
};

// shared memory of a kernel whose resident tiles have kTile rows and whose
// streamed tiles SUB: two resident tiles (K and V, or q and dout), two
// rings of kStages streamed tiles (q and dout, or K and V; 8 or 16 KB
// each), each 64-column panel 1024-byte aligned; the dk/dv kernel's lse
// and D (SUB f32 each a stage); the barriers
template <int HD, int SUB>
struct Smem {
  static constexpr int NP = Shape<HD>::NP;
  static constexpr int kStages = 4;
  static constexpr uint32_t kTilePanel = kTile * 128;  // resident: a panel
  static constexpr uint32_t kSubPanel = SUB * 128;     // streamed: a panel
  static constexpr uint32_t kResident = NP * kTilePanel;
  static constexpr uint32_t kStream = NP * kSubPanel;
  static constexpr uint32_t kTiles = 2 * kResident + 2 * kStages * kStream;
  static constexpr uint32_t kBars = kTiles + 2 * kStages * SUB * 4;
  // + 1024 to align the base; barriers: full and empty rings (two of each
  // in the dq kernel), then the resident tiles'
  static constexpr uint32_t kSmem = 1024 + kBars + 8 * (4 * kStages + 1);
  static_assert(kSmem <= (uint32_t)kMaxSmem, "shared memory");
};

// 2^x, one MUFU instruction (2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p = 2^(s c2 - l): the score s times c2 = scale log2 e, less the row's
// lse log2 e
template <bool FMA>
__device__ __forceinline__ float p_of(float s, float c2, float l) {
  return ex2(FMA ? __fmaf_rn(s, c2, -l) : s * c2 - l);
}

// d (64 x N, f32) = A . B^T over hd: A 64 rows, B N rows of hd bf16
// columns in shared memory (K-major, 128-byte swizzle), their 64-column
// panels a_panel and b_panel bytes apart; hd / 16 k-steps
template <int HD, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t a_panel, uint32_t b,
                                         uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = tc::sw128_desc(a + (kk / 4) * a_panel + off, 16, 1024);
    const uint64_t db = tc::sw128_desc(b + (kk / 4) * b_panel + off, 16, 1024);
    if constexpr (N == 128) {
      if (kk == 0)
        tc::wgmma_ss_n128<false>(d, da, db);
      else
        tc::wgmma_ss_n128<true>(d, da, db);
    } else {
      if (kk == 0)
        tc::wgmma_ss_n64_first(d, da, db);
      else
        tc::wgmma_ss_n64_acc(d, da, db);
    }
  }
}

// acc (64 x 2 NA, f32) += A . B: A (64 x 16 KS) as KS k-steps of bf16
// fragments, B 16 KS rows of a streamed tile at b in its (row, hd)
// layout, which is MN-major (the transpose bit); its second 64-column panel
// (b_panel bytes on) the leading-byte-offset step, its 8-row groups the
// stride-byte-offset step
template <int NA, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[NA],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t b, uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = tc::sw128_desc(b + kk * 16 * 128, b_panel, 1024);
    if constexpr (NA == 64)
      tc::wgmma_rs_n128<0>(acc, a[kk], db);
    else
      tc::wgmma_rs_n64(acc, a[kk], db);
  }
}

// a 64 x 8 KS f32 accumulator as the bf16 A fragments of KS k-steps: the
// accumulator's (row, 2 columns) pairs are the A fragment's, k-step kk
// takes column groups 2 kk and 2 kk + 1
template <int KS>
__device__ __forceinline__ void to_frags(const float (&s)[4 * KS],
                                         uint32_t (&a)[KS / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < KS / 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      a[kk][r] = tc::pack_bf16(s[e], s[e + 1]);
    }
}

template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) tc::fence_regs(a[kk]);
}

// a 64 x 2 NA accumulator (rows row0 and row0 + 8 of this thread, column
// pairs 8 j + col0) times `mul`, in bf16 into the rows below S of a
// (B,S,heads,HD) tensor at `base` (row stride `stride`); columns past HD
// (a padded panel's) are not stored
template <int HD, int NA>
__device__ __forceinline__ void store_rows(const float (&acc)[NA], bf16* base,
                                           size_t stride, int row0, int col0,
                                           int S, float mul) {
#pragma unroll
  for (int jj = 0; jj < NA / 4; ++jj) {
    const int col = 8 * jj + col0;
    if (col >= HD) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row0 * stride + col) =
          __floats2bfloat162_rn(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
    if (row0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(row0 + 8) * stride +
                                         col) =
          __floats2bfloat162_rn(acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
  }
}

// dk and dv of 128 keys (a KV head's, a batch row's): warpgroups 0 and 1
// own 64 keys each, with K and V resident; warpgroup 2 streams the query
// tiles of SUB rows that see one of the keys, for each of the group's rep
// query heads in turn, through a ring of kStages (q, dout, lse, D) stages
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_do, BwdArgs a, float c2) {
  constexpr int SUB = Shape<HD>::kSubKV;
  using T = Smem<HD, SUB>;
  constexpr int NP = T::NP, NA = Shape<HD>::NA, kStages = T::kStages;
  constexpr int NS = SUB / 2;  // s^T and dp^T floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + T::kResident;
  // stage st: q at ring + 2 st kStream, dout kStream on; its lse at sL +
  // st SUB, its D at sL + (kStages + st) SUB (f32)
  const uint32_t ring = base + 2 * T::kResident;
  const uint32_t sL_u = base + T::kTiles;
  const float* const sL =
      reinterpret_cast<const float*>(smem_raw + (sL_u - raw));
  const uint32_t bars = base + T::kBars;
  const uint32_t full = bars, empty = bars + 8 * kStages,
                 bar_kv = bars + 16 * kStages;

  const int S = a.S, H = a.H, Hkv = a.Hkv;
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const int kt = (int)(blockIdx.x / (unsigned)(Hkv * a.B));
  const int hb = (int)(blockIdx.x % (unsigned)(Hkv * a.B));
  const int hk = hb % Hkv, b = hb / Hkv;
  const int rep = H / Hkv;
  const int c0 = kt * kTile;
  int r0, r1;
  bwd_rows(c0, c0 + kTile, S, causal, window, prefix, r0, r1);
  const int qt0 = r0 / SUB;
  const int nqt = r0 < r1 ? (r1 + SUB - 1) / SUB - qt0 : 0;
  const int n_it = rep * nqt;  // it: head hk rep + it / nqt, tile it % nqt

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full + 8 * s, kFullArrivals);
      tc::mbar_init(empty + 8 * s, kEmptyArrivals);
    }
    tc::mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tc::warpgroup() == 2) {
    // ---- producer: one warp. Lane 0 issues every TMA copy; the 32 lanes
    // copy each stage's lse and D by cp.async (zeros past S: there q and
    // dout are zeros, so p^T = 1 and ds^T = 0 add nothing), each lane's
    // copies arriving on the stage's full barrier when they land --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 2 * 128 + 32) return;
    const int lane = tid % 32;
    if (lane == 0) {
      tc::mbar_expect_tx(bar_kv, 2 * T::kResident);
      for (int p = 0; p < NP; ++p) {
        tc::tma_load(sK + p * T::kTilePanel, &map_k, bar_kv, p * kPanel, hk,
                     c0, b);
        tc::tma_load(sV + p * T::kTilePanel, &map_v, bar_kv, p * kPanel, hk,
                     c0, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      tc::mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
      const int h = hk * rep + it / nqt;
      const int q0 = (qt0 + it % nqt) * SUB;
      const size_t lrow = ((size_t)b * H + h) * S;
      const uint32_t f = full + 8 * st;
#pragma unroll
      for (int r = lane; r < SUB; r += 32) {
        const bool ok = q0 + r < S;
        const size_t at = lrow + (ok ? q0 + r : 0);
        cp4(sL_u + (st * SUB + r) * 4, a.lse + at, ok);
        cp4(sL_u + ((kStages + st) * SUB + r) * 4, a.D + at, ok);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   ::"r"(f)
                   : "memory");
      if (lane == 0) {
        tc::mbar_expect_tx(f, 2 * T::kStream);
        const uint32_t tq = ring + 2 * st * T::kStream;
        for (int p = 0; p < NP; ++p) {
          tc::tma_load(tq + p * T::kSubPanel, &map_q, f, p * kPanel, h, q0, b);
          tc::tma_load(tq + T::kStream + p * T::kSubPanel, &map_do, f,
                       p * kPanel, h, q0, b);
        }
      }
    }
    cp_wait<0>();
    return;
  }

  // ---- consumers: 64 keys each ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = tc::warpgroup();
  const int w = (tid / 32) % 4, lane = tid % 32;
  const int row0 = 16 * w + lane / 4;  // fragment rows row0, row0 + 8: keys
  const int col0 = 2 * (lane % 4);     // columns 8 j + col0 (+1): queries
  const int kb = c0 + 64 * g;          // this warpgroup's first key
  const uint32_t kA = sK + g * 64 * 128, vA = sV + g * 64 * 128;
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;

  tc::mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    tc::mbar_wait(full + 8 * st, (it / kStages) & 1);
    const int q0 = (qt0 + it % nqt) * SUB;
    const bool live =
        kb < S && !keys_dead(kb, kb + 64, q0, q0 + SUB - 1, causal, window,
                             prefix);
    if (live) {
      const bool whole =
          keys_whole(kb, kb + 64, q0, q0 + SUB - 1, causal, window, prefix);
      const uint32_t tq = ring + 2 * st * T::kStream, tdo = tq + T::kStream;
      const float* tl = sL + st * SUB;
      const float* td = sL + (kStages + st) * SUB;
      float s[NS], dp[NS];  // s^T = K q^T, then p^T; dp^T = V dout^T, then ds^T
      uint32_t pa[SUB / 16][4], da[SUB / 16][4];  // p^T, ds^T: A fragments
      tc::wgmma_fence();
      issue_ss<HD, SUB>(s, kA, T::kTilePanel, tq, T::kSubPanel);
      tc::wgmma_commit();
      issue_ss<HD, SUB>(dp, vA, T::kTilePanel, tdo, T::kSubPanel);
      tc::wgmma_commit();
      tc::wgmma_wait<1>();
      tc::fence_regs(s);
      // p^T = 2^(s^T scale log2 e - lse log2 e), 0 where masked (while
      // dp^T runs)
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(tl + 8 * j + col0);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e)
          s[e] = p_of<Shape<HD>::kFma>(s[e], c2, (e & 1) ? l1 : l0);
      }
      if (!whole) {
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int key = kb + row0 + ((e & 2) ? 8 : 0);
          const int row = q0 + 8 * (e / 4) + col0 + (e & 1);
          s[e] = keep(row, key, causal, window, prefix) ? s[e] : 0.f;
        }
      }
      tc::wgmma_wait<0>();
      tc::fence_regs(dp);
      // ds^T = p^T (dp^T - D); the scale goes on dk at the end
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(td + 8 * j + col0);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e)
          dp[e] = (dp[e] - ((e & 1) ? d.y : d.x)) * s[e];
      }
      // dv += p^T dout once p^T is fragments (s^T's registers then free),
      // running while ds^T's fragments are formed; then dk += ds^T q
      to_frags<SUB / 8>(s, pa);
      tc::fence_regs(dv);
      tc::wgmma_fence();
      issue_rs(dv, pa, tdo, T::kSubPanel);
      tc::wgmma_commit();
      to_frags<SUB / 8>(dp, da);
      tc::fence_regs(dk);
      tc::wgmma_fence();
      issue_rs(dk, da, tq, T::kSubPanel);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dk);
      tc::fence_regs(dv);
      fence_frags(pa);
      fence_frags(da);
    }
    if (lane == 0) tc::mbar_arrive(empty + 8 * st);
  }

  const size_t rowk = (size_t)Hkv * HD;
  const size_t off = (size_t)b * S * rowk + (size_t)hk * HD;
  store_rows<HD>(dk, (bf16*)a.dk + off, rowk, kb + row0, col0, S, a.scale);
  store_rows<HD>(dv, (bf16*)a.dv + off, rowk, kb + row0, col0, S, 1.f);
}

// dq of 128 query rows (a head's, a batch row's): warpgroups 0 and 1 own
// 64 rows each, with q, dout, lse and D resident; warpgroup 2 streams K and
// V in sub-tiles of SUB keys through two rings of kStages, skipping those
// the mask removes for every row of the tile
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, BwdArgs a, float c2) {
  constexpr int SUB = Shape<HD>::kSubQ;
  using T = Smem<HD, SUB>;
  constexpr int NP = T::NP, NA = Shape<HD>::NA, kStages = T::kStages;
  constexpr int NS = SUB / 2;  // s and dp floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sO = base + T::kResident;
  const uint32_t sK = base + 2 * T::kResident;
  const uint32_t sV = sK + kStages * T::kStream;
  const uint32_t bars = base + T::kBars;
  const uint32_t full_k = bars, empty_k = bars + 8 * kStages,
                 full_v = bars + 16 * kStages, empty_v = bars + 24 * kStages,
                 bar_q = bars + 32 * kStages;

  const int S = a.S, H = a.H, Hkv = a.Hkv;
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  // the query tiles that walk the most key tiles first
  const int nqt = (S + kTile - 1) / kTile;
  const int hb = (int)(blockIdx.x % (unsigned)(H * a.B));
  const int qt = nqt - 1 - (int)(blockIdx.x / (unsigned)(H * a.B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;
  const int q_last = min(q0 + kTile, S) - 1;
  const int nkt = (S + SUB - 1) / SUB;
  const int jend = causal ? min(nkt, max(q_last, prefix - 1) / SUB + 1) : nkt;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full_k + 8 * s, 1);
      tc::mbar_init(empty_k + 8 * s, kEmptyArrivals);
      tc::mbar_init(full_v + 8 * s, 1);
      tc::mbar_init(empty_v + 8 * s, kEmptyArrivals);
    }
    tc::mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tc::warpgroup() == 2) {
    // ---- producer: one thread issues every TMA copy ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != 2 * 128) return;
    tc::mbar_expect_tx(bar_q, 2 * T::kResident);
    for (int p = 0; p < NP; ++p) {
      tc::tma_load(sQ + p * T::kTilePanel, &map_q, bar_q, p * kPanel, h, q0,
                   b);
      tc::tma_load(sO + p * T::kTilePanel, &map_do, bar_q, p * kPanel, h, q0,
                   b);
    }
    int c = 0;  // sub-tiles issued so far
    for (int j = 0; j < jend; ++j) {
      if (keys_dead(j * SUB, j * SUB + SUB, q0, q_last, causal, window,
                    prefix))
        continue;
      const int slot = c % kStages;
      const uint32_t ph = ((c / kStages) & 1) ^ 1;
      for (int kv = 0; kv < 2; ++kv) {  // the sub-tile's K, then its V
        const CUtensorMap* map = kv ? &map_v : &map_k;
        const uint32_t f = (kv ? full_v : full_k) + 8 * slot;
        const uint32_t dst = (kv ? sV : sK) + slot * T::kStream;
        tc::mbar_wait((kv ? empty_v : empty_k) + 8 * slot, ph);
        tc::mbar_expect_tx(f, T::kStream);
        for (int p = 0; p < NP; ++p)
          tc::tma_load(dst + p * T::kSubPanel, map, f, p * kPanel, hk,
                       j * SUB, b);
      }
      ++c;
    }
    return;
  }

  // ---- consumers: 64 query rows each ------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = tc::warpgroup();
  const int w = (tid / 32) % 4, lane = tid % 32;
  const int qlo = q0 + 64 * g;
  const int qhi = min(qlo + 63, S - 1);
  const bool rows_live = qlo < S;
  const int row0 = qlo + 16 * w + lane / 4;  // this thread's rows: row0, +8
  const int col0 = 2 * (lane % 4);           // its keys: 8 j + col0 (+1)
  float lse2[2], Dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    const size_t at = ((size_t)b * H + h) * S + r;
    lse2[hf] = r < S ? a.lse[at] * kLog2e : INFINITY;
    Dr[hf] = r < S ? a.D[at] : 0.f;
  }
  const uint32_t qA = sQ + g * 64 * 128, oA = sO + g * 64 * 128;
  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;

  tc::mbar_wait(bar_q, 0);
  int c = 0;  // sub-tiles consumed so far
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * SUB;
    if (keys_dead(k0, k0 + SUB, q0, q_last, causal, window, prefix))
      continue;
    const int slot = c % kStages;
    const uint32_t ph = (c / kStages) & 1;
    const uint32_t tk = sK + slot * T::kStream, tv = sV + slot * T::kStream;
    const bool live =
        rows_live && !keys_dead(k0, k0 + SUB, qlo, qhi, causal, window,
                                prefix);
    tc::mbar_wait(full_k + 8 * slot, ph);
    tc::mbar_wait(full_v + 8 * slot, ph);
    if (live) {
      const bool whole = k0 + SUB <= S &&
                         keys_whole(k0, k0 + SUB, qlo, qlo + 63, causal,
                                    window, prefix);
      float s[NS], dp[NS];  // s = q K^T, then p; dp = dout V^T, then ds
      uint32_t da[SUB / 16][4];  // ds as A fragments
      tc::wgmma_fence();
      issue_ss<HD, SUB>(s, qA, T::kTilePanel, tk, T::kSubPanel);
      tc::wgmma_commit();
      issue_ss<HD, SUB>(dp, oA, T::kTilePanel, tv, T::kSubPanel);
      tc::wgmma_commit();
      tc::wgmma_wait<1>();
      tc::fence_regs(s);
      // p = 2^(s scale log2 e - lse log2 e), 0 where masked or past S
      // (while dp runs)
#pragma unroll
      for (int e = 0; e < NS; ++e)
        s[e] = p_of<Shape<HD>::kFma>(s[e], c2, lse2[(e >> 1) & 1]);
      if (!whole) {
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int row = row0 + ((e & 2) ? 8 : 0);
          const int key = k0 + 8 * (e / 4) + col0 + (e & 1);
          s[e] = key < S && keep(row, key, causal, window, prefix) ? s[e]
                                                                   : 0.f;
        }
      }
      tc::wgmma_wait<0>();
      tc::fence_regs(dp);
      if (lane == 0) tc::mbar_arrive(empty_v + 8 * slot);
      // ds = p (dp - D); the scale goes on dq at the end
#pragma unroll
      for (int e = 0; e < NS; ++e) dp[e] = (dp[e] - Dr[(e >> 1) & 1]) * s[e];
      to_frags<SUB / 8>(dp, da);
      // dq += ds K
      tc::fence_regs(dq);
      tc::wgmma_fence();
      issue_rs(dq, da, tk, T::kSubPanel);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dq);
      fence_frags(da);
    } else if (lane == 0) {
      tc::mbar_arrive(empty_v + 8 * slot);
    }
    if (lane == 0) tc::mbar_arrive(empty_k + 8 * slot);
    ++c;
  }

  const size_t rowq = (size_t)H * HD;
  store_rows<HD>(dq, (bf16*)a.dq + (size_t)b * S * rowq + (size_t)h * HD,
                 rowq, row0, col0, S, a.scale);
}

// the dk/dv kernel, then the dq kernel; each reads its operands through
// four tensor maps (boxes of 128 rows for its resident tiles, of its
// streamed tiles' rows for the others)
template <int HD>
int launch(const BwdArgs& a, cudaStream_t st) {
  constexpr int SKV = Shape<HD>::kSubKV, SQ = Shape<HD>::kSubQ;
  using TKV = Smem<HD, SKV>;
  using TQ = Smem<HD, SQ>;
  const long long tiles = (a.S + kTile - 1) / kTile;
  const long long nkv = tiles * a.Hkv * a.B, nq = tiles * a.H * a.B;
  if (nkv > 0x7fffffffLL || nq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float c2 = (float)(1.0 / sqrt((double)HD) * 1.4426950408889634);
  CUtensorMap m0, m1, m2, m3;
  if (!tc::encode(&m0, a.k, a.B, a.S, a.Hkv, HD, kTile) ||
      !tc::encode(&m1, a.v, a.B, a.S, a.Hkv, HD, kTile) ||
      !tc::encode(&m2, a.q, a.B, a.S, a.H, HD, SKV) ||
      !tc::encode(&m3, a.dout, a.B, a.S, a.H, HD, SKV))
    return (int)cudaErrorInvalidValue;
  auto dkdv = flash_attention_bwd_dkdv_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TKV::kSmem);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)nkv, kThreads, TKV::kSmem, st>>>(m0, m1, m2, m3, a, c2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!tc::encode(&m0, a.q, a.B, a.S, a.H, HD, kTile) ||
      !tc::encode(&m1, a.dout, a.B, a.S, a.H, HD, kTile) ||
      !tc::encode(&m2, a.k, a.B, a.S, a.Hkv, HD, SQ) ||
      !tc::encode(&m3, a.v, a.B, a.S, a.Hkv, HD, SQ))
    return (int)cudaErrorInvalidValue;
  auto dq = flash_attention_bwd_dq_wgmma<HD>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TQ::kSmem);
  if (err != cudaSuccess) return (int)err;
  dq<<<(unsigned)nq, kThreads, TQ::kSmem, st>>>(m0, m1, m2, m3, a, c2);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
struct F32Tile {
  static constexpr int LD = HD + 1;
  static constexpr int LS = kF32Tile + 1;
  // four row tiles (K, V, q, dout), p and ds tiles, lse and D
  static constexpr size_t kSmem =
      sizeof(float) * (4 * kF32Tile * LD + 2 * kF32Tile * LS + 2 * kF32Tile);
  static_assert(kSmem <= (size_t)kMaxSmem, "shared memory");
};

// R rows [r0, r0 + R) of a (B,S,heads,HD) f32 tensor into shared memory
// (rows of HD + 1 floats), zeros past S
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* base,
                                              size_t stride, int r0, int S,
                                              int tid) {
  for (int i = tid; i < kF32Tile * HD; i += kF32Threads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r0 + r < S ? base[(size_t)(r0 + r) * stride + d]
                                       : 0.f;
  }
}

// s (rows ra) and dp against the 4 columns cb + 8 j of the other tile:
// s = A[ra] . B[c], dp = A2[ra] . B2[c] over HD
template <int HD>
__device__ __forceinline__ void dots_f32(const float* sA, const float* sB,
                                         const float* sA2, const float* sB2,
                                         int ra, int cb, float (&s)[4],
                                         float (&dp)[4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float x = sA[ra * LD + d], x2 = sA2[ra * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = s[j] + x * sB[(cb + 8 * j) * LD + d];
      dp[j] = dp[j] + x2 * sB2[(cb + 8 * j) * LD + d];
    }
  }
}

// dk and dv of 32 keys: thread (kr, cb) holds key kr's columns cb + 8 i
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_attention_bwd_dkdv_f32(BwdArgs a) {
  using T = F32Tile<HD>;
  constexpr int LD = T::LD, LS = T::LS, NC = HD / 8, R = kF32Tile;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + R * LD;
  float* sQ = sV + R * LD;
  float* sO = sQ + R * LD;
  float* sP = sO + R * LD;   // p^T [key][query]
  float* sS = sP + R * LS;   // ds^T [key][query]
  float* sL = sS + R * LS;   // lse of the tile's queries
  float* sD = sL + R;        // D of the tile's queries

  const int S = a.S, H = a.H, Hkv = a.Hkv;
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int kt = (int)(blockIdx.x / (unsigned)(Hkv * a.B));
  const int hb = (int)(blockIdx.x % (unsigned)(Hkv * a.B));
  const int hk = hb % Hkv, b = hb / Hkv;
  const int rep = H / Hkv;
  const int c0 = kt * R;
  int r0, r1;
  bwd_rows(c0, c0 + R, S, causal, window, prefix, r0, r1);
  const int qt0 = r0 / R;
  const int nqt = r0 < r1 ? (r1 + R - 1) / R - qt0 : 0;

  const size_t rowq = (size_t)H * HD, rowk = (size_t)Hkv * HD;
  const float* kb = (const float*)a.k + (size_t)b * S * rowk + (size_t)hk * HD;
  const float* vb = (const float*)a.v + (size_t)b * S * rowk + (size_t)hk * HD;
  load_rows_f32<HD>(sK, kb, rowk, c0, S, tid);
  load_rows_f32<HD>(sV, vb, rowk, c0, S, tid);
  const int kr = tid / 8, cb = tid % 8;
  const int key = c0 + kr;
  float dk[NC], dv[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk[i] = dv[i] = 0.f;
  for (int it = 0; it < rep * nqt; ++it) {
    const int h = hk * rep + it / nqt;
    const int q0 = (qt0 + it % nqt) * R;
    __syncthreads();
    const size_t off = (size_t)b * S * rowq + (size_t)h * HD;
    load_rows_f32<HD>(sQ, (const float*)a.q + off, rowq, q0, S, tid);
    load_rows_f32<HD>(sO, (const float*)a.dout + off, rowq, q0, S, tid);
    if (tid < 2 * R) {
      const int r = tid % R;
      const size_t at = ((size_t)b * H + h) * S + q0 + r;
      if (tid < R)
        sL[r] = q0 + r < S ? a.lse[at] : INFINITY;
      else
        sD[r] = q0 + r < S ? a.D[at] : 0.f;
    }
    __syncthreads();
    float s[4], dp[4];
    dots_f32<HD>(sK, sQ, sV, sO, kr, cb, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + 8 * j, row = q0 + c;
      const bool kept = key < S && row < S &&
                        keep(row, key, causal, window, prefix);
      const float p = kept ? expf(s[j] * scale - sL[c]) : 0.f;
      sP[kr * LS + c] = p;
      sS[kr * LS + c] = (dp[j] - sD[c]) * p * scale;
    }
    __syncthreads();
    for (int c = 0; c < R; ++c) {
      const float p = sP[kr * LS + c], ds = sS[kr * LS + c];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        dv[i] = dv[i] + p * sO[c * LD + cb + 8 * i];
        dk[i] = dk[i] + ds * sQ[c * LD + cb + 8 * i];
      }
    }
  }
  if (key < S) {
    float* dkr = (float*)a.dk + ((size_t)b * S + key) * rowk + (size_t)hk * HD;
    float* dvr = (float*)a.dv + ((size_t)b * S + key) * rowk + (size_t)hk * HD;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dkr[cb + 8 * i] = dk[i];
      dvr[cb + 8 * i] = dv[i];
    }
  }
}

// dq of 32 query rows: thread (qr, cb) holds row qr's columns cb + 8 i
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_attention_bwd_dq_f32(BwdArgs a) {
  using T = F32Tile<HD>;
  constexpr int LD = T::LD, LS = T::LS, NC = HD / 8, R = kF32Tile;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sO = sQ + R * LD;
  float* sK = sO + R * LD;
  float* sV = sK + R * LD;
  float* sS = sV + R * LD;   // ds [row][key]

  const int S = a.S, H = a.H, Hkv = a.Hkv;
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int nqt = (S + R - 1) / R;
  const int hb = (int)(blockIdx.x % (unsigned)(H * a.B));
  const int qt = nqt - 1 - (int)(blockIdx.x / (unsigned)(H * a.B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * R;
  const int q_last = min(q0 + R, S) - 1;

  const size_t rowq = (size_t)H * HD, rowk = (size_t)Hkv * HD;
  const size_t off = (size_t)b * S * rowq + (size_t)h * HD;
  load_rows_f32<HD>(sQ, (const float*)a.q + off, rowq, q0, S, tid);
  load_rows_f32<HD>(sO, (const float*)a.dout + off, rowq, q0, S, tid);
  const float* kb = (const float*)a.k + (size_t)b * S * rowk + (size_t)hk * HD;
  const float* vb = (const float*)a.v + (size_t)b * S * rowk + (size_t)hk * HD;
  const int qr = tid / 8, cb = tid % 8;
  const int row = q0 + qr;
  const size_t at = ((size_t)b * H + h) * S + row;
  const float lse_r = row < S ? a.lse[at] : INFINITY;
  const float D_r = row < S ? a.D[at] : 0.f;
  float dq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq[i] = 0.f;
  const int nkt = (S + R - 1) / R;
  const int jend = causal ? min(nkt, max(q_last, prefix - 1) / R + 1) : nkt;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * R;
    if (keys_dead(k0, k0 + R, q0, q_last, causal, window, prefix)) continue;
    __syncthreads();
    load_rows_f32<HD>(sK, kb, rowk, k0, S, tid);
    load_rows_f32<HD>(sV, vb, rowk, k0, S, tid);
    __syncthreads();
    float s[4], dp[4];
    dots_f32<HD>(sQ, sK, sO, sV, qr, cb, s, dp);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = cb + 8 * jj, key = k0 + c;
      const bool kept = key < S && row < S &&
                        keep(row, key, causal, window, prefix);
      const float p = kept ? expf(s[jj] * scale - lse_r) : 0.f;
      sS[qr * LS + c] = (dp[jj] - D_r) * p * scale;
    }
    __syncthreads();
    for (int c = 0; c < R; ++c) {
      const float ds = sS[qr * LS + c];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        dq[i] = dq[i] + ds * sK[c * LD + cb + 8 * i];
    }
  }
  if (row < S) {
    float* dqr = (float*)a.dq + ((size_t)b * S + row) * rowq + (size_t)h * HD;
#pragma unroll
    for (int i = 0; i < NC; ++i) dqr[cb + 8 * i] = dq[i];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int launch_kernel(K kern, unsigned grid, int threads, size_t smem,
                  const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// bf16 at head dim 256 (mma.sync): query tiles of 32 rows and two warps to
// each 16 keys in the dk/dv kernel, key tiles of 32 in the dq kernel
int launch_bf16_256(const BwdArgs& a, cudaStream_t st) {
  constexpr int HD = 256, BR = 32, NSPLIT = 2, BC = 32;
  using KV = Dkdv<HD, BR, NSPLIT>;
  using Q = Dq<HD, BC>;
  const long long nkv =
      (long long)((a.S + kKeyTile - 1) / kKeyTile) * a.Hkv * a.B;
  const long long nq =
      (long long)((a.S + kRowTile - 1) / kRowTile) * a.H * a.B;
  if (nkv > 0x7fffffffLL || nq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int code = launch_kernel(flash_attention_bwd_dkdv<HD, BR, NSPLIT>,
                           (unsigned)nkv, KV::kThreads, KV::kSmem, a, st);
  if (code != 0) return code;
  return launch_kernel(flash_attention_bwd_dq<HD, BC>, (unsigned)nq,
                       Q::kThreads, Q::kSmem, a, st);
}

template <int HD>
int launch_f32(const BwdArgs& a, cudaStream_t st) {
  const long long nkv =
      (long long)((a.S + kF32Tile - 1) / kF32Tile) * a.Hkv * a.B;
  const long long nq =
      (long long)((a.S + kF32Tile - 1) / kF32Tile) * a.H * a.B;
  if (nkv > 0x7fffffffLL || nq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = F32Tile<HD>::kSmem;
  int code = launch_kernel(flash_attention_bwd_dkdv_f32<HD>, (unsigned)nkv,
                           kF32Threads, smem, a, st);
  if (code != 0) return code;
  return launch_kernel(flash_attention_bwd_dq_f32<HD>, (unsigned)nq,
                       kF32Threads, smem, a, st);
}

template <typename T>
int launch_dot(const BwdArgs& a, int hd, cudaStream_t st) {
  const long long rows = (long long)a.B * a.S * a.H;
  const long long blocks = (rows * kDotThreads + 255) / 256;
  if (rows > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  flash_attention_bwd_dot<T><<<(unsigned)blocks, 256, 0, st>>>(
      (const T*)a.out, (const T*)a.dout, a.D, (int)rows, a.S, a.H, hd);
  return (int)cudaGetLastError();
}

template <bool TC>
int launch_hd(const BwdArgs& a, int hd, cudaStream_t st) {
#define FA_BWD_LAUNCH(HD) \
  return TC ? wg::launch<HD>(a, st) : launch_f32<HD>(a, st)
  switch (hd) {
    case 16:
      FA_BWD_LAUNCH(16);
    case 32:
      FA_BWD_LAUNCH(32);
    case 64:
      FA_BWD_LAUNCH(64);
    case 96:
      FA_BWD_LAUNCH(96);
    case 128:
      FA_BWD_LAUNCH(128);
    case 256:
      return TC ? launch_bf16_256(a, st) : launch_f32<256>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD_LAUNCH
}

}  // namespace

// q, out, dout, dq (B,S,H,hd); k, v, dk, dv (B,S,Hkv,hd); all contiguous,
// 16-byte aligned and of one dtype: 0 = f32 (CUDA cores), 1 = bf16 (tensor
// cores); lse (B,H,S) f32 as K6 wrote it; D (B,H,S) f32 scratch (the
// pre-pass writes it). K6's mask: causal, window, every row sees the first
// `prefix` keys (0 <= prefix <= S). Head dims 16, 32, 64, 96, 128, 256.
// Three launches on `stream` (the pre-pass, dk/dv, dq); returns the first
// CUDA error code, nothing launched for a shape it does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int S, int H, int Hkv, int hd, int causal, int window, int prefix,
    int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || prefix < 0 || prefix > S ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 96 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, out, dout, (const float*)lse, (float*)D, dq, dk,
                  dv, B, S, H, Hkv, causal, window, prefix,
                  (float)(1.0 / sqrt((double)hd))};
  const cudaStream_t st = (cudaStream_t)stream;
  int code =
      dtype ? launch_dot<bf16>(a, hd, st) : launch_dot<float>(a, hd, st);
  if (code != 0) return code;
  return dtype ? launch_hd<true>(a, hd, st) : launch_hd<false>(a, hd, st);
}
