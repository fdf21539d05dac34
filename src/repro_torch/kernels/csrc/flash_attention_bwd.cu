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
//   flash_attention_bwd_dkdv  one CTA per (64-key tile, KV head, batch row)
//                             with its K and V tiles in shared memory; it
//                             walks the query tiles that see one of its
//                             keys (flash_attention.py's _bwd_rows), for
//                             each of the group's rep query heads in turn,
//                             and writes dk and dv once;
//   flash_attention_bwd_dq    one CTA per (64 query rows, head, batch row),
//                             the tiles that walk the most keys first, with
//                             its q and dout rows in shared memory; it walks
//                             the key tiles the mask does not remove for all
//                             its rows (keys_dead) and writes dq once.
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
// 0.121 ms. Bound by the operations.
//
// bf16: on the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32 (wgmma
// and TMA are a later design). Each warp owns 16 rows of its CTA's tile:
// 16 keys in the dk/dv kernel, which computes s and dp transposed (s^T = k
// q^T), so that p^T and ds^T come out of the accumulators already in the A
// operand's layout; 16 query rows in the dq kernel. Operands come from
// shared memory by ldmatrix: non-transposed for the score products (q, k,
// v and dout are K-major there), transposed (.trans) for the B operands of
// p^T dout, ds^T q and ds k. Tiles arrive by cp.async in two stages (q and
// dout tiles in the dk/dv kernel, k and v tiles in the dq kernel), the
// next one loading while the warps compute on the current one. Rows in
// shared memory are padded by 16 bytes, so the 8 row addresses of an
// ldmatrix fall in distinct banks. p and ds are rounded to bf16 as product
// operands (each once, as the forward's tensor-core products do with q and
// k); every sum is f32. Rows per tile shrink as the head dim grows, to keep
// the f32 accumulators in registers: the dk/dv kernel walks query tiles of
// 64 rows up to head dim 32 and of 32 above (at head dim 64, 32-row tiles
// take 168 registers a thread, 3 CTAs an SM, where 64-row tiles took 214,
// 2 CTAs, and were slower: scripts/k6_bwd_probe.py --variants); at head
// dim 256 its 16 keys' dk and dv (16 x 256 x 2 f32) would take 256
// registers a thread, so the
// CTA has 8 warps, two to each 16 keys, each summing dk and dv for half the
// columns (both compute the keys' s and dp); the dq kernel walks key tiles
// of 64 keys, 32 at head dim 256.
//
// f32: on the CUDA cores in f32 (the tensor cores would take f32 only as
// TF32), in the same two-kernel structure: CTAs of 256 threads over tiles
// of 32 keys and 32 query rows staged in shared memory (rows padded to
// hd + 1 floats), s and dp a 4-element register tile per thread, p and ds
// through shared memory, dk, dv or dq rows accumulated in registers.
//
// Built with --fmad=false and exp as expf, as the forward: the products'
// sums run in another order than the plain version's matmuls.
//
// ptxas (-Xptxas -v, sm_90a; CUDA 12.8), registers a thread and dynamic
// shared memory a CTA at head dims 16 / 32 / 64 / 96 / 128 / 256:
//   dkdv bf16  125 / 158 / 168 / 222 / 252 / 250 (8 warps at 256);
//              19,456 / 31,744 / 37,376 / 53,760 / 70,144 / 135,680 B
//   dq bf16    88 / 128 / 159 / 167 / 171 / 243;
//              18,432 / 30,720 / 55,296 / 79,872 / 104,448 / 135,168 B
//   dkdv f32   32 / 40 / 64 / 64 / 80 / 128;  dq f32  48 / 48 / 64 / 64 /
//              80 / 80; both 17,408 / 25,600 / 41,984 / 58,368 / 74,752 /
//              140,288 B
//   dot        30 (f32) / 32 (bf16), no shared memory
// Nothing spills but the f32 dq kernel at head dim 32 (8 bytes of stack).
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mask.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;
constexpr int kKeyTile = 64;   // keys per dk/dv CTA (bf16)
constexpr int kRowTile = 64;   // query rows per dq CTA (bf16)
constexpr int kPad = 8;        // bf16 elements of padding per shared row
constexpr int kDotThreads = 8; // threads per row of the pre-pass
constexpr int kF32Tile = 32;   // keys and query rows per f32 tile
constexpr int kF32Threads = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
// bf16: dk and dv
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
// bf16: dq
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

// bf16: query tiles of 64 rows up to head dim 32 and of 32 above; at head
// dim 256 two warps to each 16 keys; the dq kernel's key tiles of 64, 32 at
// head dim 256
template <int HD>
int launch_bf16(const BwdArgs& a, cudaStream_t st) {
  constexpr int BR = HD <= 32 ? 64 : 32;
  constexpr int NSPLIT = HD > 128 ? 2 : 1;
  constexpr int BC = HD > 128 ? 32 : 64;
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
  return TC ? launch_bf16<HD>(a, st) : launch_f32<HD>(a, st)
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
      FA_BWD_LAUNCH(256);
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
