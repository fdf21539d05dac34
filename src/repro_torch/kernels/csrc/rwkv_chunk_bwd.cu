// K7's backward for Hopper (sm_90a): dr, dk, dv, dw and du of the chunked
// RWKV6 WKV (rwkv_chunk.cu) from the zero state, f32 in and out.
//
// Replaces no TPU kernel: the reference's gradient is XLA's transpose of
// repro/models/rwkv.py:77 time_mix_chunked, and its Pallas kernel
// (repro/kernels/rwkv_chunk.py:79) has no backward. It computes what the
// plain version, rwkv_chunk.py:rwkv_chunked_bthd_bwd_ref, computes. Per
// chunk of C tokens, with cum the inclusive prefix of logw = log(max(w,
// 1e-38)), total = cum[C-1], P = exp(cum - logw), E = exp(-cum) (0 at the
// chunk's last token), F = exp(total - cum), rP = r P, kD = k E, kT = k F,
// A = mask(rP kD^T) (s < t) and diag_t = sum_d r u k:
//   dS_c = kT^T v,  S_c = exp(total) S_{c-1} + dS_c  (S_{-1} = 0)
//   Ry_c = rP^T gy, G_{c-1} = Ry_c + exp(total) G_c  (G_{nc-1} = gS or 0)
//   dA = mask(gy v^T),  ddiag_t = sum_e gy v
//   dv = A^T gy + diag gy + kT G_c
//   d_rP = gy S_{c-1}^T + dA kD,  d_kD = dA^T rP,  d_kT = v G_c^T
//   dr = d_rP P + ddiag u k,  dk = d_kD E + d_kT F + ddiag u r
//   du = sum over chunks and tokens of ddiag r k
//   dcum = gP - gE - gF (gP = d_rP r P, gE = d_kD k E, gF = d_kT k F),
//   with d_total = exp(total) sum_e S_{c-1} G_c + sum_t gF on row C - 1
//   dlogw = (suffix sum of dcum) - gP,  dw = dlogw / w where w > 1e-38.
//
// Bound on this card: at rwkv6-3b's training microbatch (B 4, T 4096, 40
// heads of 64, C 128) the function moves 1.51 GB (r, k, v, w, gy read
// once, dr, dk, dv, dw written once: 0.45 ms at 3.35 TB/s) and needs
// 29.9 GFLOP counted from the token recurrence's gradient (11 hd^2 + 10 hd
// per token and head, roofline/work.py:rwkv_bwd_flops; 0.45 ms at 67
// TFLOP/s). The chunked form computes ten products per tile, ~10.5 MFLOP,
// 54 GFLOP over the 5120 tiles, each as three TF32 products.
//
// Design: three launches on the stream, every product on the tensor cores
// (m16n8k8 TF32 mma.sync in three terms, tf32_mma.cuh, as K7's forward,
// but with lo rounded too: ROUND_LO), the updates explicit __fmaf_rn under
// --fmad=false, no float atomics, every sum in a fixed order:
//   1. rwkv_chunk_bwd_increments, one CTA (256 threads, three per SM) per
//      (batch, head, chunk) tile: k and v copied in while each thread
//      reads w for its column and segment of tokens and sums their logs
//      in registers; kT over k, dS_c = kT^T v; r and gy over k and v, rP
//      over r, Ry_c = rP^T gy; each (hd x hd) into a (B,H,nc,hd,hd)
//      scratch buffer, exp(total) into (B,H,nc,hd). Shared memory: two
//      (Cp x hd+4) slots and the segment sums.
//   2. rwkv_chunk_bwd_chains, one thread per four state elements (d,
//      e..e+3), its loads 8 chunks at a time: S_{c-1} in chunk order
//      written over dS_c, then G_c in reverse written over Ry_c, and the
//      state term of d_total, whose sum over e runs in the thread (four)
//      and by an xor butterfly over the hd / 4 lanes of its row.
//   3. rwkv_chunk_bwd_grads, one CTA (512 threads, one per SM) per tile.
//      Shared memory is the limit: four (Cp x hd+4) slots s1..s4, the
//      (Cp x Cp+8) buffer X, and SG, hd rows of at most 64 state columns
//      (S and G take 67 KB each at head dim 128: their columns go through
//      in two halves). In order:
//        load w -> s1, r -> s2, k -> s3, gy -> s4, S's first columns -> SG;
//        the prefix of logw in s1 (segments, as K7), diag from raw r, k;
//        rP' = rP 2^-j in s2, kD' = kD 2^j in s3, 2^j ~ exp(total / 2) of
//        the column (an exact scaling; A is the same; a decay under the
//        clamp inside a chunk would make rP denormal, and a TF32 split
//        keeps 11 bits of a denormal); v -> s1 (cum is recomputed below);
//        X = A (the 16 x 16 tiles of the lower triangle);
//        dv = A^T gy (registers); ddiag; X = dA;
//        d_rP 2^j = gy S^T 2^j + dA kD', staged in dr;
//        d_kD 2^-j = dA^T rP', staged in dk;
//        w -> s2, k -> s3, G's first columns -> SG; the prefix again (the
//        same code on the same data: the same cum) in s2, kT in s3;
//        dv += kT G, then dv + diag gy written; d_kT = v G^T, staged in dw;
//        then one thread per (column, segment of tokens) reads its staged
//        d_rP, d_kD, d_kT back (its CTA's own writes, after a barrier; 4
//        tokens' loads at a time), r, k, w from device memory and cum from
//        s2 (P 2^-j and E 2^j from it), writes dr and dk, keeps each
//        token's dcum and gP in s1 and s3, sums gF, dcum and du over its
//        segment, and after a pass over the segment sums walks its segment
//        backward for dw. du is written per tile, (B,H,nc,hd); the wrapper
//        sums it in torch.
//   The staged outputs cost a write and a read of three (B,T,H,hd) tiles
//   through L2, where shared memory has no room for them.
//
// ptxas (CUDA 12, sm_90a), registers at head dims 16 / 32 / 64 / 128, none
// spilled: increments 47 / 64 / 80 / 80, chains 127 / 107 / 107 / 109,
// grads 80 / 92 / 106 / 112. Dynamic shared memory at the largest chunk
// (128 tokens, 64 at head dim 128): increments 21,504 / 37,888 / 70,656 /
// 68,608 bytes, grads 113,152 / 149,504 / 228,352 / 190,976 bytes (of
// 232,448); the chains none.
#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 512;     // the gradients' CTA
constexpr int kWarps = kThreads / 32;
constexpr int kIncThreads = 256;  // the state increments' CTA
constexpr int kChainThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxSmem = 232448;
constexpr int kTooLarge = -1;     // the chunk does not fit one CTA
constexpr int kBadHeadDim = -2;

__host__ __device__ constexpr int pad32(int c) { return (c + 31) & ~31; }
// the most rows (padded tokens) a tile holds: K7's forward takes 128
// tokens, 64 at head dim 128
__host__ __device__ constexpr int max_rows(int hd) {
  return hd > 64 ? 64 : 128;
}
// the warp tiles of the (Cp x hd) products: 16 rows x 8 NT columns
__host__ __device__ constexpr int tile_nt(int hd) {
  return hd / 16 < 1 ? 1 : (hd / 16 > 4 ? 4 : hd / 16);
}

// Shared memory of the gradients' CTA, in floats. Rows of Cp tokens, hd + 4
// floats each (conflict free read down a column, two-way along a row).
struct GradLayout {
  int ld, lda, lds, s1, s2, s3, s4, x, sg, diag, ddiag, tot, sc, u, dts,
      floats;
  __host__ __device__ GradLayout(int Cp, int hd) {
    ld = hd + 4;
    lda = Cp + 8;
    lds = (hd < 64 ? hd : 64) + 4;
    s1 = 0;                   // w -> cum, then v
    s2 = s1 + Cp * ld;        // r -> rP, then w -> cum
    s3 = s2 + Cp * ld;        // k -> kD, then k -> kT
    s4 = s3 + Cp * ld;        // gy
    x = s4 + Cp * ld;         // segment sums, A, dA, segment sums
    const int xs = Cp * lda > 3 * kThreads ? Cp * lda : 3 * kThreads;
    sg = x + xs;              // S's, then G's columns (hd x lds)
    diag = sg + hd * lds;     // Cp
    ddiag = diag + Cp;        // Cp
    tot = ddiag + Cp;         // total, hd
    sc = tot + hd;            // the column's scale 2^j, hd
    u = sc + hd;              // hd
    dts = u + hd;             // d_total's state term, hd
    floats = dts + hd;
  }
};

// 2^j and 2^-j for the column whose chunk total is ``tot``: j is
// total / 2 in powers of two (rounded, within [-126, 0]), so rP 2^-j and
// kD 2^j are both far from the f32 range's ends, and the scaling is exact
__device__ __forceinline__ void column_scale(float tot, float& sc,
                                             float& inv) {
  int j = __float2int_rn(0.5f * tot * 1.44269504f);
  j = j < -126 ? -126 : (j > 0 ? 0 : j);
  sc = __int_as_float((127 + j) << 23);
  inv = __int_as_float((127 - j) << 23);
}

__host__ __device__ constexpr int inc_floats(int Cp, int hd) {
  return 2 * Cp * (hd + 4) + kIncThreads;
}

// Pass 1 of a chunk's prefix of logw = log(max(w, 1e-38)) over the Cp rows
// of sW (stride ld): the THREADS / HD segments of a column each walk SL =
// Cp / NS tokens; w becomes the segment's local prefix, lw the segment's
// logs, seg[s HD + col] its sum.
template <int THREADS, int HD, int MAXSL>
__device__ __forceinline__ void prefix_pass1(float* sW, int ld, int Cp,
                                             float* seg, float (&lw)[MAXSL]) {
  constexpr int NS = THREADS / HD;
  const int col = threadIdx.x % HD, s = threadIdx.x / HD, SL = Cp / NS;
  float* wp = sW + s * SL * ld + col;
  // every load before the first store (the compiler cannot tell the
  // rows apart)
#pragma unroll
  for (int i = 0; i < MAXSL; ++i)
    if (i < SL) lw[i] = wp[i * ld];
  float p = 0.f;
#pragma unroll
  for (int i = 0; i < MAXSL; ++i)
    if (i < SL) {
      lw[i] = logf(fmaxf(lw[i], 1e-38f));
      p = p + lw[i];
      wp[i * ld] = p;
    }
  seg[s * HD + col] = p;
}

// Pass 2: this thread's segment offset and its column's total, the
// segment sums added in segment order.
template <int THREADS, int HD>
__device__ __forceinline__ void prefix_offsets(const float* seg, float& off,
                                               float& tot) {
  constexpr int NS = THREADS / HD;
  const int col = threadIdx.x % HD, s = threadIdx.x / HD;
  off = 0.f;
  tot = 0.f;
  for (int s2 = 0; s2 < NS; ++s2) {
    if (s2 == s) off = tot;
    tot = tot + seg[s2 * HD + col];
  }
}

// out (hd x hd, row-major) = sa^T sb over the Cp rows of two (Cp x ld)
// tiles, by 16 x 8 NT warp tiles; warp w of NW takes tiles w, w + NW, ...
template <int HD>
__device__ __forceinline__ void state_product(float* out, const float* sa,
                                              const float* sb, int ld, int Cp,
                                              int NW) {
  constexpr int NT = tile_nt(HD), WC = 8 * NT, CB = HD / WC;
  constexpr int NJ = (HD / 16) * CB;
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int job = threadIdx.x >> 5; job < NJ; job += NW) {
    const int d0 = (job / CB) * 16, e0 = (job % CB) * WC;
    float acc[NT][4];
    zero(acc);
    warp_mma<NT, false, false, true>(acc, sa + d0, ld, sb + e0, ld, Cp);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(out + (d0 + g + 8 * hf) * HD + e0 +
                                   8 * n + t2) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
  }
}

// 1. dS_c = kT^T v and Ry_c = rP^T gy of one (batch, head, chunk) tile
// (tile = (b H + h) nc + c), and exp(total). The prefix of logw runs in
// registers, each thread's column and segment of tokens read from device
// memory, while k and v are copied in.
template <int HD>
__global__ void __launch_bounds__(kIncThreads, 3) rwkv_chunk_bwd_increments(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ gy, float* __restrict__ dS,
    float* __restrict__ Ry, float* __restrict__ etot, int H, int T, int C) {
  constexpr int NS = kIncThreads / HD, MAXSL = max_rows(HD) / NS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, Cp = pad32(C), ld = HD + 4, nc = T / C;
  float *sa = smem, *sb = sa + Cp * ld, *seg = sb + Cp * ld;
  const int tile = blockIdx.x, bh = tile / nc, c = tile % nc;
  const size_t st = (size_t)H * HD;
  const size_t base =
      ((size_t)(bh / H) * T + (size_t)c * C) * st + (size_t)(bh % H) * HD;
  load_rows<kIncThreads, HD>(sa, ld, k + base, st, C, Cp, 0.f);
  load_rows<kIncThreads, HD>(sb, ld, v + base, st, C, Cp, 0.f);
  cp_commit();
  const int col = tid % HD, SL = Cp / NS, t0 = (tid / HD) * SL;
  float lw[MAXSL];  // w, then logw, of this thread's tokens (1 past C)
#pragma unroll
  for (int i = 0; i < MAXSL; ++i)
    if (i < SL) lw[i] = t0 + i < C ? w[base + (t0 + i) * st + col] : 1.f;
  float p = 0.f;
#pragma unroll
  for (int i = 0; i < MAXSL; ++i)
    if (i < SL) {
      lw[i] = logf(fmaxf(lw[i], 1e-38f));
      p = p + lw[i];
    }
  seg[(tid / HD) * HD + col] = p;
  cp_wait<0>();
  __syncthreads();
  float off, tot;
  prefix_offsets<kIncThreads, HD>(seg, off, tot);
  if (tid < HD) etot[(size_t)tile * HD + col] = expf(tot);
  {  // kT = k exp(total - cum) over k (cum = off + the local prefix)
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAXSL; ++i)
      if (i < SL) {
        const int o = (t0 + i) * ld + col;
        q = q + lw[i];
        sa[o] = sa[o] * expf(tot - (off + q));
      }
  }
  __syncthreads();
  state_product<HD>(dS + (size_t)tile * HD * HD, sa, sb, ld, Cp,
                    kIncThreads / 32);
  __syncthreads();
  load_rows<kIncThreads, HD>(sa, ld, r + base, st, C, Cp, 0.f);
  load_rows<kIncThreads, HD>(sb, ld, gy + base, st, C, Cp, 0.f);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  {  // rP = r exp(cum - logw) over r, cum summed again in the same order
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAXSL; ++i)
      if (i < SL) {
        const int o = (t0 + i) * ld + col;
        q = q + lw[i];
        sa[o] = sa[o] * expf((off + q) - lw[i]);
      }
  }
  __syncthreads();
  state_product<HD>(Ry + (size_t)tile * HD * HD, sa, sb, ld, Cp,
                    kIncThreads / 32);
}

// 2. The two chains, four elements (d, 4q..4q+3) of one (batch, head)'s
// state a thread: S over dS in chunk order, then G over Ry in reverse, and
// d_total's state term exp(total_c)[d] sum_e S_{c-1}[d,e] G_c[d,e] into
// dts (B,H,nc,hd). gS (B,H,hd,hd) or null for zero.
template <int HD>
__global__ void __launch_bounds__(kChainThreads) rwkv_chunk_bwd_chains(
    float* __restrict__ S, float* __restrict__ G,
    const float* __restrict__ etot, float* __restrict__ dts,
    const float* __restrict__ gS, int BH, int nc) {
  constexpr int Q = HD / 4;
  const long i = (long)blockIdx.x * kChainThreads + threadIdx.x;
  // HD Q is a multiple of 32: a warp is wholly in or out
  if (i >= (long)BH * HD * Q) return;
  const int bh = (int)(i / (HD * Q)), d = (int)(i / Q % HD), q = (int)(i % Q);
  const size_t step = (size_t)HD * HD;
  float* Sp = S + (size_t)bh * nc * step + d * HD + 4 * q;
  float* Gp = G + (size_t)bh * nc * step + d * HD + 4 * q;
  const float* et = etot + (size_t)bh * nc * HD + d;
  // each chain's loads issued kD chunks at a time (they do not depend on
  // it)
  constexpr int kD = 8;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kD) {
    float4 x[kD];
    float e[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j)
      if (c0 + j < nc) {
        x[j] = *reinterpret_cast<const float4*>(Sp + (c0 + j) * step);
        e[j] = et[(size_t)(c0 + j) * HD];
      }
#pragma unroll
    for (int j = 0; j < kD; ++j)
      if (c0 + j < nc) {
        *reinterpret_cast<float4*>(Sp + (c0 + j) * step) = s;
        s = make_float4(__fmaf_rn(e[j], s.x, x[j].x),
                        __fmaf_rn(e[j], s.y, x[j].y),
                        __fmaf_rn(e[j], s.z, x[j].z),
                        __fmaf_rn(e[j], s.w, x[j].w));
      }
  }
  float4 g = gS ? *reinterpret_cast<const float4*>(
                      gS + (size_t)bh * step + d * HD + 4 * q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= kD) {
    float4 y[kD], sp[kD];
    float e[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j)
      if (c0 - j >= 0) {
        y[j] = *reinterpret_cast<const float4*>(Gp + (c0 - j) * step);
        sp[j] = *reinterpret_cast<const float4*>(Sp + (c0 - j) * step);
        e[j] = et[(size_t)(c0 - j) * HD];
      }
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      if (c0 - j < 0) break;  // the same for every lane of the warp
      const int c = c0 - j;
      *reinterpret_cast<float4*>(Gp + c * step) = g;
      float part = sp[j].x * g.x + sp[j].y * g.y + sp[j].z * g.z +
                   sp[j].w * g.w;
#pragma unroll
      for (int m = Q / 2; m > 0; m >>= 1)
        part += __shfl_xor_sync(FULL_MASK, part, m);
      if (q == 0) dts[((size_t)bh * nc + c) * HD + d] = e[j] * part;
      g = make_float4(__fmaf_rn(e[j], g.x, y[j].x),
                      __fmaf_rn(e[j], g.y, y[j].y),
                      __fmaf_rn(e[j], g.z, y[j].z),
                      __fmaf_rn(e[j], g.w, y[j].w));
    }
  }
}

// columns [p SW, p SW + SW) of an (HD x HD) state in device memory into
// sG (HD rows of lds floats), by cp.async
template <int HD, int SW>
__device__ __forceinline__ void load_piece(float* sG, int lds,
                                           const float* src, int p) {
  constexpr int Q = SW / 4;
  for (int i = threadIdx.x; i < HD * Q; i += kThreads)
    cp16(sG + (i / Q) * lds + 4 * (i % Q),
         src + (i / Q) * HD + p * SW + 4 * (i % Q));
}

// X[t][s] = P_t . Q_s for s < t, else 0 (P, Q: Cp rows of HD, stride ld),
// over the 16 x 16 tiles of the lower triangle (row block i, column block
// j <= i): every entry the products below read. Warp w takes tiles w, w +
// 16, ... in row order.
template <int HD>
__device__ __forceinline__ void lower_product(float* X, int lda,
                                              const float* P, const float* Q,
                                              int ld, int Cp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  int i = 0, j = 0;
  for (int n = threadIdx.x >> 5; n > 0; --n)
    if (++j > i) j = 0, ++i;
  while (i < Cp / 16) {
    float acc[2][4];
    zero(acc);
    warp_mma<2, true, true, true>(acc, P + i * 16 * ld, ld, Q + j * 16 * ld,
                                  ld, HD);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = i * 16 + g + 8 * hf, s = j * 16 + 8 * n + t2;
        *reinterpret_cast<float2*>(X + t * lda + s) =
            make_float2(s < t ? acc[n][2 * hf] : 0.f,
                        s + 1 < t ? acc[n][2 * hf + 1] : 0.f);
      }
    for (int n = 0; n < kWarps; ++n)
      if (++j > i) j = 0, ++i;
  }
}

// a warp's 16 x 8 NT tile at (r0, e0) into rows t < C of a (B,T,H,hd)
// tensor (dst at the tile's first token, rows st floats apart)
template <int NT>
__device__ __forceinline__ void store_tile(float* dst, size_t st,
                                           const float (&acc)[NT][4], int r0,
                                           int e0, int C) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + g + 8 * hf;
      if (t < C)
        *reinterpret_cast<float2*>(dst + t * st + e0 + 8 * n + t2) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
}

// row sums sum_d a[t][d] b[t][d] (times sU[d] where given) of the Cp rows,
// four lanes a token, into out[t]
template <int HD>
__device__ __forceinline__ void row_dots(float* out, const float* a,
                                         const float* b, const float* sU,
                                         int ld, int Cp) {
  const int t = threadIdx.x >> 2, part = threadIdx.x & 3;
  float s = 0.f;
  if (t < Cp)
    for (int d = part; d < HD; d += 4)
      s = s + (sU ? a[t * ld + d] * sU[d] : a[t * ld + d]) * b[t * ld + d];
  s += __shfl_xor_sync(FULL_MASK, s, 1);
  s += __shfl_xor_sync(FULL_MASK, s, 2);
  if (part == 0 && t < Cp) out[t] = s;
}

// 3. dr, dk, dv, dw and du's per-tile part of one (batch, head, chunk)
// tile, from S_{c-1} (S), G_c (G) and d_total's state term (dts). r, k,
// v, w, gy, dr, dk, dv, dw (B,T,H,HD); u[b uB + h uH + d]; du (B,H,nc,HD).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) rwkv_chunk_bwd_grads(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ gy,
    const float* __restrict__ S, const float* __restrict__ G,
    const float* __restrict__ dts, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du, int H, int T, int C, int uB, int uH) {
  constexpr int NT = tile_nt(HD), WC = 8 * NT, CB = HD / WC;
  constexpr int NS = kThreads / HD, MAXSL = max_rows(HD) / NS;
  constexpr int SW = HD < 64 ? HD : 64, NP = HD / SW;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int Cp = pad32(C), nc = T / C;
  const GradLayout L(Cp, HD);
  const int ld = L.ld, lda = L.lda, lds = L.lds;
  float *s1 = smem + L.s1, *s2 = smem + L.s2, *s3 = smem + L.s3,
        *s4 = smem + L.s4, *X = smem + L.x, *SG = smem + L.sg,
        *sDiag = smem + L.diag, *sDdiag = smem + L.ddiag,
        *sTot = smem + L.tot, *sSc = smem + L.sc, *sU = smem + L.u,
        *sDts = smem + L.dts;
  const int tile = blockIdx.x, bh = tile / nc, c = tile % nc;
  const int b = bh / H, h = bh % H;
  const size_t st = (size_t)H * HD;
  const size_t base = ((size_t)b * T + (size_t)c * C) * st + (size_t)h * HD;
  const float* Sc = S + (size_t)tile * HD * HD;
  const float* Gc = G + (size_t)tile * HD * HD;
  // this warp's tile of every (Cp x HD) product (one at most)
  const bool owns = warp < (Cp / 16) * CB;
  const int r0 = (warp / CB) * 16, e0 = (warp % CB) * WC;
  // the prefix's and the epilogue's thread: a column and a token segment
  const int col = tid % HD, seg = tid / HD, SL = Cp / NS, t0 = seg * SL;

  load_rows<kThreads, HD>(s1, ld, w + base, st, C, Cp, 1.f);
  load_rows<kThreads, HD>(s2, ld, r + base, st, C, Cp, 0.f);
  load_rows<kThreads, HD>(s3, ld, k + base, st, C, Cp, 0.f);
  cp_commit();
  load_piece<HD, SW>(SG, lds, Sc, 0);
  cp_commit();
  load_rows<kThreads, HD>(s4, ld, gy + base, st, C, Cp, 0.f);
  cp_commit();
  if (tid < HD) {
    sU[tid] = u[(size_t)b * uB + (size_t)h * uH + tid];
    sDts[tid] = dts[(size_t)tile * HD + tid];
  }
  cp_wait<2>();
  __syncthreads();
  {
    float lw[MAXSL];
    prefix_pass1<kThreads, HD, MAXSL>(s1, ld, Cp, X, lw);
    __syncthreads();
    row_dots<HD>(sDiag, s2, s3, sU, ld, Cp);  // diag = sum_d r u k
    float off, tot;
    prefix_offsets<kThreads, HD>(X, off, tot);
    float sc, inv;
    column_scale(tot, sc, inv);
    if (seg == 0) sSc[col] = sc;
    __syncthreads();
    // rP' = rP 2^-j over r, kD' = kD 2^j over k (0 at the chunk's last
    // token)
#pragma unroll
    for (int i = 0; i < MAXSL; ++i)
      if (i < SL) {
        const int t = t0 + i, o = t * ld + col;
        const float cum = off + s1[o];
        s2[o] = s2[o] * (expf(cum - lw[i]) * inv);
        s3[o] = t == C - 1 ? 0.f : s3[o] * (expf(-cum) * sc);
      }
  }
  __syncthreads();
  load_rows<kThreads, HD>(s1, ld, v + base, st, C, Cp, 0.f);
  cp_commit();
  lower_product<HD>(X, lda, s2, s3, ld, Cp);  // A
  cp_wait<1>();
  __syncthreads();
  float dv_acc[NT][4];
  zero(dv_acc);
  if (owns)  // A^T gy
    warp_mma<NT, false, false, true>(dv_acc, X + r0 * lda + r0, lda,
                                     s4 + r0 * ld + e0, ld, Cp - r0);
  cp_wait<0>();
  __syncthreads();
  row_dots<HD>(sDdiag, s4, s1, nullptr, ld, Cp);  // ddiag = sum_e gy v
  lower_product<HD>(X, lda, s4, s1, ld, Cp);      // dA
  __syncthreads();

  // d_rP 2^j = gy S^T 2^j (by SG's column pieces) + dA kD', staged in dr
  {
    float acc[NT][4];
    zero(acc);
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      if (p > 0) {
        __syncthreads();
        load_piece<HD, SW>(SG, lds, Sc, p);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
      }
      if (owns)
        warp_mma<NT, true, true, true>(acc, s4 + r0 * ld + p * SW, ld,
                                       SG + e0 * lds, lds, SW);
    }
    if (owns) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= sSc[e0 + 8 * n + t2 + i % 2];
      warp_mma<NT, true, false, true>(acc, X + r0 * lda, lda, s3 + e0, ld,
                                      r0 + 16);
      store_tile<NT>(dr + base, st, acc, r0, e0, C);
    }
    // d_kD 2^-j = dA^T rP', staged in dk
    zero(acc);
    if (owns) {
      warp_mma<NT, false, false, true>(acc, X + r0 * lda + r0, lda,
                                       s2 + r0 * ld + e0, ld, Cp - r0);
      store_tile<NT>(dk + base, st, acc, r0, e0, C);
    }
  }
  __syncthreads();

  // the prefix again over w in s2 (cum kept), kT over k in s3
  load_rows<kThreads, HD>(s2, ld, w + base, st, C, Cp, 1.f);
  load_rows<kThreads, HD>(s3, ld, k + base, st, C, Cp, 0.f);
  cp_commit();
  load_piece<HD, SW>(SG, lds, Gc, 0);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  {
    float lw[MAXSL];
    prefix_pass1<kThreads, HD, MAXSL>(s2, ld, Cp, X, lw);
    __syncthreads();
    float off, tot;
    prefix_offsets<kThreads, HD>(X, off, tot);
    if (seg == 0) sTot[col] = tot;
#pragma unroll
    for (int i = 0; i < MAXSL; ++i)
      if (i < SL) {
        const int o = (t0 + i) * ld + col;
        const float cum = off + s2[o];
        s2[o] = cum;
        s3[o] = s3[o] * expf(tot - cum);
      }
  }
  cp_wait<0>();
  __syncthreads();
  // dv += kT G and d_kT = v G^T, by G's column pieces; dv + diag gy out
  {
    float acc[NT][4];
    zero(acc);
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      if (p > 0) {
        __syncthreads();
        load_piece<HD, SW>(SG, lds, Gc, p);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
      }
      if (owns && e0 / SW == p)
        warp_mma<NT, true, false, true>(dv_acc, s3 + r0 * ld, ld,
                                        SG + (e0 - p * SW), lds, HD);
      if (owns)
        warp_mma<NT, true, true, true>(acc, s1 + r0 * ld + p * SW, ld,
                                       SG + e0 * lds, lds, SW);
    }
    if (owns) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = r0 + g + 8 * hf, e = e0 + 8 * n + t2;
          const float dg = sDiag[t];
          const float2 gg = ld2(s4 + t * ld + e);
          dv_acc[n][2 * hf] = __fmaf_rn(dg, gg.x, dv_acc[n][2 * hf]);
          dv_acc[n][2 * hf + 1] = __fmaf_rn(dg, gg.y, dv_acc[n][2 * hf + 1]);
        }
      store_tile<NT>(dv + base, st, dv_acc, r0, e0, C);
      store_tile<NT>(dw + base, st, acc, r0, e0, C);
    }
  }
  // the staged d_rP, d_kD, d_kT are read back by other threads of this CTA
  __syncthreads();

  // the elementwise epilogue: one thread per (column, token segment)
  {
    const float ud = sU[col], tot = sTot[col];
    float sc, inv;
    column_scale(tot, sc, inv);
    // each token's dcum and gP, in this thread's own (t, col) places of
    // s1 and s3 (v and kT are done with)
    float *dc = s1 + col, *gp = s3 + col;
    float sumC = 0.f, sumF = 0.f, sumU = 0.f;
    // kLd tokens' loads at a time, all issued before the stores to dr and
    // dk (which the compiler cannot tell apart from the next tokens'
    // staged loads)
    constexpr int kLd = 4;
#pragma unroll 1
    for (int i0 = 0; i0 < SL; i0 += kLd) {
      float rr[kLd], kk[kLd], ww[kLd], drp[kLd], dkd[kLd], dkt[kLd];
#pragma unroll
      for (int j = 0; j < kLd; ++j) {
        const int t = t0 + i0 + j;
        if (i0 + j < SL && t < C) {
          const size_t o = base + t * st + col;
          rr[j] = r[o], kk[j] = k[o], ww[j] = w[o];
          drp[j] = dr[o], dkd[j] = dk[o], dkt[j] = dw[o];
        }
      }
#pragma unroll
      for (int j = 0; j < kLd; ++j) {
        const int t = t0 + i0 + j;
        if (i0 + j < SL && t < C) {
          const size_t o = base + t * st + col;
          const float cum = s2[t * ld + col];
          // P 2^-j and E 2^j, as d_rP and d_kD were staged
          const float P = expf(cum - logf(fmaxf(ww[j], 1e-38f))) * inv;
          const float E = t == C - 1 ? 0.f : expf(-cum) * sc;
          const float F = expf(tot - cum);
          const float dd = sDdiag[t];
          dr[o] = drp[j] * P + dd * ud * kk[j];
          dk[o] = dkd[j] * E + dkt[j] * F + dd * ud * rr[j];
          sumU = sumU + dd * rr[j] * kk[j];
          const float gP = drp[j] * rr[j] * P, gF = dkt[j] * kk[j] * F;
          const float dcum = gP - dkd[j] * kk[j] * E - gF;
          dc[t * ld] = dcum;
          gp[t * ld] = gP;
          sumC = sumC + dcum;
          sumF = sumF + gF;
        }
      }
    }
    float* segC = X;
    float* segF = X + NS * HD;
    float* segU = X + 2 * NS * HD;
    segC[seg * HD + col] = sumC;
    segF[seg * HD + col] = sumF;
    segU[seg * HD + col] = sumU;
    __syncthreads();
    // d_total = the state term + sum_t gF, on the chunk's last row: every
    // row's suffix sum holds it
    float acc = sDts[col], after = 0.f;
    for (int s2i = 0; s2i < NS; ++s2i) acc = acc + segF[s2i * HD + col];
    for (int s2i = seg + 1; s2i < NS; ++s2i)
      after = after + segC[s2i * HD + col];
    acc = acc + after;
    if (seg == 0) {
      float du_t = 0.f;
      for (int s2i = 0; s2i < NS; ++s2i) du_t = du_t + segU[s2i * HD + col];
      du[(size_t)tile * HD + col] = du_t;
    }
    float wq[MAXSL];  // w of the segment's tokens, loaded before the walk
#pragma unroll
    for (int i = 0; i < MAXSL; ++i)
      if (i < SL && t0 + i < C) wq[i] = w[base + (t0 + i) * st + col];
#pragma unroll
    for (int i = MAXSL - 1; i >= 0; --i) {
      const int t = t0 + i;
      if (i < SL && t < C) {
        const size_t o = base + t * st + col;
        const float ww = wq[i];
        acc = acc + dc[t * ld];
        const float dl = acc - gp[t * ld];
        dw[o] = ww > 1e-38f ? dl / ww : 0.f;
      }
    }
  }
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* gy, const float* gS, float* dr,
           float* dk, float* dv, float* dw, float* du, float* S, float* G,
           float* etot, float* dts, int B, int T, int H, int C, int uB,
           int uH, cudaStream_t stream) {
  const int Cp = pad32(C);
  const size_t gbytes = sizeof(float) * (size_t)GradLayout(Cp, HD).floats;
  const size_t ibytes = sizeof(float) * (size_t)inc_floats(Cp, HD);
  if (C > kMaxChunk || Cp > max_rows(HD) || gbytes > (size_t)kMaxSmem ||
      ibytes > (size_t)kMaxSmem)
    return kTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_chunk_bwd_increments<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ibytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rwkv_chunk_bwd_grads<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gbytes);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H, nc = T / C, tiles = BH * nc;
  rwkv_chunk_bwd_increments<HD><<<tiles, kIncThreads, ibytes, stream>>>(
      r, k, v, w, gy, S, G, etot, H, T, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)BH * HD * HD / 4;
  rwkv_chunk_bwd_chains<HD>
      <<<(unsigned)((n + kChainThreads - 1) / kChainThreads), kChainThreads,
         0, stream>>>(S, G, etot, dts, gS, BH, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv_chunk_bwd_grads<HD><<<tiles, kThreads, gbytes, stream>>>(
      r, k, v, w, u, gy, S, G, dts, dr, dk, dv, dw, du, H, T, C, uB, uH);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, gy, dr, dk, dv, dw (B,T,H,hd) f32 contiguous; u[b * uB + h *
// uH + d] f32; gS (B,H,hd,hd) f32 or null for zero; chunks of C tokens (T
// % C == 0); du (B,H,T/C,hd), each chunk's part of du. Scratch: S and G
// (B,H,T/C,hd,hd) f32 each, etot and dts (B,H,T/C,hd) f32 each. Returns -1
// for a chunk one CTA cannot hold, -2 for a head dim other than 16, 32, 64
// or 128 (nothing launched; K7's forward refuses the same), else a CUDA
// error code.
extern "C" int rwkv_chunk_bwd_launch(const void* r, const void* k,
                                     const void* v, const void* w,
                                     const void* u, const void* gy,
                                     const void* gS, void* dr, void* dk,
                                     void* dv, void* dw, void* du, void* S,
                                     void* G, void* etot, void* dts, int B,
                                     int T, int H, int hd, int C, int uB,
                                     int uH, void* stream) {
  if (B < 1 || H < 1 || C < 1 || T % C != 0)
    return (int)cudaErrorInvalidValue;
  const auto* fr = (const float*)r;
  const auto* fk = (const float*)k;
  const auto* fv = (const float*)v;
  const auto* fw = (const float*)w;
  const auto* fu = (const float*)u;
  const auto* fg = (const float*)gy;
  const auto* fgS = (const float*)gS;
  auto *fdr = (float*)dr, *fdk = (float*)dk, *fdv = (float*)dv,
       *fdw = (float*)dw, *fdu = (float*)du, *fS = (float*)S,
       *fG = (float*)G, *fe = (float*)etot, *fd = (float*)dts;
  auto* s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(fr, fk, fv, fw, fu, fg, fgS, fdr, fdk, fdv, fdw, fdu,
                        fS, fG, fe, fd, B, T, H, C, uB, uH, s);
    case 32:
      return launch<32>(fr, fk, fv, fw, fu, fg, fgS, fdr, fdk, fdv, fdw, fdu,
                        fS, fG, fe, fd, B, T, H, C, uB, uH, s);
    case 64:
      return launch<64>(fr, fk, fv, fw, fu, fg, fgS, fdr, fdk, fdv, fdw, fdu,
                        fS, fG, fe, fd, B, T, H, C, uB, uH, s);
    case 128:
      return launch<128>(fr, fk, fv, fw, fu, fg, fgS, fdr, fdk, fdv, fdw,
                         fdu, fS, fG, fe, fd, B, T, H, C, uB, uH, s);
    default:
      return kBadHeadDim;
  }
}
