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
//   3. rwkv_chunk_bwd_grads, a persistent grid of one CTA (512 threads,
//      16 warps) per SM walking the tiles in order, with no staging in
//      device memory. Each tile:
//        its copies: w, r and k, then gy, v and the first columns of S
//        and G, each operand one TMA box of a 2-D tensor map (its C rows
//        of the head's hd + 4 columns land in a padded slot: the 4 extra
//        columns, the next head's or zeros, fall in the padding), issued
//        by one thread and waited on by mbarrier;
//        the prefix of logw once, in the fragment layout: a warp's 16 rows
//        by shuffles, the row blocks' sums in shared memory; cum stays
//        there; rP' = r P 2^-j and kD' = kD 2^j over r and k (2^j ~
//        exp(total / 2) of the column: an exact scaling, A is the same,
//        and a decay under the clamp leaves no denormal operand), P taken
//        as exp of the previous token's cum (the same number);
//        the products, by units of 16 rows (tokens) x 64 columns (x 32 at
//        head dim 128, two units a warp), warps 0-7 the query side and dv
//        of a unit, warps 8-15 its dk, so that dv, dk and dr are each
//        finished in a warp's registers and written once. The key side of
//        rows s: for each later block of 16 tokens t, a block of A^T =
//        kD' rP'^T (or dA^T = v gy^T) is formed in registers, masked on
//        the diagonal and fed as A fragments (an m16n8 accumulator is an
//        m16k8 fragment under warp_mma's k order) into dv += A^T gy (or
//        d_kD 2^-j += dA^T rP'); dv += kT G (kT = k F formed as
//        fragments) + diag gy; dk = d_kD E + d_kT F + ddiag u r with d_kT
//        = v G^T. The query side of rows t: d_rP 2^j = gy S^T 2^j + dA
//        kD' over blocks of dA = gy v^T formed again; dr = d_rP P + ddiag
//        u k. Each element's factors come from cum as a product finishes:
//        gP and -gE - gF go to the slots of v and gy once every product is
//        done, sum_t gF (d_total's part) and du's part by fixed shuffle
//        trees;
//        dw: the suffix sum of dcum = gP - gE - gF down each column, a
//        warp's 16 rows by shuffles, the row blocks' sums in shared
//        memory, over w copied again into the states' place (the folds
//        read r and k again too, from device memory). du is written per
//        tile, (B,H,nc,hd); the wrapper sums it in torch.
//      While a tile takes its dw, the next one's w, r and k are on the way;
//      its gy, v and states while it takes its prefix.
//   Shared memory of the gradients' CTA: five (Cp x hd+4) slots (w then
//   cum, r then rP', k then kD', gy then -gE - gF, v then gP), S's and G's
//   columns (hd x hd+4 each; 128 x 36, four pieces, at head dim 128) and
//   rows and columns of sums: 217,880 bytes at head dim 64 and chunk 128,
//   one CTA a SM.
//
// ptxas (CUDA 12, sm_90a): scripts/scan_grad_probe.py prints nvcc's report
// of each launch's registers, spills and shared memory, and the CTAs of
// each launch resident on one SM.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 512;     // the gradients' CTA: 16 warps
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
// the warp tiles of the increments' (hd x hd) products: 16 rows x 8 NT
// columns
__host__ __device__ constexpr int tile_nt(int hd) {
  return hd / 16 < 1 ? 1 : (hd / 16 > 4 ? 4 : hd / 16);
}
// the gradients' warp tile: 16 rows x 8 NT columns, the whole head dim up
// to 64, a quarter of it at 128 (whose warps take two tiles each)
__host__ __device__ constexpr int grad_nt(int hd) {
  return hd > 64 ? 4 : hd / 8;
}
// the state's columns the gradients' CTA holds at once (a quarter at 128)
__host__ __device__ constexpr int piece_w(int hd) {
  return hd > 64 ? 32 : hd;
}

// Shared memory of the gradients' CTA, in floats. Rows of Cp tokens, hd + 4
// floats each (conflict free read down a column, two-way along a row).
struct GradLayout {
  int ld, lds, cum, rp, kd, gy, v, ss, sgm, ddiag, diagp, tot, sc, inv, u,
      dts, colf, bsum, dup, bar, floats;
  __host__ __device__ GradLayout(int Cp, int hd) {
    const int rbs = max_rows(hd) / 16;  // row blocks of a tile at most
    ld = hd + 4;
    lds = piece_w(hd) + 4;
    cum = 0;                  // w -> cum
    rp = cum + Cp * ld;       // r -> rP'
    kd = rp + Cp * ld;        // k -> kD'
    gy = kd + Cp * ld;        // gy, then -gE - gF
    v = gy + Cp * ld;         // v, then gP
    ss = v + Cp * ld;         // S's columns (hd x lds), then w for dw
    sgm = ss + hd * lds;      // G's columns (hd x lds)
    const int states = 2 * hd * lds > Cp * ld ? 2 * hd * lds : Cp * ld;
    ddiag = ss + states;      // Cp
    diagp = ddiag + Cp;       // diag by column part, (16 / rbs) x Cp
    tot = diagp + 16 / rbs * Cp;  // total, hd
    sc = tot + hd;            // the column's scale 2^j, hd
    inv = sc + hd;            // 2^-j, hd
    u = inv + hd;             // hd
    dts = u + hd;             // d_total's state term, hd
    colf = dts + hd;          // sum_t gF by row block, rbs x hd
    bsum = colf + rbs * hd;   // logw's, then dcum's sums by row block
    dup = bsum + rbs * hd;    // du's parts by row block
    bar = dup + rbs * hd;     // three mbarriers (8 bytes each; every
    floats = bar + 6;         // offset is even)
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

// A thread's segment offset and its column's total from the segments'
// sums of logw (seg[s HD + col]), added in segment order.
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

// the inclusive prefix (UP) or suffix sum over the 8 rows g of a warp's
// tile (lanes 4 apart) of x, in a fixed order
template <bool UP>
__device__ __forceinline__ float scan_rows(float x) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const float y = UP ? __shfl_up_sync(FULL_MASK, x, 4 * d)
                       : __shfl_down_sync(FULL_MASK, x, 4 * d);
    if (UP ? g >= d : g + d < 8) x = UP ? y + x : x + y;
  }
  return x;
}

// the sum of x over the 8 rows g of a warp's tile, in every lane
__device__ __forceinline__ float sum_rows(float x) {
  x += __shfl_xor_sync(FULL_MASK, x, 4);
  x += __shfl_xor_sync(FULL_MASK, x, 8);
  x += __shfl_xor_sync(FULL_MASK, x, 16);
  return x;
}

// the compiler moves no load or store across this: it bounds how many
// device-memory loads an unrolled loop issues ahead (and the registers
// they hold)
__device__ __forceinline__ void hold_loads() {
  asm volatile("" ::: "memory");
}

// the 16 x 16 block x = P Q^T over HD columns (P and Q 16 rows of a slot,
// stride ld, both read along rows) as two 16 x 8 accumulator tiles
template <int HD>
__device__ __forceinline__ void block16(float (&x)[2][4], const float* P,
                                        const float* Q, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  zero(x);
#pragma unroll 1
  for (int k0 = 0; k0 < HD; k0 += 8) {
    const float2 a0 = ld2(P + g * ld + k0 + t2),
                 a1 = ld2(P + (g + 8) * ld + k0 + t2);
    uint32_t ah[4], al[4];
    split_rn(a0.x, ah[0], al[0]);
    split_rn(a1.x, ah[1], al[1]);
    split_rn(a0.y, ah[2], al[2]);
    split_rn(a1.y, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 b = ld2(Q + (8 * n + g) * ld + k0 + t2);
      uint32_t bh0, bl0, bh1, bl1;
      split_rn(b.x, bh0, bl0);
      split_rn(b.y, bh1, bl1);
      mma_tf32(x[n], al, bh0, bh1);
      mma_tf32(x[n], ah, bl0, bl1);
      mma_tf32(x[n], ah, bh0, bh1);
    }
  }
}

// zero what a strict triangle drops in a diagonal block (entry i of tile
// n at row g + 8 (i / 2), column 8 n + 2 (lane % 4) + i % 2): UPPER keeps
// row < column (A^T, dA^T), else column < row (dA)
template <bool UPPER>
__device__ __forceinline__ void mask_block(float (&x)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i / 2), col = 8 * n + t2 + i % 2;
      if (UPPER ? col <= row : row <= col) x[n][i] = 0.f;
    }
}

// acc (16 x 8 NT) += X B: X a 16 x 16 block in accumulator tiles (tile kk
// is the A fragment of k = 8 kk .. 8 kk + 7 in warp_mma's k order: entries
// 0, 2, 1, 3), B 16 rows of 8 NT columns at Q (stride ld), read down its
// columns
template <int NT>
__device__ __forceinline__ void frag_mma(float (&acc)[NT][4],
                                         const float (&x)[2][4],
                                         const float* Q, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t ah[4], al[4];
    split_rn(x[kk][0], ah[0], al[0]);
    split_rn(x[kk][2], ah[1], al[1]);
    split_rn(x[kk][1], ah[2], al[2]);
    split_rn(x[kk][3], ah[3], al[3]);
    const float* q = Q + (8 * kk + t2) * ld + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_rn(q[8 * n], bh0, bl0);
      split_rn(q[ld + 8 * n], bh1, bl1);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
}

// acc (16 x 8 NT) += kT G over HD: kT = k exp(total - cum) of the warp's
// 16 rows from r0 formed as A fragments (k in device memory at kg, rows st
// floats apart, 0 from row C on; cum in shared memory, stride ld); G's
// columns of acc at Q (HD rows of lds)
template <int HD, int NT>
__device__ __forceinline__ void kt_g(float (&acc)[NT][4], const float* kg,
                                     size_t st, int r0, int C,
                                     const float* CUM, const float* tot,
                                     int ld, const float* Q, int lds) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int ta = r0 + g, tb = ta + 8;
  const float *ka = kg + ta * st + t2, *kb = ka + 8 * st;
#pragma unroll 2
  for (int k0 = 0; k0 < HD; k0 += 8) {
    const float2 z = make_float2(0.f, 0.f);
    const float2 k0v = ta < C ? ld2(ka + k0) : z,
                 k1v = tb < C ? ld2(kb + k0) : z,
                 c0 = ld2(CUM + ta * ld + k0 + t2),
                 c1 = ld2(CUM + tb * ld + k0 + t2),
                 tt = ld2(tot + k0 + t2);
    uint32_t ah[4], al[4];
    split_rn(k0v.x * expf(tt.x - c0.x), ah[0], al[0]);
    split_rn(k1v.x * expf(tt.x - c1.x), ah[1], al[1]);
    split_rn(k0v.y * expf(tt.y - c0.y), ah[2], al[2]);
    split_rn(k1v.y * expf(tt.y - c1.y), ah[3], al[3]);
    const float* q = Q + (k0 + t2) * lds + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_rn(q[8 * n], bh0, bl0);
      split_rn(q[lds + 8 * n], bh1, bl1);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
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

// and into shared memory (rows ld floats apart)
template <int NT>
__device__ __forceinline__ void put_tile(float* dst, int ld,
                                         const float (&acc)[NT][4], int r0,
                                         int e0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(dst + (r0 + g + 8 * hf) * ld + e0 + 8 * n +
                                 t2) =
          make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
}

// the row sums sum_e a[t][e] b[t][e] of the Cp rows, four lanes a token,
// into out[t]
template <int HD>
__device__ __forceinline__ void row_dots(float* out, const float* a,
                                         const float* b, int ld, int Cp) {
  const int part = threadIdx.x & 3;
  for (int t0 = 0; t0 < Cp; t0 += kThreads / 4) {
    const int t = t0 + (threadIdx.x >> 2);
    float s = 0.f;
    if (t < Cp)
      for (int e = part; e < HD; e += 4) s = s + a[t * ld + e] * b[t * ld + e];
    s += __shfl_xor_sync(FULL_MASK, s, 1);
    s += __shfl_xor_sync(FULL_MASK, s, 2);
    if (part == 0 && t < Cp) out[t] = s;
  }
}

// the next piece of a state by every thread, once the last one is done with
template <int HD, int SW>
__device__ __forceinline__ void next_piece(float* sG, int lds,
                                           const float* src, int p) {
  __syncthreads();
  load_piece<HD, SW>(sG, lds, src, p);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
}

// one box of a 2-D tensor map (column x, row y) into shared memory,
// completing `bar`'s transaction count
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// The copies of a tile, one TMA box an operand, each group completing its
// own mbarrier (issued by one thread; the TMA engine moves the bytes): w,
// r and k; gy, v and the first columns of S and G; and, for the dw walk, w
// again over the states' place. An operand's box is its C rows of the
// head's hd + 4 columns: the rows land in the slots' padded layout (the 4
// extra columns are the next head's, or zeros past the last, in the
// padding).
struct Maps {
  CUtensorMap r, k, v, w, gy, S, G;
};
template <int HD>
__device__ __forceinline__ void issue_wrk(const GradLayout& L, float* smem,
                                          const Maps& m, int x, int y,
                                          int C, uint32_t bar) {
  tc::mbar_expect_tx(bar, 3u * (HD + 4) * C * 4);
  tma_box(smem + L.cum, &m.w, bar, x, y);
  tma_box(smem + L.rp, &m.r, bar, x, y);
  tma_box(smem + L.kd, &m.k, bar, x, y);
}
template <int HD, int SW>
__device__ __forceinline__ void issue_gvs(const GradLayout& L, float* smem,
                                          const Maps& m, int x, int y,
                                          int tile, int C, uint32_t bar) {
  tc::mbar_expect_tx(bar, (2u * (HD + 4) * C + 2u * (SW + 4) * HD) * 4);
  tma_box(smem + L.gy, &m.gy, bar, x, y);
  tma_box(smem + L.v, &m.v, bar, x, y);
  tma_box(smem + L.ss, &m.S, bar, 0, tile * HD);
  tma_box(smem + L.sgm, &m.G, bar, 0, tile * HD);
}

// an L2 prefetch of rows r0 .. r0 + 15 (below C) of a tile's (B,T,H,HD)
// operand, a 128-byte line a lane
template <int HD>
__device__ __forceinline__ void prefetch_rows(const float* src, size_t st,
                                              int r0, int C) {
  constexpr int LINES = HD / 32 > 0 ? HD / 32 : 1;  // lines a row
  for (int i = threadIdx.x & 31; i < 16 * LINES; i += 32) {
    const int t = r0 + i / LINES;
    if (t < C)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          src + t * st + (i % LINES) * 32));
  }
}

// the offset of a (batch, head, chunk) tile's first element in a
// (B,T,H,HD) tensor
template <int HD>
__device__ __forceinline__ size_t tile_base(int tile, int nc, int H, int T,
                                            int C) {
  const int bh = tile / nc;
  return ((size_t)(bh / H) * T + (size_t)(tile % nc) * C) * H * HD +
         (size_t)(bh % H) * HD;
}

// 3. dr, dk, dv, dw and du's per-tile part of the (batch, head, chunk)
// tiles (tile = (b H + h) nc + c) blockIdx.x, + gridDim.x, ..., from
// S_{c-1} (S), G_c (G) and d_total's state term (dts). r, k, v, w, gy,
// dr, dk, dv, dw (B,T,H,HD); u[b uB + h uH + d]; du (B,H,nc,HD).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) rwkv_chunk_bwd_grads(
    const __grid_constant__ Maps maps, const float* __restrict__ r,
    const float* __restrict__ k, const float* __restrict__ u,
    const float* __restrict__ S, const float* __restrict__ G,
    const float* __restrict__ dts, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du, int H, int T, int C, int uB, int uH,
    int tiles) {
  // the prefix's and the walk's unit: 16 rows x WP columns, PU a tile
  constexpr int RBS = max_rows(HD) / 16, CQ = 16 / RBS, WP = HD / CQ,
                NTP = WP / 8, PU = RBS * CQ;
  // the products' unit: 16 rows x WC columns, 8 UPW of them a tile
  constexpr int NT = grad_nt(HD), WC = 8 * NT, CPN = HD / WC,
                UPW = CPN * RBS / 8;
  constexpr int SW = piece_w(HD), NP = HD / SW;
  static_assert(WC == SW, "a unit's columns are one piece of a state");
  // (the TMA boxes land at multiples of 128 bytes from here)
  extern __shared__ __align__(128) float gsmem[];
  float* smem = gsmem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int Cp = pad32(C), nc = T / C, RB = Cp / 16;
  const GradLayout L(Cp, HD);
  // the products' units: 16 rows by WC columns, 8 UPW of them (row blocks;
  // quarters of the columns at head dim 128). Warps 0-7 take the query side
  // and dv of UPW each, warps 8-15 dk of UPW each; the two warps of a role
  // on a sub-partition (w, w + 4) take units whose work sums alike (row
  // blocks i, 7 - i).
  const bool query = warp < 8;
  const size_t st = (size_t)H * HD;
  // the mbarriers of the tile's copies: w, r and k; gy, v and the
  // states; w for the walk. The last warp issues every copy.
  const uint32_t barA = tc::smem_u32(smem + L.bar), barB = barA + 8,
                 barW = barA + 16;
  const bool issuer = tid == kThreads - 1;
  if (tid == 0) {
    tc::mbar_init(barA, 1);
    tc::mbar_init(barB, 1);
    tc::mbar_init(barW, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad rows past C: w 1, the rest 0 (the copies write rows < C)
  for (int i = tid; i < (Cp - C) * HD; i += kThreads) {
    const int o = (C + i / HD) * L.ld + i % HD;
    smem[L.cum + o] = 1.f;
    smem[L.rp + o] = smem[L.kd + o] = smem[L.gy + o] = smem[L.v + o] = 0.f;
  }
  __syncthreads();  // the mbarriers are set up before any copy completes
  // a tile's box: the head's columns from x, the chunk's rows from y
  const auto box_x = [=](int tile) { return (tile / nc) % H * HD; };
  const auto box_y = [=](int tile) {
    return (tile / nc) / H * T + tile % nc * C;
  };
  int tile = blockIdx.x;
  if (tile < tiles && issuer) {
    issue_wrk<HD>(L, smem, maps, box_x(tile), box_y(tile), C, barA);
    issue_gvs<HD, SW>(L, smem, maps, box_x(tile), box_y(tile), tile, C,
                      barB);
  }
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    // the slots' addresses and the row stride, opaque to the compiler a
    // tile at a time: it forms what a tile needs in the tile, rather than
    // holding every address across the tiles (and spilling)
    int z = 0;
    asm volatile("" : "+r"(z));
    const int ld = L.ld + z, lds = L.lds + z;
    float *sCum = smem + (L.cum + z), *sRp = smem + (L.rp + z),
          *sKd = smem + (L.kd + z), *sGy = smem + (L.gy + z),
          *sV = smem + (L.v + z), *sS = smem + (L.ss + z),
          *sG = smem + (L.sgm + z), *sDdiag = smem + (L.ddiag + z),
          *sDiagp = smem + (L.diagp + z), *sTot = smem + (L.tot + z),
          *sSc = smem + (L.sc + z), *sInv = smem + (L.inv + z),
          *sU = smem + (L.u + z), *sDts = smem + (L.dts + z),
          *sColF = smem + (L.colf + z), *sBsum = smem + (L.bsum + z),
          *sDup = smem + (L.dup + z);
    const int bh = tile / nc, b = bh / H, h = bh % H;
    const size_t base = tile_base<HD>(tile, nc, H, T, C);
    const int next = tile + gridDim.x;
    if (tid < HD) {
      sU[tid] = u[(size_t)b * uB + (size_t)h * uH + tid];
      sDts[tid] = dts[(size_t)tile * HD + tid];
    }
    for (int i = tid; i < (Cp - C) * HD; i += kThreads)
      sCum[(C + i / HD) * ld + i % HD] = 1.f;  // the prefix wrote cum there
    tc::mbar_wait(barA, it & 1);  // w, r and k
    __syncthreads();

    // the prefix of logw down each column: within a unit's 16 rows by
    // shuffles (the local prefix over w), the row blocks' sums through
    // shared memory
    for (int pu = warp; pu < PU; pu += kWarps) {
      const int pb = pu / CQ, pe0 = (pu % CQ) * WP, p0 = pb * 16;
      if (pb >= RB) continue;
      // the unit's columns, two a lane per tile of 8
#pragma unroll 2
      for (int c = 0; c < 2 * NTP; ++c) {
        const int e = pe0 + 8 * (c >> 1) + t2 + (c & 1);
        float* c0 = sCum + (p0 + g) * ld + e;
        const float lo = scan_rows<true>(logf(fmaxf(c0[0], 1e-38f)));
        const float top = __shfl_sync(FULL_MASK, lo, 28 + (lane & 3));
        const float hi =
            top + scan_rows<true>(logf(fmaxf(c0[8 * ld], 1e-38f)));
        c0[0] = lo;
        c0[8 * ld] = hi;
        if (g == 7) sBsum[pb * HD + e] = hi;
      }
    }
    tc::mbar_wait(barB, it & 1);  // gy, v and the states
    __syncthreads();
    if (tid < HD) {
      // each row block's offset (over its sum) and the column's total, a
      // thread a column, the row blocks in order
      float tot = 0.f;
      for (int q = 0; q < RB; ++q) {
        const float sum = sBsum[q * HD + tid];
        sBsum[q * HD + tid] = tot;
        tot = tot + sum;
      }
      float sc, inv;
      column_scale(tot, sc, inv);
      sTot[tid] = tot, sSc[tid] = sc, sInv[tid] = inv;
    }
    row_dots<HD>(sDdiag, sGy, sV, ld, Cp);  // ddiag = sum_e gy v
    __syncthreads();
    for (int pu = warp; pu < PU; pu += kWarps) {
      const int pb = pu / CQ, pe0 = (pu % CQ) * WP, p0 = pb * 16;
      if (pb >= RB) continue;
      float dg[2] = {0.f, 0.f};  // this lane's part of diag, rows g, g + 8
#pragma unroll 2
      for (int c = 0; c < 2 * NTP; ++c) {
        const int e = pe0 + 8 * (c >> 1) + t2 + (c & 1);
        const float off = sBsum[pb * HD + e], sc = sSc[e], inv = sInv[e];
        // the local prefix of rows g and g + 8, and of the rows above (the
        // block's offset above its first row)
        const float in0 = sCum[(p0 + g) * ld + e],
                    in1 = sCum[(p0 + g + 8) * ld + e];
        const float top = __shfl_sync(FULL_MASK, in0, 28 + (lane & 3)),
                    up0 = __shfl_up_sync(FULL_MASK, in0, 4),
                    up1 = __shfl_up_sync(FULL_MASK, in1, 4);
        const float ud = sU[e];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = p0 + g + 8 * hf, o = t * ld + e;
          const float cum = off + (hf ? in1 : in0);
          const float prev = hf == 0 ? (g == 0 ? off : off + up0)
                                     : off + (g == 0 ? top : up1);
          const float rr = sRp[o], kk = sKd[o];
          dg[hf] = dg[hf] + rr * ud * kk;
          // rP' = r P 2^-j (P the exp of the previous token's cum), kD' =
          // k E 2^j (0 at the chunk's last token)
          sRp[o] = rr * (expf(prev) * inv);
          sKd[o] = t == C - 1 ? 0.f : kk * (expf(-cum) * sc);
          sCum[o] = cum;
        }
      }
      // diag's part over this unit's columns
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float s = dg[hf];
        s += __shfl_xor_sync(FULL_MASK, s, 1);
        s += __shfl_xor_sync(FULL_MASK, s, 2);
        if ((lane & 3) == 0) sDiagp[(pu % CQ) * Cp + p0 + g + 8 * hf] = s;
      }
    }
    __syncthreads();

    // the products, a unit at a time, two accumulators: X (the query side:
    // dv, then gy S^T, then gP; dk: d_kD, then -gE - gF) and Y (the query
    // side: dA kD', then dr; dk: d_kT, then dk); each unit's gP or
    // -gE - gF kept for after every product
    float keep[UPW][NT][4];
#pragma unroll
    for (int up = 0; up < UPW; ++up) {
      const int unit = up * 8 + (warp & 7) + z;
      const int rb = UPW > 1 ? unit % RBS : (unit < 4 ? unit : 11 - unit);
      const int cpart = UPW > 1 ? unit / RBS : 0;
      const int r0 = rb * 16, e0 = cpart * WC;
      const bool act = rb < RB;
      float X[NT][4], Y[NT][4];
      zero(X);
      if (act) {  // the folds' rows of r and k, into L2 ahead of them
        prefetch_rows<HD>(k + base, st, r0, C);
        if (!query) prefetch_rows<HD>(r + base, st, r0, C);
      }
      if (act) {
        // the key side of rows s, by blocks of 16 later tokens t: dv =
        // A^T gy (A^T = kD' rP'^T) or d_kD 2^-j = dA^T rP' (dA^T = v gy^T)
#pragma unroll 1
        for (int tb = r0; tb < Cp; tb += 16) {
          float x[2][4];
          block16<HD>(x, (query ? sKd : sV) + r0 * ld,
                      (query ? sRp : sGy) + tb * ld, ld);
          if (tb == r0) mask_block<true>(x);
          frag_mma<NT>(X, x, (query ? sGy : sRp) + tb * ld + e0, ld);
        }
      }
      // dv += kT G; d_kT = v G^T (G by its column pieces)
      zero(Y);
#pragma unroll 1
      for (int p = 0; p < NP; ++p) {
        if (NP > 1 && (up > 0 || p > 0))
          next_piece<HD, SW>(sG, lds, G + (size_t)tile * HD * HD, p);
        if (!act) continue;
        if (!query)
          warp_mma<NT, true, true, true>(Y, sV + r0 * ld + p * SW, ld,
                                         sG + e0 * lds, lds, SW);
        else if (p == cpart)  // the unit's columns are this piece
          kt_g<HD, NT>(X, k + base, st, r0, C, sCum, sTot, ld, sG, lds);
      }
      if (act && query) {  // dv + diag gy, written
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = r0 + g + 8 * (i / 2), e = e0 + 8 * n + t2 + i % 2;
            float dg = 0.f;
            for (int q = 0; q < CQ; ++q) dg = dg + sDiagp[q * Cp + t];
            X[n][i] = __fmaf_rn(dg, sGy[t * ld + e], X[n][i]);
          }
        store_tile<NT>(dv + base, st, X, r0, e0, C);
        zero(X);
      }
      if (act && !query) {
        // dk = d_kD E + d_kT F + ddiag u r; -gE - gF over d_kD's place,
        // and by column: sum_t gF and du's part sum_t ddiag r k
        const size_t row = base + (r0 + g) * st + e0 + t2;
        const float *ra = r + row, *ka = k + row;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n % 2 == 0) hold_loads();
          float cf[2] = {0.f, 0.f}, cu[2] = {0.f, 0.f};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = r0 + g + 8 * hf, e = e0 + 8 * n + t2;
            const float2 z = make_float2(0.f, 0.f);
            const float2 rr = t < C ? ld2(ra + hf * 8 * st + 8 * n) : z,
                         kk = t < C ? ld2(ka + hf * 8 * st + 8 * n) : z;
            const float dd = sDdiag[t];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int i = 2 * hf + j, o = t * ld + e + j;
              const float cum = sCum[o];
              const float E = t == C - 1 ? 0.f : expf(-cum) * sSc[e + j];
              const float F = expf(sTot[e + j] - cum);
              const float r1 = j ? rr.y : rr.x, k1 = j ? kk.y : kk.x;
              const float x = X[n][i], y = Y[n][i];
              Y[n][i] = x * E + y * F + dd * sU[e + j] * r1;
              const float gF = y * (k1 * F);
              X[n][i] = -(x * sKd[o]) - gF;
              cf[j] = cf[j] + gF;
              cu[j] = cu[j] + dd * r1 * k1;
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float sf = sum_rows(cf[j]), su = sum_rows(cu[j]);
            if (g == 0) {
              sColF[rb * HD + e0 + 8 * n + t2 + j] = sf;
              sDup[rb * HD + e0 + 8 * n + t2 + j] = su;
            }
          }
        }
        store_tile<NT>(dk + base, st, Y, r0, e0, C);
      }
      // the query side of rows t: d_rP 2^j = gy S^T 2^j (S by its column
      // pieces) + dA kD' by blocks of 16 earlier tokens s (dA = gy v^T)
      const bool qact = query && act;
#pragma unroll 1
      for (int p = 0; p < NP; ++p) {
        if (NP > 1 && (up > 0 || p > 0))
          next_piece<HD, SW>(sS, lds, S + (size_t)tile * HD * HD, p);
        if (qact)
          warp_mma<NT, true, true, true>(X, sGy + r0 * ld + p * SW, ld,
                                         sS + e0 * lds, lds, SW);
      }
      if (qact) {
#pragma unroll 1
        for (int sb = 0; sb <= r0; sb += 16) {
          float x[2][4];
          block16<HD>(x, sGy + r0 * ld, sV + sb * ld, ld);
          if (sb == r0) mask_block<false>(x);
          frag_mma<NT>(Y, x, sKd + sb * ld + e0, ld);
        }
        // dr = d_rP P + ddiag u k; gP = d_rP r P over gy S^T's place
        const float* ka = k + base + (r0 + g) * st + e0 + t2;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n % 2 == 0) hold_loads();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = r0 + g + 8 * hf, e = e0 + 8 * n + t2;
            const float2 kk = t < C ? ld2(ka + hf * 8 * st + 8 * n)
                                    : make_float2(0.f, 0.f);
            const float dd = sDdiag[t];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int i = 2 * hf + j, o = t * ld + e + j;
              const float drp = X[n][i] * sSc[e + j] + Y[n][i];
              const float before = sCum[t == 0 ? o : o - ld];
              const float P = expf(t == 0 ? 0.f : before) * sInv[e + j];
              Y[n][i] = drp * P + dd * sU[e + j] * (j ? kk.y : kk.x);
              X[n][i] = drp * sRp[o];
            }
          }
        }
        store_tile<NT>(dr + base, st, Y, r0, e0, C);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) keep[up][n][i] = X[n][i];
    }
    __syncthreads();  // every product done: the slots are free
    if (issuer) {
      tc::mbar_expect_tx(barW, (HD + 4u) * C * 4);
      tma_box(sS, &maps.w, barW, box_x(tile), box_y(tile));
      if (next < tiles)
        issue_wrk<HD>(L, smem, maps, box_x(next), box_y(next), C, barA);
    }
    // gP over v, -gE - gF over gy
#pragma unroll
    for (int up = 0; up < UPW; ++up) {
      const int unit = up * 8 + (warp & 7) + z;
      const int rb = UPW > 1 ? unit % RBS : (unit < 4 ? unit : 11 - unit);
      if (rb < RB)
        put_tile<NT>(query ? sV : sGy, ld, keep[up], rb * 16,
                     (UPW > 1 ? unit / RBS : 0) * WC);
    }
    __syncthreads();

    // dw: dlogw = the suffix sum of dcum (= gP - gE - gF; d_total, the
    // state term + sum_t gF, on the chunk's last row) - gP, down each
    // column: within a unit's 16 rows by shuffles (the local suffix over
    // -gE - gF), the row blocks' sums through shared memory
    for (int pu = warp; pu < PU; pu += kWarps) {
      const int pb = pu / CQ, pe0 = (pu % CQ) * WP, p0 = pb * 16;
      if (pb >= RB) continue;
#pragma unroll 2
      for (int c = 0; c < 2 * NTP; ++c) {
        const int e = pe0 + 8 * (c >> 1) + t2 + (c & 1);
        const int o = (p0 + g) * ld + e;
        const float d0 = sV[o] + sGy[o],
                    d1 = sV[o + 8 * ld] + sGy[o + 8 * ld];
        const float s1 = scan_rows<false>(d1);
        const float s0 =
            scan_rows<false>(d0) + __shfl_sync(FULL_MASK, s1, lane & 3);
        sGy[o] = s0;
        sGy[o + 8 * ld] = s1;
        if (g == 0) sBsum[pb * HD + e] = s0;
      }
    }
    __syncthreads();
    if (tid < HD) {
      // du's part of this tile, the row blocks in order; d_total (the
      // state term + sum_t gF) + the later row blocks' sums of dcum, over
      // each block's sum
      float s = 0.f, later = sDts[tid];
      for (int q = 0; q < RB; ++q) {
        s = s + sDup[q * HD + tid];
        later = later + sColF[q * HD + tid];
      }
      du[(size_t)tile * HD + tid] = s;
      for (int q = RB - 1; q >= 0; --q) {
        const float sum = sBsum[q * HD + tid];
        sBsum[q * HD + tid] = later;
        later = later + sum;
      }
    }
    __syncthreads();
    tc::mbar_wait(barW, it & 1);  // w again, over the states
    for (int pu = warp; pu < PU; pu += kWarps) {
      const int pb = pu / CQ, pe0 = (pu % CQ) * WP, p0 = pb * 16;
      if (pb >= RB) continue;
#pragma unroll 2
      for (int c = 0; c < 2 * NTP; ++c) {
        const int e = pe0 + 8 * (c >> 1) + t2 + (c & 1);
        const float later = sBsum[pb * HD + e];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = p0 + g + 8 * hf, o = t * ld + e;
          if (t < C) {
            const float ww = sS[o];
            const float dl = (later + sGy[o]) - sV[o];
            dw[base + t * st + e] = ww > 1e-38f ? dl / ww : 0.f;
          }
        }
      }
    }
    __syncthreads();
    if (issuer && next < tiles)
      issue_gvs<HD, SW>(L, smem, maps, box_x(next), box_y(next), next, C,
                        barB);
  }
}

// a (rows x cols) row-major f32 tensor as a 2-D map of boxes of box_cols x
// box_rows, no swizzle (a box lands in shared memory row after row, rows
// box_cols floats apart); columns and rows past the tensor read as zeros
bool encode_f32(CUtensorMap* map, const void* ptr, int cols, int rows,
                int box_cols, int box_rows) {
  const tc::EncodeTiled fn = tc::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  // the gradients' persistent grid: every CTA that fits on the card at
  // once, none past the tiles
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rwkv_chunk_bwd_grads<HD>, kThreads, gbytes);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H, nc = T / C, tiles = BH * nc;
  const long resident = (long)sm_count() * (per_sm > 0 ? per_sm : 1);
  constexpr int SW = piece_w(HD);
  Maps maps;
  const int cols = H * HD, rows = B * T;
  if (!encode_f32(&maps.r, r, cols, rows, HD + 4, C) ||
      !encode_f32(&maps.k, k, cols, rows, HD + 4, C) ||
      !encode_f32(&maps.v, v, cols, rows, HD + 4, C) ||
      !encode_f32(&maps.w, w, cols, rows, HD + 4, C) ||
      !encode_f32(&maps.gy, gy, cols, rows, HD + 4, C) ||
      !encode_f32(&maps.S, S, HD, tiles * HD, SW + 4, HD) ||
      !encode_f32(&maps.G, G, HD, tiles * HD, SW + 4, HD))
    return (int)cudaErrorInvalidValue;
  const int grid = resident > 0 && resident < tiles ? (int)resident : tiles;
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
  rwkv_chunk_bwd_grads<HD><<<grid, kThreads, gbytes, stream>>>(
      maps, r, k, u, S, G, dts, dr, dk, dv, dw, du, H, T, C, uB, uH, tiles);
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
