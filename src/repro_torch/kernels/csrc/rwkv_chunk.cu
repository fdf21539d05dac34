// K7: the chunked RWKV6 WKV for Hopper (sm_90a), f32 in and out.
//
// Replaces repro/kernels/rwkv_chunk.py:rwkv_chunked (_rwkv_kernel). The
// TPU kernel walks the chunks of one (batch, head) on a sequential grid
// axis with the (hd, hd) state in VMEM scratch. Here every (batch, head,
// chunk) tile is computed on its own, and only the state carry is chained.
//
// The math is the reference's exp-log form. Per chunk of C tokens, with
// logw = log(max(w, 1e-38)) and cum its inclusive prefix over the chunk:
//   rP = r exp(cum - logw),  kD = k exp(-cum),  kT = k exp(total - cum)
//   A[t][s] = rP_t . kD_s for s < t,  diag_t = sum_d r u k
//   y_c = A v + diag v + rP S_{c-1}
//   S_c = exp(total) S_{c-1} + kT^T v,   S_{-1} = 0.
// Everything but the rP S_{c-1} term and the carry is independent across
// chunks, and the carry is elementwise in (d, e).
//
// Bound on this card: at the rwkv6-3b prefill (B 4, T 2048, H 40 heads of
// 64, C 128) the function moves 420 MB (r, k, v, w read once, y written
// once: 125 us at 3.35 TB/s) and needs 6.8 GFLOP counted from the token
// recurrence (102 us at 67 TFLOP/s); the chunked form computes 10.7 GFLOP
// (the lower triangle of A, A v, rP S and kT^T v: 4.2 MFLOP per tile over
// 2560 tiles), 160 us with FMA on the CUDA cores.
//
// Design. The first form (one CTA per (batch, head) walking its chunks)
// ran 4.4 ms; its four losses and what this form does about each:
//   1. parallelism: 160 CTAs, one resident per SM, in two waves. Now the
//      2560 tiles go to persistent CTAs, one per SM (512 threads, ~226 KB
//      of shared memory), in the order of an integer ticket, chunk major:
//      all (batch, head) pairs' chunk 0, then chunk 1, ... A tile waits
//      only on its predecessor chunk, whose ticket is smaller: that tile
//      is being computed, or done, whatever order the CTAs run in, so the
//      chain cannot deadlock; it started about a wave earlier, so it has
//      nearly always published. A CTA copies its next tile's w and k in
//      while it computes y.
//   2. the serial prefix: one thread per column walked 128 tokens. Now
//      512 / hd segments per column each sum their tokens, and a pass over
//      the segment sums in shared memory gives each segment its offset.
//   3. untiled products on the CUDA cores. Now all four run on the tensor
//      cores: m16n8k8 TF32 mma.sync, each product in three terms (a_lo b_hi
//      + a_hi b_lo + a_hi b_hi, about 21 bits; the split by integer
//      operations, as cvt.rna.tf32.f32 rounds but at their rate). A warp
//      owns 16 x 32 output tiles; A's upper triangle is skipped by whole
//      tiles, A v stops at each row block's diagonal, and y's row blocks
//      pair long and short ones per warp scheduler. Operand rows are
//      padded (8 floats for rows read along, 4 for rows read down) so the
//      fragments' loads hit distinct banks.
//   4. no FMA: the library keeps --fmad=false for the epoch kernels, whose
//      bits depend on it. K7 is held to a tolerance (1e-4), not to bits: its
//      products are the tensor cores' and its updates explicit __fmaf_rn,
//      as the plain version on the card (cuBLAS f32, TF32 off) fuses too.
// Per tile: the prefix of logw, diag, then rP, kD, kT in place; A (into
// shared memory) and kT^T v (into registers); S_c = exp(total) S_{c-1} +
// kT^T v written to the state buffer in L2 (the caller's final state at the
// last chunk), each warp's part released by an integer add to its (batch,
// head)'s count; then y. S_{c-1} is polled for before the products and,
// published (as it nearly always is), streams into shared memory under
// them. The wrapper's call resets the ticket and the counts (one memset)
// on the same stream before the kernel. Only integer atomics; every sum
// runs in a fixed order, so a call is deterministic. exp and log are expf
// and logf.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;  // rows of the intra-chunk products
constexpr int kMaxSmem = 232448;
constexpr int kTooLarge = -1;   // the chunk does not fit one CTA
constexpr int kBadHeadDim = -2;

__host__ __device__ constexpr int pad32(int c) { return (c + 31) & ~31; }

// Shared memory, in floats. Rows of C tokens (padded to Cp, a multiple of
// 32). A product's operand read along its rows (float2 loads) has rows 8
// floats longer than hd; one read down its columns, 4 floats longer: so
// either way the lanes of a warp hit distinct banks.
struct Layout {
  int l8, l4, lda, r, k, w, v, a, s, diag, etot, u, flag, floats;
  __host__ __device__ Layout(int Cp, int hd) {
    l8 = hd + 8;
    l4 = hd + 4;
    lda = Cp + 8;
    r = 0;                      // r, then rP (l8)
    k = r + Cp * l8;            // k, then kD (l8)
    w = k + Cp * l8;            // w, the local prefix, then kT (l4)
    v = w + Cp * l4;            // v (l4)
    a = v + Cp * l4;            // the segment sums, then A (Cp x lda)
    s = a + Cp * lda;           // S_{c-1} (hd x l4)
    diag = s + hd * l4;         // Cp
    etot = diag + Cp;           // exp(total), hd
    u = etot + hd;              // hd
    flag = u + hd;              // the ticket, and S_{c-1} ready early
    floats = flag + 4;
  }
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p),
               "r"(v)
               : "memory");
}

// C rows of one (batch, head) chunk into Cp padded rows of ``ld`` floats:
// cp.async for rows < C, ``pad`` in the rest. Each thread copies one
// 16-byte column of every (kThreads / (HD / 4))-th row.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, size_t st, int C,
                                          int Cp, float pad) {
  constexpr int Q = HD / 4, STEP = kThreads / Q;
  const int q = threadIdx.x % Q;
  int t = threadIdx.x / Q;
  dst += t * ld + 4 * q;
  src += t * st + 4 * q;
  for (; t < Cp; t += STEP, dst += STEP * ld, src += STEP * st) {
    if (t < C)
      cp16(dst, src);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(pad, pad, pad, pad);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = hi + lo, each a TF32 value: hi rounded to nearest (ties away), lo
// the exact rest cut to TF32. A product in three TF32 terms keeps about 21
// bits. Integer and float operations: cvt.rna.tf32.f32 does the same
// rounding at a fraction of their rate.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] += A (16 x K) B (K x 8 NT columns) on the tensor cores, each
// product as a_lo b_hi + a_hi b_lo + a_hi b_hi (the lo x lo term dropped).
// A_ROWS: A row-major at P (16 rows, k along a row), else P holds A^T (K
// rows of 16). B_ROWS: B^T row-major at Q (8 NT rows), else Q holds B (K
// rows of 8 NT). Only the first nt column tiles are computed. The m16n8k8
// fragments' k index t / t + 4 (t = lane % 4) reads k0 + 2t / k0 + 2t + 1
// of both operands: the same sum, and a float2 load along a row, or four
// rows 8 banks apart down a column.
template <int NT, bool A_ROWS, bool B_ROWS>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* P,
                                         int ldp, const float* Q, int ldq,
                                         int K, int nt = NT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    float a[4];
    if (A_ROWS) {
      const float2 x = ld2(P + g * ldp + k0 + t2),
                   z = ld2(P + (g + 8) * ldp + k0 + t2);
      a[0] = x.x, a[1] = z.x, a[2] = x.y, a[3] = z.y;
    } else {
      const float* p = P + (k0 + t2) * ldp + g;
      a[0] = p[0], a[1] = p[8], a[2] = p[ldp], a[3] = p[ldp + 8];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
      float b0, b1;
      if (B_ROWS) {
        const float2 x = ld2(Q + (8 * n + g) * ldq + k0 + t2);
        b0 = x.x, b1 = x.y;
      } else {
        const float* q = Q + (k0 + t2) * ldq + 8 * n + g;
        b0 = q[0], b1 = q[ldq];
      }
      uint32_t bh0, bl0, bh1, bl1;
      split(b0, bh0, bl0);
      split(b1, bh1, bl1);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// S_{c-1} (hd x hd, in L2) into shared memory, by cp.async
template <int HD>
__device__ __forceinline__ void copy_state(float* sS, const float* G) {
  constexpr int Q = HD / 4;
  for (int i = threadIdx.x; i < HD * Q; i += kThreads)
    cp16(sS + (i / Q) * (HD + 4) + 4 * (i % Q), G + 4 * i);
  cp_commit();
}

// A persistent CTA per SM walks tiles (batch, head, chunk) in the order of
// the tickets it takes. r, k, v, w, y (B,T,H,HD); u[b uB + h uH + d];
// state (B,H,HD,HD) is the carry and ends as the final state; work[0] the
// ticket, work[1 + b H + h] the number of S tiles of (b, h) published, NDS
// per chunk (both zero at the launch).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) rwkv_chunk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ state, int* __restrict__ work, int B, int T, int H,
    int C, int uB, int uH) {
  // warp tiles of 16 rows x 8 NT columns (kT^T v and y)
  constexpr int NT = HD / 8 < 4 ? HD / 8 : 4, WC = 8 * NT;
  constexpr int NS = kThreads / HD;  // prefix segments per column
  // kT^T v's warp tiles, and how many a warp holds at most
  constexpr int DSC = HD / WC, NDS = (HD / 16) * DSC;
  constexpr int MAXDS = (NDS + kWarps - 1) / kWarps;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int Cp = pad32(C);
  const Layout L(Cp, HD);
  float *sR = smem + L.r, *sK = smem + L.k, *sW = smem + L.w,
        *sV = smem + L.v, *sA = smem + L.a, *sS = smem + L.s,
        *sDiag = smem + L.diag, *sEtot = smem + L.etot, *sU = smem + L.u,
        *sSeg = smem + L.a;  // the segment sums, before A
  int* sFlag = reinterpret_cast<int*>(smem + L.flag);
  const int l8 = L.l8, l4 = L.l4, lda = L.lda;
  const int BH = B * H, tiles = BH * (T / C);
  const size_t st = (size_t)H * HD;
  // the (b, h, chunk) of a ticket: chunk major
  auto offset = [&](int tk) {
    const int c = tk / BH, b = tk % BH / H, h = tk % H;
    return ((size_t)b * T + (size_t)c * C) * st + (size_t)h * HD;
  };

  if (tid == 0) sFlag[0] = atomicAdd(work, 1);
  __syncthreads();
  int ticket = sFlag[0];
  // w and k of a tile are copied in while the tile before it computes y
  if (ticket < tiles) {
    load_rows<HD>(sW, l4, w + offset(ticket), st, C, Cp, 1.f);
    load_rows<HD>(sK, l8, k + offset(ticket), st, C, Cp, 0.f);
  }
  cp_commit();
  while (ticket < tiles) {
    const int c = ticket / BH, bh = ticket % BH, b = bh / H, h = bh % H;
    const size_t base = offset(ticket);
    const float ud = tid < HD ? u[(size_t)b * uB + (size_t)h * uH + tid] : 0.f;
    load_rows<HD>(sR, l8, r + base, st, C, Cp, 0.f);
    cp_commit();
    load_rows<HD>(sV, l4, v + base, st, C, Cp, 0.f);
    cp_commit();
    if (tid < HD) sU[tid] = ud;
    cp_wait<2>();
    __syncthreads();

    // the prefix of logw: each thread sums its segment of Cp / NS tokens of
    // one column (w becomes the local prefix)
    const int col = tid % HD, seg = tid / HD, SL = Cp / NS, t0 = seg * SL;
    float lw[16];
    {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < SL) {
          float* wp = sW + (t0 + i) * l4 + col;
          lw[i] = logf(fmaxf(*wp, 1e-38f));
          p = p + lw[i];
          *wp = p;
        }
      sSeg[seg * HD + col] = p;
    }
    cp_wait<1>();
    __syncthreads();
    // diag_t = sum_d r u k, four lanes per token
    {
      const int t = tid >> 2, part = tid & 3;
      float a = 0.f;
      if (t < Cp)
        for (int d = part; d < HD; d += 4)
          a = a + sR[t * l8 + d] * sU[d] * sK[t * l8 + d];
      a += __shfl_xor_sync(FULL_MASK, a, 1);
      a += __shfl_xor_sync(FULL_MASK, a, 2);
      if (part == 0 && t < Cp) sDiag[t] = a;
    }
    __syncthreads();
    // has the predecessor chunk published S_{c-1} already? Then it streams
    // in under the products (asked here, read after the next pass)
    float* G = state + (size_t)bh * HD * HD;
    int ready = 1;
    if (tid == 0 && c > 0) ready = load_acquire(work + 1 + bh) >= c * NDS;
    // each segment's offset and the column's total, in segment order; then
    // rP, kD and kT in place
    {
      float off = 0.f, tot = 0.f;
      for (int s2 = 0; s2 < NS; ++s2) {
        if (s2 == seg) off = tot;
        tot = tot + sSeg[s2 * HD + col];
      }
      if (seg == 0) sEtot[col] = expf(tot);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < SL) {
          const int o8 = (t0 + i) * l8 + col, o4 = (t0 + i) * l4 + col;
          const float cum = off + sW[o4], kk = sK[o8];
          sR[o8] = sR[o8] * expf(cum - lw[i]);
          sK[o8] = kk * expf(-cum);
          sW[o4] = kk * expf(tot - cum);
        }
    }
    if (tid == 0) sFlag[1] = ready;
    cp_wait<0>();
    __syncthreads();
    const bool early = sFlag[1] != 0;
    if (c > 0 && early) copy_state<HD>(sS, G);

    // A (the lower triangle, by 16 x 32 warp tiles) into shared memory and
    // the chunk's state increment kT^T v into registers. Jobs: the NDS
    // increment tiles first, then A's; warp w takes jobs w, w + 16, ...
    int next = 0;  // the next tile's ticket, asked now, read at the chain
    if (tid == 0) next = atomicAdd(work, 1);
    float ds[MAXDS][NT][4];
    {
#pragma unroll
      for (int m = 0; m < MAXDS; ++m) {
        zero(ds[m]);
        const int job = warp + m * kWarps;
        if (job < NDS)
          warp_mma<NT, false, false>(ds[m], sW + (job / DSC) * 16, l4,
                                     sV + (job % DSC) * WC, l4, Cp);
      }
      // A jobs: row block i (16 rows) needs column blocks j <= i / 2 (of
      // j = i / 2 at an even i, only the first 16 columns: y reads A up to
      // its row block's end)
      int ja = warp, i = 0, j = 0;
      while (ja < NDS) ja += kWarps;
      for (int n = ja - NDS; n > 0; --n)
        if (++j > i / 2) j = 0, ++i;
      while (i < Cp / 16) {
        float acc[4][4];
        zero(acc);
        warp_mma<4, true, true>(acc, sR + i * 16 * l8, l8, sK + j * 32 * l8,
                                l8, HD, i % 2 || j < i / 2 ? 4 : 2);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = i * 16 + g + 8 * hf, s = j * 32 + 8 * n + t2;
            *reinterpret_cast<float2*>(sA + t * lda + s) =
                make_float2(s < t ? acc[n][2 * hf] : 0.f,
                            s + 1 < t ? acc[n][2 * hf + 1] : 0.f);
          }
        for (int n = 0; n < kWarps; ++n)
          if (++j > i / 2) j = 0, ++i;
      }
    }
    if (tid == 0) sFlag[0] = next;
    cp_wait<0>();
    __syncthreads();

    // the chain: S_c = exp(total) S_{c-1} + kT^T v, published for chunk
    // c + 1
    if (c > 0 && !early) {
      if (tid == 0)
        while (load_acquire(work + 1 + bh) < c * NDS) __nanosleep(64);
      __syncthreads();
      copy_state<HD>(sS, G);
      cp_wait<0>();
      __syncthreads();
    }
    // each warp publishes its own tiles of S_c: its lanes' stores, a warp
    // barrier, one release-add to the (b, h) count; chunk c + 1 reads S_c
    // when the count reaches (c + 1) NDS
#pragma unroll
    for (int m = 0; m < MAXDS; ++m) {
      const int job = warp + m * kWarps;
      if (job >= NDS) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d = (job / DSC) * 16 + g + 8 * hf,
                    e = (job % DSC) * WC + 8 * n + t2;
          const float2 sp =
              c > 0 ? ld2(sS + d * l4 + e) : make_float2(0.f, 0.f);
          const float et = sEtot[d];
          __stcg(reinterpret_cast<float2*>(G + d * HD + e),
                 make_float2(__fmaf_rn(et, sp.x, ds[m][n][2 * hf]),
                             __fmaf_rn(et, sp.y, ds[m][n][2 * hf + 1])));
        }
      __syncwarp();
      if (lane == 0) add_release(work + 1 + bh, 1);
    }
    next = sFlag[0];
    if (next < tiles) {  // sW and sK are free: A and kT^T v are done
      load_rows<HD>(sW, l4, w + offset(next), st, C, Cp, 1.f);
      load_rows<HD>(sK, l8, k + offset(next), st, C, Cp, 0.f);
    }
    cp_commit();

    // y = A v + diag v + rP S_{c-1}: 16 x WC warp tiles; row block i's
    // A v stops at its diagonal. Warp scheduler (warp % 4) q takes the
    // row blocks i with min(i, RB - 1 - i) % 4 == q, its four warps in
    // turn.
    {
      const int RB = Cp / 16;
      const int q = warp & 3, slot = warp >> 2;
      int n = 0;
      for (int i = 0; i < RB; ++i) {
        if ((i < RB - 1 - i ? i : RB - 1 - i) % 4 != q) continue;
        for (int jb = 0; jb < DSC; ++jb, ++n) {
          if (n % 4 != slot) continue;
          const int r0 = i * 16, e0 = jb * WC;
          float acc[NT][4];
          zero(acc);
          warp_mma<NT, true, false>(acc, sA + r0 * lda, lda, sV + e0, l4,
                                    r0 + 16);
          if (c > 0)
            warp_mma<NT, true, false>(acc, sR + r0 * l8, l8, sS + e0, l4,
                                      HD);
#pragma unroll
          for (int nn = 0; nn < NT; ++nn)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int t = r0 + g + 8 * hf, e = e0 + 8 * nn + t2;
              const float dg = sDiag[t];
              const float2 vv = ld2(sV + t * l4 + e);
              if (t < C)
                *reinterpret_cast<float2*>(y + base + t * st + e) =
                    make_float2(__fmaf_rn(dg, vv.x, acc[nn][2 * hf]),
                                __fmaf_rn(dg, vv.y, acc[nn][2 * hf + 1]));
            }
        }
      }
    }
    ticket = next;
    __syncthreads();
  }
  cp_wait<0>();
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* state, int* work, int B, int T,
           int H, int C, int uB, int uH, cudaStream_t stream) {
  const int Cp = pad32(C);
  const size_t bytes = sizeof(float) * (size_t)Layout(Cp, HD).floats;
  if (C > kMaxChunk || bytes > (size_t)kMaxSmem) return kTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (!sms) return (int)cudaErrorInvalidDevice;
  err = cudaMemsetAsync(work, 0, sizeof(int) * (1 + (size_t)B * H), stream);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * H * (T / C);
  rwkv_chunk_kernel<HD><<<tiles < sms ? tiles : sms, kThreads, bytes,
                          stream>>>(
      r, k, v, w, u, y, state, work, B, T, H, C, uB, uH);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y (B,T,H,hd) f32 contiguous; u[b * uB + h * uH + d] f32;
// chunks of C tokens (T % C == 0); state (B,H,hd,hd) f32, written with the
// final state; work 1 + B H ints of scratch (reset here, on the stream).
// Returns -1 for a chunk one CTA cannot hold, -2 for a head dim other than
// 16, 32, 64 or 128 (nothing launched), else a CUDA error code.
extern "C" int rwkv_chunk_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 void* state, void* work, int B, int T, int H,
                                 int hd, int C, int uB, int uH,
                                 void* stream) {
  if (B < 1 || H < 1 || C < 1 || T % C != 0)
    return (int)cudaErrorInvalidValue;
  const auto* fr = (const float*)r;
  const auto* fk = (const float*)k;
  const auto* fv = (const float*)v;
  const auto* fw = (const float*)w;
  const auto* fu = (const float*)u;
  auto* fy = (float*)y;
  auto* fs = (float*)state;
  auto* iw = (int*)work;
  auto* s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(fr, fk, fv, fw, fu, fy, fs, iw, B, T, H, C, uB, uH, s);
    case 32:
      return launch<32>(fr, fk, fv, fw, fu, fy, fs, iw, B, T, H, C, uB, uH, s);
    case 64:
      return launch<64>(fr, fk, fv, fw, fu, fy, fs, iw, B, T, H, C, uB, uH, s);
    case 128:
      return launch<128>(fr, fk, fv, fw, fu, fy, fs, iw, B, T, H, C, uB, uH,
                         s);
    default:
      return kBadHeadDim;
  }
}
