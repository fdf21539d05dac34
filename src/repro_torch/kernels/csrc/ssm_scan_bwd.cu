// K8's backward for Hopper (sm_90a): the gradient of the selective scan
// (csrc/ssm_scan.cu), f32 in and out.
//
// Replaces no TPU kernel: the reference differentiates its lax.scan
// (src/repro/models/ssm.py:16 ssm_scan) with XLA, and eager PyTorch would
// run a reverse scan as ~10 small launches per token. It computes what the
// plain version, ssm_scan.py:ssm_scan_bwd_ref, computes. With
// h_t = a_t h_{t-1} + dt_t x_t B_t, a_t = exp(dt_t A) and
// y_t = sum_n h_t C_t, walking the tokens in reverse with the carried
// gradient g (g_hout before the last token):
//
//   gh_t   = g + C_t gy_t                       (per channel and state)
//   dx_t   = dt_t sum_n gh_t B_t
//   dC_t   = sum_{h,d} h_t gy_t,  dB_t = sum_{h,d} gh_t dt_t x_t
//   ddt_t  = sum_{d,n} gh_t (x_t B_t + A a_t h_{t-1})
//   dA     = sum_{b,t,d,n} gh_t a_t dt_t h_{t-1},  g <- a_t gh_t
//
// and dh0 is the last g. Bound on an H100: bytes (x, gy and dx at the
// hymba training layout, 105 MB each; 323 MB in all, ~97 us at 3.35
// TB/s); roofline/work.py:scan_bwd_flops counts the token recurrence's
// operations, not the extra walks below.
//
// The decay a_t is one scalar per (batch, token, head), so a chunk of
// kChunk tokens folds into a closed form: the state leaving it is
// D_c h_start + Delta_c, and the gradient carried out of its first token
// is D_c g_end + Gamma_c, where D_c is the product of the chunk's decays
// (in token order), Delta_c the state walked from zero through the chunk
// and Gamma_c the carried gradient walked in reverse from zero. Three
// launches on the stream, parallel over (batch, head, chunk):
//   1. ssm_scan_bwd_increments, one CTA per (batch, head, chunk): D_c,
//      Delta_c and Gamma_c into scratch arrays (B*H, nc, hd, N).
//   2. ssm_scan_bwd_chains, one thread per (batch, head, channel, state):
//      h_start[c] in chunk order from h0, written over Delta_c, and
//      g_end[c] in reverse from g_hout, written over Gamma_c; dh0 is
//      D_0 g_end[0] + Gamma_0. The loads run 16 chunks ahead of the
//      chain.
//   3. ssm_scan_bwd_grads, one CTA per (batch, head, chunk): the chunk's
//      states from h_start[c] (the state entering each tile of kTile
//      tokens kept in shared memory), then the tiles in reverse: each
//      tile's states recomputed into registers, its tokens walked
//      backwards from g_end[c] as the formulas above. dx and ddt per
//      token, dB_ and dC_ per (batch, token, head), dA per (batch, head,
//      chunk); the wrapper sums dB_ and dC_ over the heads and dA over the
//      batch and the chunks (torch's fixed-order reductions).
// Nothing divides by a decay: h_{t-1} is recomputed, never rebuilt as
// (h_t - dBx_t) / a_t, and D_c is a product, never a ratio of
// exponentials. A D_c that underflows to 0 is the right value and flows
// through the chains as 0.
//
// Each CTA has two threads per channel, each holding N / 2 of its states
// (so that a CTA fills a warp at head dim 16). A CTA stages its chunk's
// x, gy, B and C in shared memory by cp.async (x and B first, so that the
// walk over the chunk's states overlaps the arrival of gy and C), and its
// dt by plain loads. The sums over channels are fixed-order trees: per
// token, each thread's 2 (N / 2) terms of dC_ and dB_ are folded over the
// warp's 16 channels by xor shuffles (each step halves the terms a lane
// holds; a lane ends with one sum), the warps' sums are combined in warp
// order after each tile; ddt's terms per tile and dA's per chunk
// likewise. No atomics: two calls are bit for bit equal.
//
// Built with --fmad=false and IEEE division, as the forward; the states
// are recomputed in the forward's operation order.
#include "tf32_mma.cuh"  // common.cuh and the cp.async helpers

namespace {

constexpr int kChunk = 32;   // tokens per chunk
constexpr int kTile = 8;     // tokens per tile of the gradients' walk
constexpr int kTiles = kChunk / kTile;
constexpr int kChainThreads = 128;
constexpr int kAhead = 16;   // chunks a chain thread loads ahead
constexpr int kBadShape = -2;

// NP consecutive floats (16-byte aligned, NP % 4 == 0)
template <int NP>
__device__ __forceinline__ void ld4(const float* p, float (&out)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    out[j] = v.x; out[j + 1] = v.y; out[j + 2] = v.z; out[j + 3] = v.w;
  }
}

template <int NP>
__device__ __forceinline__ void st4(float* p, const float (&in)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; j += 4)
    *reinterpret_cast<float4*>(p + j) =
        make_float4(in[j], in[j + 1], in[j + 2], in[j + 3]);
}

// A fixed-order tree over the lanes that differ in the bits M, M/2, ...,
// MLO of the lane index: while a lane holds n > 1 terms, each step keeps
// half of them (the upper half where the lane's bit is set) and adds the
// partner's copy of that half; once it holds one, the steps left add the
// partner's sum. v[0] ends as the sum, over those lanes, of term
//   idx = sum over the halving steps of (lane & m ? n / 2 : 0).
template <int n, int M, int MLO, int V>
__device__ __forceinline__ void fold(float (&v)[V], int lane) {
  if constexpr (M >= MLO) {
    if constexpr (n > 1) {
      constexpr int half = n / 2;
      const bool up = lane & M;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL_MASK, send, M);
      }
      fold<half, M / 2, MLO>(v, lane);
    } else {
      v[0] = v[0] + __shfl_xor_sync(FULL_MASK, v[0], M);
      fold<1, M / 2, MLO>(v, lane);
    }
  }
}

// log2 of a power of two
__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// A chunk's operands in shared memory (floats, each part 16-byte
// aligned): x and gy [t][d], B and C [t][n], dt and the decay [t]; rows
// past the sequence's end are left unwritten and never read.
template <int HD, int N>
struct Chunk {
  static constexpr int kX = 0;
  static constexpr int kGy = kX + kChunk * HD;
  static constexpr int kB = kGy + kChunk * HD;
  static constexpr int kC = kB + kChunk * N;
  static constexpr int kDt = kC + kChunk * N;
  static constexpr int kDec = kDt + kChunk;
  static constexpr int kEnd = kDec + kChunk;
};

// Issues the chunk's copies in two groups, x and B (what the walk over
// the states reads), then gy and C, and stores its dt.
template <int HD, int N>
__device__ __forceinline__ void stage(float* sm, const float* x,
                                      const float* gy, const float* dt,
                                      const float* Bm, const float* Cm,
                                      size_t row, int h, int H, int nt) {
  using L = Chunk<HD, N>;
  constexpr int kT = 2 * HD;
  constexpr int kPx = HD / 4, kPb = N / 4;   // 16-byte pieces per row
  const int tid = threadIdx.x;
  for (int i = tid; i < nt * kPx; i += kT) {
    const int t = i / kPx, p = i % kPx;
    cp16(sm + L::kX + t * HD + 4 * p, x + ((row + t) * H + h) * HD + 4 * p);
  }
  for (int i = tid; i < nt * kPb; i += kT) {
    const int t = i / kPb, p = i % kPb;
    cp16(sm + L::kB + t * N + 4 * p, Bm + (row + t) * N + 4 * p);
  }
  cp_commit();
  for (int i = tid; i < nt * kPx; i += kT) {
    const int t = i / kPx, p = i % kPx;
    cp16(sm + L::kGy + t * HD + 4 * p, gy + ((row + t) * H + h) * HD + 4 * p);
  }
  for (int i = tid; i < nt * kPb; i += kT) {
    const int t = i / kPb, p = i % kPb;
    cp16(sm + L::kC + t * N + 4 * p, Cm + (row + t) * N + 4 * p);
  }
  cp_commit();
  for (int t = tid; t < nt; t += kT)
    sm[L::kDt + t] = __ldg(dt + (row + t) * H + h);
}

// the decays of the staged tokens, as the forward computes them
template <int HD, int N>
__device__ __forceinline__ void decays(float* sm, float a, int nt) {
  using L = Chunk<HD, N>;
  for (int t = threadIdx.x; t < nt; t += 2 * HD)
    sm[L::kDec + t] = expf(sm[L::kDt + t] * a);
}

// one forward step of a thread's NQ states at staged token t
template <int HD, int N, int NQ>
__device__ __forceinline__ void step(const float* sm, int t, int d, int q,
                                     float (&st)[NQ]) {
  using L = Chunk<HD, N>;
  const float decay = sm[L::kDec + t];
  const float dtx = sm[L::kDt + t] * sm[L::kX + t * HD + d];
  float bv[NQ];
  ld4<NQ>(sm + L::kB + t * N + q * NQ, bv);
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float dbx = dtx * bv[j];
    st[j] = st[j] * decay + dbx;
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(2 * HD)
ssm_scan_bwd_increments(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ A,
                        const float* __restrict__ gy,
                        float* __restrict__ hs, float* __restrict__ gs,
                        float* __restrict__ dprod, int S, int H, int nc) {
  using L = Chunk<HD, N>;
  constexpr int NQ = N / 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, d = tid >> 1, q = tid & 1;
  const int blk = blockIdx.x;                 // (b * H + h) * nc + c
  const int c = blk % nc, bh = blk / nc, b = bh / H, h = bh % H;
  const int t0 = c * kChunk, nt = min(kChunk, S - t0);
  stage<HD, N>(sm, x, gy, dt, Bm, Cm, (size_t)b * S + t0, h, H, nt);
  cp_wait<0>();
  __syncthreads();
  decays<HD, N>(sm, __ldg(A + h), nt);
  __syncthreads();

  // Delta_c: the state walked from zero through the chunk
  float st[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) st[j] = 0.f;
#pragma unroll 4
  for (int t = 0; t < nt; ++t) step<HD, N, NQ>(sm, t, d, q, st);
  const size_t off = ((size_t)blk * HD + d) * N + q * NQ;
  st4<NQ>(hs + off, st);
  if (tid == 0) {
    float p = 1.f;
    for (int t = 0; t < nt; ++t) p = p * sm[L::kDec + t];
    dprod[blk] = p;
  }

  // Gamma_c: the carried gradient walked in reverse from zero
  float g[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) g[j] = 0.f;
#pragma unroll 4
  for (int t = nt - 1; t >= 0; --t) {
    const float decay = sm[L::kDec + t], gyd = sm[L::kGy + t * HD + d];
    float cv[NQ];
    ld4<NQ>(sm + L::kC + t * N + q * NQ, cv);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      g[j] = g[j] + cv[j] * gyd;
      g[j] = decay * g[j];
    }
  }
  st4<NQ>(gs + off, g);
}

// One element's chain over the chunks, in chunk order (from the last
// where reverse): at chunk c, v[c] <- carry and carry <- D_c carry + v[c];
// returns the last carry. The loads of the next kAhead chunks are issued
// before the current ones' stores and updates, so that they are in flight
// while the chain walks.
__device__ __forceinline__ float chain(float* v, const float* dp, size_t E,
                                       int nc, float carry, bool reverse) {
  float inc[kAhead], dc[kAhead], ninc[kAhead], ndc[kAhead];
  auto at = [&](int k) { return reverse ? nc - 1 - k : k; };
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (k < nc) {
      inc[k] = v[at(k) * E];
      dc[k] = __ldg(dp + at(k));
    }
  for (int k0 = 0; k0 < nc; k0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (k0 + kAhead + k < nc) {
        ninc[k] = v[at(k0 + kAhead + k) * E];
        ndc[k] = __ldg(dp + at(k0 + kAhead + k));
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (k0 + k < nc) {
        v[at(k0 + k) * E] = carry;
        carry = dc[k] * carry + inc[k];
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      inc[k] = ninc[k];
      dc[k] = ndc[k];
    }
  }
  return carry;
}

// hs, gs (BH, nc, E) with E = hd * N: Delta_c and Gamma_c in, h_start[c]
// and g_end[c] out; dprod (BH, nc); h0, ghout, dh0 (BH, E)
__global__ void __launch_bounds__(kChainThreads)
ssm_scan_bwd_chains(const float* __restrict__ h0,
                    const float* __restrict__ ghout,
                    const float* __restrict__ dprod, float* __restrict__ hs,
                    float* __restrict__ gs, float* __restrict__ dh0, int BH,
                    int E, int nc) {
  const size_t i = (size_t)blockIdx.x * kChainThreads + threadIdx.x;
  if (i >= (size_t)BH * E) return;
  const size_t bh = i / E, e = i % E;
  const float* dp = dprod + bh * nc;
  chain(hs + bh * nc * E + e, dp, E, nc, h0[i], false);
  dh0[i] = chain(gs + bh * nc * E + e, dp, E, nc, ghout[i], true);
}

// floats of the gradients kernel's shared memory: the chunk's operands,
// the state entering each tile [tile][j][thread], the warps' sums of the
// dC_/dB_ terms [parity][warp][token][lane] and of the ddt terms
// [parity][warp][token], dA's [warp]
template <int HD, int N>
struct Grads {
  static constexpr int kT = 2 * HD, kW = kT / 32;
  static constexpr int kCk = Chunk<HD, N>::kEnd;
  static constexpr int kPart = kCk + kTiles * (N / 2) * kT;
  static constexpr int kRpart = kPart + 2 * kW * kTile * 32;
  static constexpr int kDa = kRpart + 2 * kW * kTile;
  static constexpr int kEnd = kDa + kW;
};

template <int HD, int N>
__global__ void __launch_bounds__(2 * HD)
ssm_scan_bwd_grads(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ gy,
                   const float* __restrict__ hs, const float* __restrict__ gs,
                   float* __restrict__ dx, float* __restrict__ ddt,
                   float* __restrict__ dBp, float* __restrict__ dCp,
                   float* __restrict__ dAp, int S, int H, int nc) {
  using L = Chunk<HD, N>;
  using G = Grads<HD, N>;
  constexpr int NQ = N / 2, V = 2 * NQ, kT = G::kT, kW = G::kW;
  // the lane that ends with term idx of half q: the channel bits of the
  // lane (1..4) fold V terms to one in log2(V) steps from bit 4 down
  constexpr int kShift = 5 - ilog2(V);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ck = sm + G::kCk;
  const int tid = threadIdx.x, d = tid >> 1, q = tid & 1;
  const int lane = tid & 31, w = tid >> 5;
  const int blk = blockIdx.x;                 // (b * H + h) * nc + c
  const int c = blk % nc, bh = blk / nc, b = bh / H, h = bh % H;
  const int t0 = c * kChunk, nt = min(kChunk, S - t0);
  const size_t row = (size_t)b * S + t0;
  const float a = __ldg(A + h);
  const size_t off = ((size_t)blk * HD + d) * N + q * NQ;
  stage<HD, N>(sm, x, gy, dt, Bm, Cm, row, h, H, nt);
  float st[NQ];
  ld4<NQ>(hs + off, st);
  cp_wait<1>();
  __syncthreads();
  decays<HD, N>(sm, a, nt);
  __syncthreads();

  // the state entering each tile, from h_start[c]
  for (int k = 0; k < kTiles; ++k) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) ck[(k * NQ + j) * kT + tid] = st[j];
    if (k + 1 == kTiles || (k + 1) * kTile >= nt) break;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int t = k * kTile + i;
      if (t < nt) step<HD, N, NQ>(sm, t, d, q, st);
    }
  }
  float g[NQ];
  ld4<NQ>(gs + off, g);
  cp_wait<0>();
  __syncthreads();

  float dA_acc = 0.f;
  for (int k = (nt - 1) / kTile; k >= 0; --k) {
    const int tb = k * kTile, par = k & 1;
    // the tile's states h_t, recomputed from the state entering it
    float hsr[kTile][NQ], hin[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) st[j] = hin[j] = ck[(k * NQ + j) * kT + tid];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (tb + i < nt) step<HD, N, NQ>(sm, tb + i, d, q, st);
#pragma unroll
      for (int j = 0; j < NQ; ++j) hsr[i][j] = st[j];
    }
    // the tile's tokens backwards
    float r[kTile];
#pragma unroll
    for (int i = kTile - 1; i >= 0; --i) {
      r[i] = 0.f;
      const int t = tb + i;
      if (t < nt) {
        const float decay = sm[L::kDec + t], dtt = sm[L::kDt + t];
        const float xd = sm[L::kX + t * HD + d];
        const float gyd = sm[L::kGy + t * HD + d];
        float bv[NQ], cv[NQ], v[V];
        ld4<NQ>(sm + L::kB + t * N + q * NQ, bv);
        ld4<NQ>(sm + L::kC + t * N + q * NQ, cv);
        float sB = 0.f, sH = 0.f;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          g[j] = g[j] + cv[j] * gyd;             // gh_t
          const float hp = i > 0 ? hsr[i - 1][j] : hin[j];
          sB = sB + g[j] * bv[j];
          sH = sH + g[j] * hp;
          v[j] = hsr[i][j] * gyd;                // dC's term
          v[NQ + j] = g[j] * xd;                 // dB's term
          g[j] = decay * g[j];
        }
        const float sBd = sB + __shfl_xor_sync(FULL_MASK, sB, 1);
        if (q == 0) dx[((row + t) * H + h) * HD + d] = dtt * sBd;
        r[i] = xd * sB + (a * decay) * sH;
        dA_acc = dA_acc + (decay * dtt) * sH;
        // the terms over the warp's 16 channels (lane bits 4..1)
        fold<V, 16, 2>(v, lane);
        sm[G::kPart + ((par * kW + w) * kTile + i) * 32 + lane] = v[0];
      }
    }
    // ddt's terms over the warp: lane l ends with token (l >> 2) & 7
    fold<kTile, 16, 1>(r, lane);
    if ((lane & 3) == 0)
      sm[G::kRpart + (par * kW + w) * kTile + (lane >> 2)] = r[0];
    __syncthreads();
    // the warps' sums in warp order: dC_ and dB_ per (token, state), ddt
    // per token
    for (int o = tid; o < kTile * (2 * N + 1); o += kT) {
      const int i = o / (2 * N + 1), m = o % (2 * N + 1);
      if (tb + i >= nt) continue;
      const size_t tok = (row + tb + i) * H + h;
      if (m < 2 * N) {
        const int which = m / N, n = m % N;
        const int src = (n / NQ) | ((which * NQ + n % NQ) << kShift);
        const float* p = sm + G::kPart + (par * kW * kTile + i) * 32 + src;
        float s = p[0];
#pragma unroll
        for (int ww = 1; ww < kW; ++ww) s = s + p[ww * kTile * 32];
        if (which == 0)
          dCp[tok * N + n] = s;
        else
          dBp[tok * N + n] = sm[L::kDt + tb + i] * s;
      } else {
        const float* p = sm + G::kRpart + par * kW * kTile + i;
        float s = p[0];
#pragma unroll
        for (int ww = 1; ww < kW; ++ww) s = s + p[ww * kTile];
        ddt[tok] = s;
      }
    }
  }
  // dA's (batch, head, chunk) partial: over the warp, then the warps in
  // order
  dA_acc = warp_sum(dA_acc);
  if (lane == 0) sm[G::kDa + w] = dA_acc;
  __syncthreads();
  if (tid == 0) {
    float s = sm[G::kDa];
    for (int ww = 1; ww < kW; ++ww) s = s + sm[G::kDa + ww];
    dAp[blk] = s;
  }
}

struct BwdArgs {
  const float *x, *dt, *Bm, *Cm, *A, *h0, *gy, *ghout;
  float *hs, *gs, *dprod, *dx, *ddt, *dBp, *dCp, *dAp, *dh0;
};

template <int HD, int N>
int launch(const BwdArgs& p, int B, int S, int H, cudaStream_t stream) {
  const int nc = (S + kChunk - 1) / kChunk;
  const unsigned blocks = (unsigned)(B * H * nc);
  const size_t ibytes = sizeof(float) * Chunk<HD, N>::kEnd;
  const size_t gbytes = sizeof(float) * Grads<HD, N>::kEnd;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_increments<HD, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ibytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_scan_bwd_grads<HD, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gbytes);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_bwd_increments<HD, N><<<blocks, 2 * HD, ibytes, stream>>>(
      p.x, p.dt, p.Bm, p.Cm, p.A, p.gy, p.hs, p.gs, p.dprod, S, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t elems = (size_t)B * H * HD * N;
  ssm_scan_bwd_chains<<<(unsigned)((elems + kChainThreads - 1) /
                                   kChainThreads),
                        kChainThreads, 0, stream>>>(
      p.h0, p.ghout, p.dprod, p.hs, p.gs, p.dh0, B * H, HD * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssm_scan_bwd_grads<HD, N><<<blocks, 2 * HD, gbytes, stream>>>(
      p.x, p.dt, p.Bm, p.Cm, p.A, p.gy, p.hs, p.gs, p.dx, p.ddt, p.dBp,
      p.dCp, p.dAp, S, H, nc);
  return (int)cudaGetLastError();
}

template <int N>
int launch_hd(const BwdArgs& p, int B, int S, int H, int hd,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, N>(p, B, S, H, stream);
    case 32: return launch<32, N>(p, B, S, H, stream);
    case 64: return launch<64, N>(p, B, S, H, stream);
    case 128: return launch<128, N>(p, B, S, H, stream);
    default: return kBadShape;
  }
}

}  // namespace

// Operands as ssm_scan_launch's (xh, gy, dx (B,S,H,hd); dt, ddt (B,S,H);
// B_, C_ (B,S,N); A (H,); h0, g_hout, dh0 (B,H,hd,N)), f32 and contiguous,
// xh/gy/B_/C_ 16-byte aligned; hs, gs the chain arrays (B*H, nc, hd, N)
// and dprod (B*H, nc), nc = ceil(S / 32); dB_part, dC_part (B,S,H,N) and
// dA_part (B,H,nc): the per-head and per-chunk partials. Returns -2 for a
// head dim other than 16, 32, 64 or 128 or a state size other than 8 or 16
// (nothing launched), else a CUDA error code.
extern "C" int ssm_scan_bwd_launch(const void* xh, const void* dt,
                                   const void* Bm, const void* Cm,
                                   const void* A, const void* h0,
                                   const void* gy, const void* g_hout,
                                   void* hs, void* gs, void* dprod, void* dx,
                                   void* ddt, void* dB_part, void* dC_part,
                                   void* dA_part, void* dh0, int B, int S,
                                   int H, int hd, int N, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs p{(const float*)xh, (const float*)dt, (const float*)Bm,
                  (const float*)Cm, (const float*)A, (const float*)h0,
                  (const float*)gy, (const float*)g_hout, (float*)hs,
                  (float*)gs, (float*)dprod, (float*)dx, (float*)ddt,
                  (float*)dB_part, (float*)dC_part, (float*)dA_part,
                  (float*)dh0};
  auto* s = (cudaStream_t)stream;
  switch (N) {
    case 8: return launch_hd<8>(p, B, S, H, hd, s);
    case 16: return launch_hd<16>(p, B, S, H, hd, s);
    default: return kBadShape;
  }
}
