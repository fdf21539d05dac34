// K8: the selective scan of the hybrid family's mamba heads, for Hopper
// (sm_90a), f32 in and out.
//
// Replaces no TPU kernel: the reference computes it as a sequential
// lax.scan over the tokens (src/repro/models/ssm.py:16 ssm_scan), which
// XLA fuses; in eager PyTorch that scan would be ~6 small launches per
// token and layer. Per channel (batch b, head h, head-dim index d) it
// walks the tokens in order with the state h[n], n < N:
//
//   decay = expf(dt[t] A[h]),  dBx = (dt[t] x[t, d]) B[t, n]
//   h[n]  = h[n] decay + dBx,  y[t, d] = sum_n h[n] C[t, n]
//
// Bound on an H100: bytes (x in and y out dominate: 107.5 MB at the hymba
// prefill, ~32 us at 3.35 TB/s; 214.3 MB at its training layout); the
// operations (5 N per channel and token) take half that at the f32 rate.
//
// The scan is sequential in t, but the decay is one scalar per (batch,
// token, head), so a chunk of kChunk tokens folds into a closed form: the
// state leaving chunk c is D_c h_start[c] + Delta_c, where D_c is the
// product of the chunk's decays (in token order) and Delta_c the state
// walked from zero through the chunk. Three launches on the stream,
// parallel over (batch, head, chunk), so that enough warps are resident
// on every SM to hide each token's step:
//   1. ssm_scan_fwd_increments, one CTA per (batch, head, chunk) but the
//      last (whose increments no chunk reads): D_c and Delta_c into the
//      scratch arrays dprod (B*H, nc - 1) and hs (B*H, nc - 1, hd, N).
//      It stages the chunk's x and B by cp.async, and its dt; not C.
//   2. ssm_scan_fwd_chains, one thread per (batch, head, channel, state):
//      h_start[c + 1] = D_c h_start[c] + Delta_c in chunk order from h0,
//      written over Delta_c. The loads run kAhead chunks ahead of the
//      chain.
//   3. ssm_scan_fwd_outputs, one CTA per (batch, head, chunk): stages the
//      chunk's x, B and C by cp.async and its dt and decays, walks its
//      tokens from h_start[c] (h0 for the first chunk), each step rounded
//      as the plain version's, and writes y; the last chunk writes h_out.
// At S <= kChunk only launch 3 runs, from h0, with no scratch (a decode
// step is one launch). Only the state entering each chunk past the first
// rounds otherwise than the plain version's walk. Nothing divides by a
// decay; a D_c that underflows to 0 is the right value and flows through
// the chain as 0. No atomics: two calls are bit for bit equal.
//
// A CTA has one thread per channel holding its N states in registers (two
// threads of N / 2 at head dim 16, so that a CTA fills a warp, their y
// halves joined by an xor shuffle). y's terms are fused into its sum
// (__fmaf_rn), in state order; the state's own step is never fused. The
// one-CTA-per-(batch, head) form before it walked all S tokens with 2
// warps a CTA on 100 of the 132 SMs, ~200 SM cycles a token.
//
// What bounds it (scripts/k8_probe.py on an H100 at hymba's training
// layout, B 4, S 4096, 25 heads of 64, N 16): the increments, chains and
// outputs launches take ~70, ~18 and ~125 us. The outputs launch's copies
// and stores alone take ~82 us (the card's practical rate), its walk and
// stores alone ~98 us: the walking launches are bound by instruction
// issue (~78 and ~56 warp instructions a token, 65 and 49 of them f32)
// more than by their bytes, and the two overlap only in part. Slower in
// the same probe: 32- or 128-token chunks, two threads a channel, y summed
// unfused or as a tree, and (forms since replaced) two channels a thread,
// the chunk staged in 2 or 4 cp.async groups, a persistent grid
// double-buffering its chunks.
//
// Built with --fmad=false and IEEE division: each step rounds as the
// plain version's (kernels/ssm_scan.py::ssm_scan_ref).
#include "tf32_mma.cuh"  // common.cuh and the cp.async helpers

namespace {

constexpr int kChunk = 64;   // tokens per chunk
constexpr int kChainThreads = 128;
constexpr int kAhead = 16;   // chunks a chain thread loads ahead
constexpr int kBadShape = -2;

// threads per channel at head dim HD, each holding N / groups states
template <int HD>
__host__ __device__ constexpr int groups() { return HD >= 32 ? 1 : 2; }
// the threads of a CTA
template <int HD>
__host__ __device__ constexpr int threads() { return HD * groups<HD>(); }

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

// A chunk's operands in shared memory (floats, each part 16-byte
// aligned): x [t][d], B [t][n], dt and the decay [t], then C [t][n],
// which only the outputs launch stages; rows past the sequence's end are
// left unwritten and never read.
template <int HD, int N>
struct Chunk {
  static constexpr int kX = 0;
  static constexpr int kB = kX + kChunk * HD;
  static constexpr int kDt = kB + kChunk * N;
  static constexpr int kDec = kDt + kChunk;
  static constexpr int kC = kDec + kChunk;   // the increments' end
  static constexpr int kEnd = kC + kChunk * N;
};

// Issues the copies of the chunk's nt tokens (x, B and, WITH_C, C; one
// group) and stores their dt and decays.
template <int HD, int N, bool WITH_C>
__device__ __forceinline__ void stage(float* sm, const float* x,
                                      const float* dt, const float* Bm,
                                      const float* Cm, float a, size_t row,
                                      int h, int H, int nt) {
  using L = Chunk<HD, N>;
  constexpr int kT = threads<HD>();
  constexpr int kPx = HD / 4, kPb = N / 4;   // 16-byte pieces per row
  const int tid = threadIdx.x;
  for (int i = tid; i < nt * kPx; i += kT) {
    const int t = i / kPx, p = i % kPx;
    cp16(sm + L::kX + t * HD + 4 * p, x + ((row + t) * H + h) * HD + 4 * p);
  }
  for (int i = tid; i < nt * kPb; i += kT) {
    const int t = i / kPb, p = i % kPb;
    cp16(sm + L::kB + t * N + 4 * p, Bm + (row + t) * N + 4 * p);
    if constexpr (WITH_C)
      cp16(sm + L::kC + t * N + 4 * p, Cm + (row + t) * N + 4 * p);
  }
  cp_commit();
  for (int t = tid; t < nt; t += kT) {
    const float v = __ldg(dt + (row + t) * H + h);
    sm[L::kDt + t] = v;
    sm[L::kDec + t] = expf(v * a);
  }
}

// one step of a thread's NP states at staged token t
template <int HD, int N, int NP>
__device__ __forceinline__ void step(const float* sm, int t, int d, int g,
                                     float (&st)[NP]) {
  using L = Chunk<HD, N>;
  const float dtx = sm[L::kDt + t] * sm[L::kX + t * HD + d];
  const float decay = sm[L::kDec + t];
  float bv[NP];
  ld4<NP>(sm + L::kB + t * N + g * NP, bv);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float dbx = dtx * bv[j];
    st[j] = st[j] * decay + dbx;
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(threads<HD>())
ssm_scan_fwd_increments(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bm,
                        const float* __restrict__ A,
                        float* __restrict__ hs, float* __restrict__ dprod,
                        int S, int H, int nk) {
  using L = Chunk<HD, N>;
  constexpr int G = groups<HD>(), NP = N / G;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, d = tid / G, g = tid % G;
  const int blk = blockIdx.x;                 // (b * H + h) * nk + c
  const int c = blk % nk, bh = blk / nk, b = bh / H, h = bh % H;
  // every chunk but the last is whole
  stage<HD, N, false>(sm, x, dt, Bm, nullptr, __ldg(A + h),
                      (size_t)b * S + (size_t)c * kChunk, h, H, kChunk);
  cp_wait<0>();
  __syncthreads();
  float st[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) st[j] = 0.f;
#pragma unroll 8
  for (int t = 0; t < kChunk; ++t) step<HD, N, NP>(sm, t, d, g, st);
  st4<NP>(hs + ((size_t)blk * HD + d) * N + g * NP, st);
  if (tid == 0) {
    float p = 1.f;
    for (int t = 0; t < kChunk; ++t) p = p * sm[L::kDec + t];
    dprod[blk] = p;
  }
}

// hs (BH, nk, E) with E = hd * N: Delta_c in, h_start[c + 1] out; dprod
// (BH, nk); h0 (BH, E). The loads of the next kAhead chunks are issued
// before the current ones' updates and stores, so that they are in flight
// while the chain walks.
__global__ void __launch_bounds__(kChainThreads)
ssm_scan_fwd_chains(const float* __restrict__ h0,
                    const float* __restrict__ dprod, float* __restrict__ hs,
                    int BH, int E, int nk) {
  const size_t i = (size_t)blockIdx.x * kChainThreads + threadIdx.x;
  if (i >= (size_t)BH * E) return;
  const size_t bh = i / E, e = i % E;
  float* v = hs + bh * nk * E + e;
  const float* dp = dprod + bh * nk;
  float carry = h0[i];
  float inc[kAhead], dc[kAhead], ninc[kAhead], ndc[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (k < nk) {
      inc[k] = v[(size_t)k * E];
      dc[k] = __ldg(dp + k);
    }
  for (int k0 = 0; k0 < nk; k0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (k0 + kAhead + k < nk) {
        ninc[k] = v[(size_t)(k0 + kAhead + k) * E];
        ndc[k] = __ldg(dp + k0 + kAhead + k);
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (k0 + k < nk) {
        carry = dc[k] * carry + inc[k];
        v[(size_t)(k0 + k) * E] = carry;
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      inc[k] = ninc[k];
      dc[k] = ndc[k];
    }
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(threads<HD>())
ssm_scan_fwd_outputs(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ A,
                     const float* __restrict__ h0,
                     const float* __restrict__ hs, float* __restrict__ y,
                     float* __restrict__ h_out, int S, int H, int nc) {
  using L = Chunk<HD, N>;
  constexpr int G = groups<HD>(), NP = N / G;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, d = tid / G, g = tid % G;
  const int blk = blockIdx.x;                 // (b * H + h) * nc + c
  const int c = blk % nc, bh = blk / nc, b = bh / H, h = bh % H;
  const int t0 = c * kChunk, nt = min(kChunk, S - t0);
  const size_t row = (size_t)b * S + t0;
  stage<HD, N, true>(sm, x, dt, Bm, Cm, __ldg(A + h), row, h, H, nt);
  // the state entering the chunk, loaded while the copies land: h0 (read
  // by element: its storage need not be 16-byte aligned) or h_start[c] as
  // the chains left it
  const size_t e = (size_t)d * N + g * NP;
  float st[NP];
  if (c == 0) {
#pragma unroll
    for (int j = 0; j < NP; ++j) st[j] = h0[(size_t)bh * HD * N + e + j];
  } else {
    ld4<NP>(hs + ((size_t)bh * (nc - 1) + c - 1) * HD * N + e, st);
  }

  cp_wait<0>();
  __syncthreads();

  const float* cc = sm + L::kC + g * NP;
  float* yp = y + (row * H + h) * HD + d;
  // unrolled, so one token's loads and y sum overlap the next tokens'
  // state updates (the state's own chain is a multiply and an add per
  // token); y's terms fused into its sum in state order
#pragma unroll 8
  for (int t = 0; t < nt; ++t) {
    step<HD, N, NP>(sm, t, d, g, st);
    float cv[NP];
    ld4<NP>(cc + t * N, cv);
    float p = st[0] * cv[0];
#pragma unroll
    for (int j = 1; j < NP; ++j) p = __fmaf_rn(st[j], cv[j], p);
#pragma unroll
    for (int m = 1; m < G; m <<= 1) p += __shfl_xor_sync(FULL_MASK, p, m);
    if (g == 0) yp[(size_t)t * H * HD] = p;
  }
  if (c == nc - 1) st4<NP>(h_out + (size_t)bh * HD * N + e, st);
}

struct FwdArgs {
  const float *x, *dt, *Bm, *Cm, *A, *h0;
  float *hs, *dprod, *y, *h_out;
};

// a launch's dynamic shared memory, the kernel's limit raised where it
// passes the 48 KB a launch gets without asking
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD, int N>
int launch(const FwdArgs& p, int B, int S, int H, cudaStream_t stream) {
  using L = Chunk<HD, N>;
  constexpr int kT = threads<HD>();
  const int nc = (S + kChunk - 1) / kChunk, nk = nc - 1;
  const size_t ibytes = sizeof(float) * L::kC;
  const size_t obytes = sizeof(float) * L::kEnd;
  cudaError_t err = smem_limit(ssm_scan_fwd_outputs<HD, N>, obytes);
  if (err != cudaSuccess) return (int)err;
  if (nk > 0) {
    if (!p.hs || !p.dprod) return (int)cudaErrorInvalidValue;
    if ((err = smem_limit(ssm_scan_fwd_increments<HD, N>, ibytes)) !=
        cudaSuccess)
      return (int)err;
    ssm_scan_fwd_increments<HD, N><<<(unsigned)(B * H * nk), kT, ibytes,
                                      stream>>>(p.x, p.dt, p.Bm, p.A, p.hs,
                                                p.dprod, S, H, nk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t elems = (size_t)B * H * HD * N;
    ssm_scan_fwd_chains<<<(unsigned)((elems + kChainThreads - 1) /
                                     kChainThreads),
                          kChainThreads, 0, stream>>>(
        p.h0, p.dprod, p.hs, B * H, HD * N, nk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssm_scan_fwd_outputs<HD, N><<<(unsigned)(B * H * nc), kT, obytes,
                                 stream>>>(p.x, p.dt, p.Bm, p.Cm, p.A, p.h0,
                                           p.hs, p.y, p.h_out, S, H, nc);
  return (int)cudaGetLastError();
}

template <int N>
int launch_hd(const FwdArgs& p, int B, int S, int H, int hd,
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

// xh, y (B,S,H,hd); dt (B,S,H); B_, C_ (B,S,N); A (H,); h0, h_out
// (B,H,hd,N); all f32 and contiguous, xh/B_/C_ 16-byte aligned; hs
// (B*H, nc - 1, hd, N) and dprod (B*H, nc - 1), nc = ceil(S / 64): the
// chunks' increments, then the states entering them (null where S <= 64,
// nothing read or written). Returns -2 for a head dim other than 16, 32,
// 64 or 128 or a state size other than 8 or 16 (nothing launched), else
// a CUDA error code.
extern "C" int ssm_scan_launch(const void* xh, const void* dt, const void* Bm,
                               const void* Cm, const void* A, const void* h0,
                               void* hs, void* dprod, void* y, void* h_out,
                               int B, int S, int H, int hd, int N,
                               void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const FwdArgs p{(const float*)xh, (const float*)dt, (const float*)Bm,
                  (const float*)Cm, (const float*)A, (const float*)h0,
                  (float*)hs, (float*)dprod, (float*)y, (float*)h_out};
  auto* s = (cudaStream_t)stream;
  switch (N) {
    case 8: return launch_hd<8>(p, B, S, H, hd, s);
    case 16: return launch_hd<16>(p, B, S, H, hd, s);
    default: return kBadShape;
  }
}
