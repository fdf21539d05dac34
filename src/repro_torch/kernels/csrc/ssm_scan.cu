// K8: the selective scan of the hybrid family's mamba heads.
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
// Bound on an H100: bytes (x in and y out dominate: 105 MB at the hymba
// prefill, ~32 us at 3.35 TB/s); the operations (5 N per channel and
// token) take half that at the f32 rate. The scan is sequential in t, so
// the design spreads the channels: one CTA per (b, h), one thread per
// channel holding its N states in registers (two threads of N / 2 at head
// dim 16, so that a CTA fills a warp, their y halves joined by an xor
// shuffle). Each CTA stages tiles of kTile tokens' x, dt, decay, B and C
// in shared memory, double-buffered: the next tile's loads are in flight
// in registers while the current one is scanned, one barrier per tile.
// Four threads per channel (800 warps at the hymba prefill, not 200) ran
// 22% slower: their shuffles and 32-byte y stores cost more than the
// warps hid (scripts/k8_probe.py).
//
// Built with --fmad=false and IEEE division: each step rounds as the
// plain version's (kernels/ssm_scan.py::ssm_scan_ref); y is summed over
// the states in their order, which torch's einsum need not keep.
#include "common.cuh"

namespace {

constexpr int kTile = 32;    // tokens per staged tile
constexpr int kBadShape = -2;

// threads per channel at head dim HD, each holding N / groups states
template <int HD>
__host__ __device__ constexpr int groups() { return HD >= 32 ? 1 : 2; }

// NP consecutive floats from shared memory (16-byte aligned where
// NP % 4 == 0)
template <int NP>
__device__ __forceinline__ void lds(const float* p, float (&out)[NP]) {
  if constexpr (NP % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NP; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      out[j] = v.x; out[j + 1] = v.y; out[j + 2] = v.z; out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NP; ++j) out[j] = p[j];
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(HD * groups<HD>())
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int H) {
  constexpr int kGroups = groups<HD>();
  constexpr int kThreads = HD * kGroups;
  constexpr int NP = N / kGroups;              // states per thread
  constexpr int kRow4 = HD / 4;                // float4s of one token's x
  constexpr int kX = kTile * kRow4 / kThreads; // x float4s per thread
  constexpr int kBC4 = kTile * N / 4;          // float4s of a B or C tile
  constexpr int kBC = (kBC4 + kThreads - 1) / kThreads;
  static_assert(kTile * kRow4 % kThreads == 0, "x tile split");
  static_assert(kThreads >= kTile, "one thread per token's dt");
  __shared__ __align__(16) float xs[2][kTile * HD];
  __shared__ __align__(16) float bs[2][kTile * N];
  __shared__ __align__(16) float cs[2][kTile * N];
  __shared__ float ds[2][kTile];               // dt
  __shared__ float es[2][kTile];               // decay

  const int tid = threadIdx.x;
  const int d = tid / kGroups, g = tid % kGroups;
  const int bh = blockIdx.x;                   // b * H + h
  const int b = bh / H, h = bh % H;
  const float a = A[h];
  const size_t row = (size_t)b * S;            // token 0 of batch row b

  float st[NP];
  const size_t hoff = ((size_t)bh * HD + d) * N + g * NP;
#pragma unroll
  for (int j = 0; j < NP; ++j) st[j] = h0[hoff + j];

  // the next tile, held in registers while the current one is scanned
  float4 xr[kX], br[kBC], cr[kBC];
  float dr = 0.f;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kX; ++k) {
      const int i = tid + k * kThreads;
      const int t = t0 + i / kRow4;
      xr[k] = t < S ? *reinterpret_cast<const float4*>(
                          x + ((row + t) * H + h) * HD + (i % kRow4) * 4)
                    : zero4;
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      const bool in = i < kBC4 && t0 + i / (N / 4) < S;
      const size_t off = (row + t0) * N + (size_t)i * 4;
      br[k] = in ? *reinterpret_cast<const float4*>(Bm + off) : zero4;
      cr[k] = in ? *reinterpret_cast<const float4*>(Cm + off) : zero4;
    }
    if (tid < kTile)
      dr = t0 + tid < S ? dt[(row + t0 + tid) * H + h] : 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kX; ++k)
      reinterpret_cast<float4*>(xs[buf])[tid + k * kThreads] = xr[k];
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      if (i < kBC4) {
        reinterpret_cast<float4*>(bs[buf])[i] = br[k];
        reinterpret_cast<float4*>(cs[buf])[i] = cr[k];
      }
    }
    if (tid < kTile) {
      ds[buf][tid] = dr;
      es[buf][tid] = expf(dr * a);
    }
  };

  const int n_tiles = (S + kTile - 1) / kTile;
  load(0);
  store(0);
  __syncthreads();
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, t0 = it * kTile;
    if (it + 1 < n_tiles) load(t0 + kTile);
    const int nt = min(kTile, S - t0);
    const float* xc = xs[cur] + d;
    const float* bc = bs[cur] + g * NP;
    const float* cc = cs[cur] + g * NP;
    float* yp = y + ((row + t0) * H + h) * HD + d;
    // unrolled, so one token's loads and y sum overlap the next tokens'
    // state updates (the state's own chain is a multiply and an add per
    // token)
#pragma unroll 8
    for (int t = 0; t < nt; ++t) {
      const float dtx = ds[cur][t] * xc[t * HD];
      const float decay = es[cur][t];
      float bv[NP], cv[NP];
      lds<NP>(bc + t * N, bv);
      lds<NP>(cc + t * N, cv);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float dbx = dtx * bv[j];
        st[j] = st[j] * decay + dbx;
      }
      float p = st[0] * cv[0];
#pragma unroll
      for (int j = 1; j < NP; ++j) p = p + st[j] * cv[j];
#pragma unroll
      for (int m = 1; m < kGroups; m <<= 1)
        p += __shfl_xor_sync(FULL_MASK, p, m);
      if (g == 0) yp[(size_t)t * H * HD] = p;
    }
    if (it + 1 < n_tiles) store(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) h_out[hoff + j] = st[j];
}

template <int HD, int N>
int launch(const float* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* h0, float* y, float* h_out, int B,
           int S, int H, cudaStream_t stream) {
  ssm_scan_kernel<HD, N><<<B * H, HD * groups<HD>(), 0, stream>>>(
      x, dt, Bm, Cm, A, h0, y, h_out, S, H);
  return (int)cudaGetLastError();
}

template <int N>
int launch_hd(const float* x, const float* dt, const float* Bm,
              const float* Cm, const float* A, const float* h0, float* y,
              float* h_out, int B, int S, int H, int hd,
              cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, N>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, H, stream);
    case 32:
      return launch<32, N>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, H, stream);
    case 64:
      return launch<64, N>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, H, stream);
    case 128:
      return launch<128, N>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, H, stream);
    default:
      return kBadShape;
  }
}

}  // namespace

// xh, y (B,S,H,hd); dt (B,S,H); B_, C_ (B,S,N); A (H,); h0, h_out
// (B,H,hd,N); all f32 and contiguous, xh/B_/C_ 16-byte aligned. Returns
// -2 for a head dim other than 16, 32, 64 or 128 or a state size other
// than 8 or 16 (nothing launched), else a CUDA error code.
extern "C" int ssm_scan_launch(const void* xh, const void* dt, const void* Bm,
                               const void* Cm, const void* A, const void* h0,
                               void* y, void* h_out, int B, int S, int H,
                               int hd, int N, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const auto* fx = (const float*)xh;
  const auto* fd = (const float*)dt;
  const auto* fb = (const float*)Bm;
  const auto* fc = (const float*)Cm;
  const auto* fa = (const float*)A;
  const auto* fh = (const float*)h0;
  auto* fy = (float*)y;
  auto* fo = (float*)h_out;
  auto* s = (cudaStream_t)stream;
  switch (N) {
    case 8:
      return launch_hd<8>(fx, fd, fb, fc, fa, fh, fy, fo, B, S, H, hd, s);
    case 16:
      return launch_hd<16>(fx, fd, fb, fc, fa, fh, fy, fo, B, S, H, hd, s);
    default:
      return kBadShape;
  }
}
