// K8's backward: the gradient of the selective scan (csrc/ssm_scan.cu).
//
// Replaces no TPU kernel: the reference differentiates its lax.scan
// (src/repro/models/ssm.py:16 ssm_scan) with XLA, and eager PyTorch would
// run a reverse scan as ~10 small launches per token. With
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
// hymba training layout, 105 MB each; ~94 us at 3.35 TB/s). The scan is
// sequential in t, so one CTA per (batch, head) and one thread per
// channel holding its N carried gradients in registers, as the forward.
//
// h_{t-1} is recomputed, never rebuilt as (h_t - dBx_t) / a_t (a_t can be
// tiny, and the division loses the state): a forward pass stores the
// state entering every tile of kTile tokens in a global scratch (each
// thread its own channel's column), then the reverse pass walks the tiles
// from the last, recomputes the tile's states from its checkpoint into
// shared memory (in the forward's operation order, so they are K8's
// bits), and walks the tile's tokens backwards. Each tile's operands are
// loaded together before its chains of updates (B and C rows staged in
// shared memory, the channel's x and gy and the tokens' dt in registers),
// so a tile waits on memory once, not once per token. The sums over channels
// (dC_, dB_, ddt, dA) are deterministic: each token's per-channel terms
// go to shared memory, and after the tile every thread sums whole rows
// over the channels in index order into per-(b, t, h) partials; the
// wrapper sums dB_ and dC_ over the heads and dA over the batch (torch's
// fixed-order reductions). No atomics.
//
// Built with --fmad=false and IEEE division, as the forward.
#include "common.cuh"

namespace {

constexpr int kTile = 8;     // tokens per reverse tile
constexpr int kBadShape = -2;

// floats of dynamic shared memory: the tile's states (then the dC terms
// h_t gy_t), the dB terms gh_t x_t, both [t][n][d] with rows padded to
// HD + 1, the ddt terms [t][d], and the tile's B and C rows [t][n]
template <int HD, int N>
__host__ __device__ constexpr int smem_floats() {
  return 2 * kTile * N * (HD + 1) + kTile * (HD + 1) + 2 * kTile * N;
}

template <int N>
__device__ __forceinline__ void ldg_row(const float* p, float (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
    out[j] = v.x; out[j + 1] = v.y; out[j + 2] = v.z; out[j + 3] = v.w;
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(HD)
ssm_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ A,
                    const float* __restrict__ h0,
                    const float* __restrict__ gy,
                    const float* __restrict__ ghout,
                    float* __restrict__ ck, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dBp,
                    float* __restrict__ dCp, float* __restrict__ dAp,
                    float* __restrict__ dh0, int S, int H) {
  constexpr int kRow = HD + 1;                 // padded row of channels
  extern __shared__ float smem[];
  float* hs = smem;                            // [kTile][N][kRow]
  float* qs = hs + kTile * N * kRow;           // [kTile][N][kRow]
  float* rs = qs + kTile * N * kRow;           // [kTile][kRow]
  float* bs = rs + kTile * kRow;               // [kTile][N]
  float* cs = bs + kTile * N;                  // [kTile][N]

  const int d = threadIdx.x;
  const int bh = blockIdx.x;                   // b * H + h
  const int b = bh / H, h = bh % H;
  const float a = A[h];
  const size_t row = (size_t)b * S;            // token 0 of batch row b
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t hoff = ((size_t)bh * HD + d) * N;
  // this channel's checkpoints: [tile][n] with stride HD between states
  float* ckd = ck + (size_t)bh * n_tiles * N * HD + d;

  // forward: the state entering each tile; a tile's loads are issued
  // together, ahead of its chain of state updates
  float st[N];
#pragma unroll
  for (int j = 0; j < N; ++j) st[j] = h0[hoff + j];
  for (int k = 0; k < n_tiles; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) ckd[((size_t)k * N + j) * HD] = st[j];
    if (k + 1 == n_tiles) break;
    float dtr[kTile], xr[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const size_t tok = (row + k * kTile + i) * H + h;
      dtr[i] = __ldg(dt + tok);
      xr[i] = __ldg(x + tok * HD + d);
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const float decay = expf(dtr[i] * a);
      const float dtx = dtr[i] * xr[i];
      float bv[N];
      ldg_row<N>(Bm + (row + k * kTile + i) * N, bv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dbx = dtx * bv[j];
        st[j] = st[j] * decay + dbx;
      }
    }
  }

  // reverse: the carried gradient g, tile by tile from the last
  float g[N];
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] = ghout[hoff + j];
  float dA_acc = 0.f;
  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * kTile, nt = min(kTile, S - t0);
    // the tile's operands: B and C rows staged in shared memory, this
    // channel's x and gy and the tokens' dt and decay in registers
    for (int i = d; i < 2 * kTile * N; i += HD) {
      const int t = (i % (kTile * N)) / N;
      const float* src = i < kTile * N ? Bm : Cm;
      bs[i] = t < nt ? __ldg(src + (row + t0) * N + i % (kTile * N)) : 0.f;
    }
    float dtr[kTile], er[kTile], xr[kTile], gr[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const size_t tok = (row + t0 + min(i, nt - 1)) * H + h;
      dtr[i] = __ldg(dt + tok);
      er[i] = expf(dtr[i] * a);
      xr[i] = __ldg(x + tok * HD + d);
      gr[i] = __ldg(gy + tok * HD + d);
    }
    float hp0[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      hp0[j] = ckd[((size_t)k * N + j) * HD];
      st[j] = hp0[j];
    }
    __syncthreads();
    // the tile's states h_t, recomputed as the forward computes them
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < nt) {
        const float dtx = dtr[i] * xr[i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float dbx = dtx * bs[i * N + j];
          st[j] = st[j] * er[i] + dbx;
          hs[(i * N + j) * kRow + d] = st[j];
        }
      }
    }
    // the tile's tokens backwards; each thread touches only its own
    // channel's column of hs, qs and rs here
#pragma unroll
    for (int i = kTile - 1; i >= 0; --i) {
      if (i < nt) {
        const float decay = er[i], xd = xr[i], gyd = gr[i];
        float sB = 0.f, sH = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          g[j] = g[j] + cs[i * N + j] * gyd;   // gh_t
          const float hp = i > 0 ? hs[((i - 1) * N + j) * kRow + d]
                                 : hp0[j];
          sB = sB + g[j] * bs[i * N + j];
          sH = sH + g[j] * hp;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float* hv = hs + (i * N + j) * kRow + d;
          *hv = *hv * gyd;                     // h_t gy_t: dC's term
          qs[(i * N + j) * kRow + d] = g[j] * xd;  // gh_t x_t: dB's term
          g[j] = decay * g[j];
        }
        const size_t tok = (row + t0 + i) * H + h;
        dx[tok * HD + d] = dtr[i] * sB;
        rs[i * kRow + d] = xd * sB + (a * decay) * sH;
        dA_acc = dA_acc + (decay * dtr[i]) * sH;
      }
    }
    __syncthreads();
    // the sums over the channels, each row in channel order: dC_ and dB_
    // per (token, state), ddt per token
    for (int i = d; i < 2 * kTile * N + kTile; i += HD) {
      const float* src;
      int t;
      if (i < 2 * kTile * N) {
        t = (i % (kTile * N)) / N;
        src = (i < kTile * N ? hs : qs) + (i % (kTile * N)) * kRow;
      } else {
        t = i - 2 * kTile * N;
        src = rs + t * kRow;
      }
      if (t >= nt) continue;
      float s = src[0];
      for (int c = 1; c < HD; ++c) s = s + src[c];
      const size_t tok = (row + t0 + t) * H + h;
      if (i < kTile * N)
        dCp[tok * N + i % N] = s;
      else if (i < 2 * kTile * N)
        dBp[tok * N + i % N] = __ldg(dt + tok) * s;
      else
        ddt[tok] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < N; ++j) dh0[hoff + j] = g[j];
  // dA's (batch, head) partial, summed over the channels in order
  rs[d] = dA_acc;
  __syncthreads();
  if (d == 0) {
    float s = rs[0];
    for (int c = 1; c < HD; ++c) s = s + rs[c];
    dAp[bh] = s;
  }
}

struct BwdArgs {
  const float *x, *dt, *Bm, *Cm, *A, *h0, *gy, *ghout;
  float *ck, *dx, *ddt, *dBp, *dCp, *dAp, *dh0;
};

template <int HD, int N>
int launch(const BwdArgs& p, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_bwd_kernel<HD, N><<<B * H, HD, smem, stream>>>(
      p.x, p.dt, p.Bm, p.Cm, p.A, p.h0, p.gy, p.ghout, p.ck, p.dx, p.ddt,
      p.dBp, p.dCp, p.dAp, p.dh0, S, H);
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
// xh/B_/C_ 16-byte aligned; ck the checkpoints (B*H, ceil(S / 8), N, hd);
// dB_part, dC_part (B,S,H,N) and dA_part (B,H): the per-head and
// per-batch partials. Returns -2 for a head dim other than 16, 32, 64 or
// 128 or a state size other than 8 or 16 (nothing launched), else a CUDA
// error code.
extern "C" int ssm_scan_bwd_launch(const void* xh, const void* dt,
                                   const void* Bm, const void* Cm,
                                   const void* A, const void* h0,
                                   const void* gy, const void* g_hout,
                                   void* ck, void* dx, void* ddt,
                                   void* dB_part, void* dC_part,
                                   void* dA_part, void* dh0, int B, int S,
                                   int H, int hd, int N, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs p{(const float*)xh, (const float*)dt, (const float*)Bm,
                  (const float*)Cm, (const float*)A, (const float*)h0,
                  (const float*)gy, (const float*)g_hout, (float*)ck,
                  (float*)dx, (float*)ddt, (float*)dB_part,
                  (float*)dC_part, (float*)dA_part, (float*)dh0};
  auto* s = (cudaStream_t)stream;
  switch (N) {
    case 8: return launch_hd<8>(p, B, S, H, hd, s);
    case 16: return launch_hd<16>(p, B, S, H, hd, s);
    default: return kBadShape;
  }
}
