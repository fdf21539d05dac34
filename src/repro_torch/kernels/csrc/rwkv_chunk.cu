// K7: the chunked RWKV6 WKV for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces repro/kernels/rwkv_chunk.py:rwkv_chunked (_rwkv_kernel). The
// TPU kernel walks the chunks of one (batch, head) on a sequential grid
// axis with the (hd, hd) state in VMEM scratch; here one CTA owns a
// (batch, head) and loops over its chunks in order, with the state in
// shared memory, starting from zero.
//
// Bound on this card: at the rwkv6-3b prefill (B 4 x H 40 heads of 64,
// T 2048) the function moves ~0.42 GB (four f32 inputs and y: ~0.125 ms)
// and needs ~6.8 GFLOP, counted from the exact token recurrence (5 hd^2
// + 5 hd per token and head: ~0.10 ms at the f32 rate outside the tensor
// cores; it needs f32), so it is bound by its bytes. The chunked form
// below does more operations than that. With 160 CTAs of one (batch,
// head) each and a sequential chunk loop, this first kernel uses one CTA
// per SM and is far from that bound.
//
// Per chunk of C tokens, in the reference's exp-log form:
//   load     r, k, v (C x hd) and w (C x (hd + 1)) from the (B,T,H,hd)
//            layout the model holds (no transpose);
//   diag_t   sum_d (r u) k, one warp per token;
//   prefix   one thread per column d walks t: logw = log(max(w, 1e-38)),
//            cum += logw, rP = r exp(cum - logw) (over r), then
//            kD = k exp(-cum) (over cum) and kT = k exp(total - cum)
//            (over k), total = the column's last cum;
//   A        A[t][s] = rP_t . kD_s for s < t (C x C in shared memory);
//   y        y_t = (sum_{s<t} A[t][s] v_s + diag_t v_t) + rP_t S;
//   state    S = exp(total) S + sum_s kT_s^T v_s.
// At C 128 and hd 64 that is 214,528 bytes of dynamic shared memory, one
// CTA per SM. No TF32, no atomics; the library is built with --fmad=false
// and exp/log are expf/logf.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr int kTooLarge = -1;  // the chunk does not fit one CTA

size_t smem_bytes(int C, int hd) {
  return sizeof(float) * ((size_t)3 * C * hd + (size_t)C * (hd + 1) +
                          (size_t)C * C + (size_t)hd * hd + C + 2 * hd);
}

__global__ void __launch_bounds__(kThreads) rwkv_chunk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ s_out, int T, int H, int hd, int C, int uB,
    int uH) {
  extern __shared__ float smem[];
  const int LW = hd + 1;
  float* sR = smem;             // C x hd: r, then rP
  float* sK = sR + C * hd;      // C x hd: k, then kT
  float* sV = sK + C * hd;      // C x hd
  float* sW = sV + C * hd;      // C x LW: w, then cum, then kD
  float* sA = sW + C * LW;      // C x C
  float* sS = sA + C * C;       // hd x hd: the carried state
  float* sDiag = sS + hd * hd;  // C
  float* sTot = sDiag + C;      // hd
  float* sU = sTot + hd;        // hd

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t st = (size_t)H * hd;
  const size_t base = (size_t)b * T * st + (size_t)h * hd;
  for (int i = tid; i < hd * hd; i += kThreads) sS[i] = 0.f;
  for (int d = tid; d < hd; d += kThreads)
    sU[d] = u[(size_t)b * uB + (size_t)h * uH + d];
  const int warp = tid >> 5, lane = tid & 31;

  for (int c0 = 0; c0 < T; c0 += C) {
    const size_t cb = base + (size_t)c0 * st;
    __syncthreads();
    for (int i = tid; i < C * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const size_t g = cb + t * st + d;
      sR[i] = r[g];
      sK[i] = k[g];
      sV[i] = v[g];
      sW[t * LW + d] = w[g];
    }
    __syncthreads();
    for (int t = warp; t < C; t += kThreads / 32) {
      float a = 0.f;
      for (int d = lane; d < hd; d += 32)
        a += sR[t * hd + d] * sU[d] * sK[t * hd + d];
      a = warp_sum(a);
      if (lane == 0) sDiag[t] = a;
    }
    __syncthreads();
    if (tid < hd) {
      const int d = tid;
      float cum = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = logf(fmaxf(sW[t * LW + d], 1e-38f));
        cum = cum + lw;
        sW[t * LW + d] = cum;
        sR[t * hd + d] = sR[t * hd + d] * expf(cum - lw);
      }
      sTot[d] = cum;
      for (int t = 0; t < C; ++t) {
        const float ct = sW[t * LW + d], kk = sK[t * hd + d];
        sW[t * LW + d] = kk * expf(-ct);
        sK[t * hd + d] = kk * expf(cum - ct);
      }
    }
    __syncthreads();
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      if (s < t)
        for (int d = 0; d < hd; ++d)
          a = a + sR[t * hd + d] * sW[s * LW + d];
      sA[i] = a;
    }
    __syncthreads();
    for (int i = tid; i < C * hd; i += kThreads) {
      const int t = i / hd, e = i % hd;
      float a = 0.f;
      for (int s = 0; s < t; ++s) a = a + sA[t * C + s] * sV[s * hd + e];
      a = a + sDiag[t] * sV[t * hd + e];
      float x = 0.f;
      for (int d = 0; d < hd; ++d) x = x + sR[t * hd + d] * sS[d * hd + e];
      y[cb + t * st + e] = a + x;
    }
    __syncthreads();
    for (int i = tid; i < hd * hd; i += kThreads) {
      const int d = i / hd, e = i % hd;
      float a = 0.f;
      for (int s = 0; s < C; ++s) a = a + sK[s * hd + d] * sV[s * hd + e];
      sS[i] = expf(sTot[d]) * sS[i] + a;
    }
  }
  if (s_out != nullptr) {
    __syncthreads();
    float* so = s_out + ((size_t)b * H + h) * hd * hd;
    for (int i = tid; i < hd * hd; i += kThreads) so[i] = sS[i];
  }
}

}  // namespace

// r, k, v, w, y (B,T,H,hd) f32 contiguous; u[b * uB + h * uH + d] f32;
// chunks of C tokens (T % C == 0); s_out (B,H,hd,hd) or null.
extern "C" int rwkv_chunk_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 void* s_out, int B, int T, int H, int hd,
                                 int C, int uB, int uH, void* stream) {
  if (B < 1 || H < 1 || C < 1 || T % C != 0 || hd < 1 || hd > kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(C, hd);
  if (bytes > (size_t)kMaxSmem) return kTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv_chunk_kernel<<<dim3(H, B), kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (float*)y, (float*)s_out, T, H, hd, C, uB, uH);
  return (int)cudaGetLastError();
}
