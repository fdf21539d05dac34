// K6: flash attention for Hopper (sm_90a), CUDA cores, f32 arithmetic.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_bhsd
// (_flash_kernel) and the GQA expansion of repro/kernels/ops.py:
// flash_attention. q is read as (B,S,H,hd) and K/V as (B,S,Hkv,hd) by KV
// head h / (H / Hkv): the expanded copy the reference builds never exists.
//
// Bound on this card: at the glm4-9b prefill (B 4, S 2048, H 32, Hkv 2,
// hd 128, causal) the two products are ~137 GFLOP, ~139 us at the tensor
// cores' bf16 rate, ~2.05 ms at the f32 rate outside them; the bytes (q, k,
// v read once, o written once) take ~43 us. This first kernel runs in f32
// on the CUDA cores and is bound by the operations; the tensor cores
// (wgmma on bf16 tiles) are a later step.
//
// Design: one CTA of 256 threads per (64 query rows, head, batch row).
// The key axis is walked in the reference's blocks of blk_k keys, each
// staged through shared memory in sub-tiles of 64 keys (K for the scores,
// then V for the accumulator), converted to f32 on load. Per block:
//   scores   each thread a 4 x 4 register tile of the 64 x 64 sub-tile,
//            dot over hd, then x scale, into the block's score tile;
//   softmax  4 threads per query row: mask to -1e30, the block max,
//            m_new = max(m_prev, block max), p = exp(s - m_new) zeroed where
//            masked, alpha = exp(max(m_prev - m_new, -80)), l = l alpha +
//            sum p, acc = acc alpha + p V (acc: the row's hd / 4 columns);
// and at the end acc / max(l, 1e-20) in q's dtype (round to nearest).
// That is the reference's order of operations. A key block the mask
// removes for every row of the tile (past the diagonal, or wholly before
// the window) is skipped: there the reference's step leaves m, l and acc
// exactly as they were. Shared-memory rows are padded to hd + 1 floats so
// the column-strided reads fall in distinct banks. The library is built
// with --fmad=false, and exp is expf (not __expf).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kQT = 64;       // query rows per CTA
constexpr int kKT = 64;       // keys per staged sub-tile
constexpr int kThreads = 256;
constexpr int kMaxBlkK = 256;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool keep(int row, int col, int causal,
                                     int window) {
  bool k = true;
  if (causal) k = k && (col <= row);
  if (window > 0) k = k && (col > row - window);
  return k;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int H, int Hkv,
    int BK, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  constexpr int ND = HD / 4;
  const int LS = BK + 1;
  float* sQ = smem;              // kQT x LD
  float* sKV = sQ + kQT * LD;    // kKT x LD: a K, then a V, sub-tile
  float* sS = sKV + kKT * LD;    // kQT x LS: the block's scores, then p

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t rowq = (size_t)H * HD;
  const size_t rowk = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * S * rowq + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * rowk + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * rowk + (size_t)hk * HD;
  T* ob = o + (size_t)b * S * rowq + (size_t)h * HD;

  for (int i = tid; i < kQT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * LD + d] =
        q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * rowq + d]) : 0.f;
  }
  // softmax / accumulator layout: query row pr, a quarter ps of its keys
  // and of its hd columns (columns ps, ps + 4, ...)
  const int pr = tid >> 2, ps = tid & 3;
  const int qrow = q0 + pr;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;
  // score layout: rows sr0..sr0+3, columns sc0 + 16 j
  const int sr0 = (tid >> 4) * 4, sc0 = tid & 15;

  const int q_last = min(q0 + kQT, S) - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + BK - 1 <= q0 - window) continue;
    for (int t0 = 0; t0 < BK; t0 += kKT) {
      const int nk = min(kKT, BK - t0);
      __syncthreads();
      for (int i = tid; i < kKT * HD; i += kThreads) {
        const int r = i / HD, d = i % HD;
        sKV[r * LD + d] =
            r < nk ? to_f32(kb[(size_t)(k0 + t0 + r) * rowk + d]) : 0.f;
      }
      __syncthreads();
      float s4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(sr0 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = sKV[(sc0 + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s4[i][j] = s4[i][j] + a[i] * bk[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc0 + 16 * j;
          if (c < nk) sS[(sr0 + i) * LS + t0 + c] = s4[i][j] * scale;
        }
    }
    __syncthreads();
    float* srow = sS + pr * LS;
    float mb = kNegInf;
    for (int c = ps; c < BK; c += 4) {
      const float s = keep(qrow, k0 + c, causal, window) ? srow[c] : kNegInf;
      srow[c] = s;
      mb = fmaxf(mb, s);
    }
    mb = fmaxf(mb, __shfl_xor_sync(FULL_MASK, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(FULL_MASK, mb, 2));
    const float m_new = fmaxf(m, mb);
    float ls = 0.f;
    for (int c = ps; c < BK; c += 4) {
      const float p =
          keep(qrow, k0 + c, causal, window) ? expf(srow[c] - m_new) : 0.f;
      srow[c] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(FULL_MASK, ls, 1);
    ls += __shfl_xor_sync(FULL_MASK, ls, 2);
    const float alpha = expf(fmaxf(m - m_new, -80.f));
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] = acc[j] * alpha;
    for (int t0 = 0; t0 < BK; t0 += kKT) {
      const int nk = min(kKT, BK - t0);
      __syncthreads();
      for (int i = tid; i < kKT * HD; i += kThreads) {
        const int r = i / HD, d = i % HD;
        sKV[r * LD + d] =
            r < nk ? to_f32(vb[(size_t)(k0 + t0 + r) * rowk + d]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nk; ++c) {
        const float p = srow[t0 + c];
        const float* vr = sKV + c * LD + ps;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] = acc[j] + p * vr[4 * j];
      }
    }
  }
  if (qrow < S) {
    const float denom = fmaxf(l, 1e-20f);
    T* orow = ob + (size_t)qrow * rowq + ps;
#pragma unroll
    for (int j = 0; j < ND; ++j) store(orow + 4 * j, acc[j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int blk_k, int causal, int window,
           cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)(kQT + kKT) * (HD + 1) +
                       (size_t)kQT * (blk_k + 1));
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((S + kQT - 1) / kQT, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, blk_k,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int Hkv, int hd, int blk_k, int causal,
              int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, Hkv, blk_k, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, Hkv, blk_k, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, Hkv, blk_k, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Hkv, blk_k, causal, window,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,Hkv,hd), o (B,S,H,hd), all contiguous, dtype 0 =
// f32, 1 = bf16; keys walked in blocks of blk_k (S % blk_k == 0).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int hd, int blk_k,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || blk_k < 1 ||
      blk_k > kMaxBlkK || S % blk_k != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, S, H, Hkv, hd, blk_k, causal,
                            window, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, blk_k,
                                    causal, window, st);
  return (int)cudaErrorInvalidValue;
}
