// Device helpers shared by the DVFS kernels. Every float expression keeps
// the operation order of the plain PyTorch versions (the library is built
// with --fmad=false and without fast math, so no contraction or
// approximate division changes the rounding).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#define FULL_MASK 0xffffffffu

// The current device's SM count, read from the runtime once per device
// and kept (launchers size their grids by it on every call); 0 where it
// cannot be read.
inline int sm_count() {
  constexpr int kDevices = 64;
  static std::atomic<int> kept[kDevices];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const bool keep = dev >= 0 && dev < kDevices;
  if (keep && (sms = kept[dev].load(std::memory_order_relaxed))) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (keep) kept[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// xor-butterfly reductions: every lane ends with the same bits (IEEE
// addition is commutative, so a + b and b + a round alike)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL_MASK, v, m));
  return v;
}

// collision average of one slot's epoch sums, EMA-blended into the old
// slot (a fresh slot is replaced, an untouched slot keeps its value)
__device__ __forceinline__ void ema_write(float i0, float se, float cnt0,
                                          float isum, float ssum, float cnt,
                                          float ema, float* oi0, float* ose,
                                          float* ocnt) {
  const bool touched = cnt > 0.f;
  const float inew = touched ? isum / fmaxf(cnt, 1.f) : 0.f;
  const float snew = touched ? ssum / fmaxf(cnt, 1.f) : 0.f;
  const bool fresh = (cnt0 == 0.f) && touched;
  const float blend = fresh ? 1.f : (touched ? ema : 0.f);
  *oi0 = i0 * (1.f - blend) + inew * blend;
  *ose = se * (1.f - blend) + snew * blend;
  *ocnt = cnt0 + cnt;
}
