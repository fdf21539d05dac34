// PC-table kernel pair for Hopper (sm_90a): predict and update.
//
// Replaces repro/kernels/pc_table.py:pc_table_predict (_pc_table_kernel)
// and repro/kernels/pc_table.py:pc_table_update (_pc_table_update_kernel).
//
// Bound on this card: at the engine's shape (64 CUs x 40 WFs, 64 tables x
// 128 slots) predict's operands come to ~130 KB and update's to ~230 KB,
// i.e. 0.04-0.07 us of HBM time; both are launch-bound by orders of
// magnitude. The design keeps them simple and deterministic:
//   * predict: one warp per CU; lanes stride the CU's wavefronts, gather
//     the table slot (ids clamped into range, like the reference's
//     gathers), fall back to the WF's own estimate on a miss, reduce with
//     xor shuffles (every lane ends with the same bits), then lane k
//     evaluates and clips state k (<= 32 states).
//   * update: one CTA per table, one thread per slot. The thread walks the
//     table's N wavefronts in index order and sums the ones that hit its
//     slot: no float atomics, so the collision sums are reproducible.
#include "common.cuh"

namespace {

__global__ void pc_table_predict_kernel(
    const float* __restrict__ ti0, const float* __restrict__ tse,
    const float* __restrict__ tcnt, const int* __restrict__ tid,
    const int* __restrict__ idx, const float* __restrict__ fb0,
    const float* __restrict__ fbs, const float* __restrict__ F,
    const float* __restrict__ scal, int CU, int WF, int T, int E, int NF,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= CU) return;
  const int t = clampi(tid[c], 0, T - 1);
  float i0 = 0.f, se = 0.f;
  for (int w = lane; w < WF; w += 32) {
    const int e = clampi(idx[c * WF + w], 0, E - 1);
    const bool hit = tcnt[t * E + e] > 0.f;
    i0 += hit ? ti0[t * E + e] : fb0[c * WF + w];
    se += hit ? tse[t * E + e] : fbs[c * WF + w];
  }
  i0 = warp_sum(i0);
  se = warp_sum(se);
  if (lane < NF) {
    const float T_us = scal[0], cap = scal[1], f = F[lane];
    float ip = (i0 + se * f) * T_us;
    if (cap > 0.f) ip = fminf(fmaxf(ip, 0.f), cap * f * T_us * (float)WF);
    out[c * NF + lane] = ip;
  }
}

__global__ void pc_table_update_kernel(
    const float* __restrict__ ti0, const float* __restrict__ tse,
    const float* __restrict__ tcnt, const int* __restrict__ idx,
    const float* __restrict__ i0, const float* __restrict__ se,
    const float* __restrict__ ema_p, float* __restrict__ oi0,
    float* __restrict__ ose, float* __restrict__ ocnt, int E, int N) {
  const int t = blockIdx.x;
  const float ema = ema_p[0];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float isum = 0.f, ssum = 0.f, cnt = 0.f;
    for (int n = 0; n < N; ++n) {
      if (idx[t * N + n] == e) {
        isum += i0[t * N + n];
        ssum += se[t * N + n];
        cnt += 1.f;
      }
    }
    const int s = t * E + e;
    ema_write(ti0[s], tse[s], tcnt[s], isum, ssum, cnt, ema, oi0 + s,
              ose + s, ocnt + s);
  }
}

}  // namespace

extern "C" int pc_table_predict_launch(
    const void* ti0, const void* tse, const void* tcnt, const void* tid,
    const void* idx, const void* fb0, const void* fbs, const void* F,
    const void* scal, int CU, int WF, int T, int E, int NF, void* out,
    void* stream) {
  if (NF > 32 || NF < 1) return (int)cudaErrorInvalidValue;
  const int warps = 8;
  const dim3 grid((CU + warps - 1) / warps);
  pc_table_predict_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)ti0, (const float*)tse, (const float*)tcnt,
      (const int*)tid, (const int*)idx, (const float*)fb0,
      (const float*)fbs, (const float*)F, (const float*)scal, CU, WF, T, E,
      NF, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int pc_table_update_launch(
    const void* ti0, const void* tse, const void* tcnt, const void* idx,
    const void* i0, const void* se, const void* ema, void* oi0, void* ose,
    void* ocnt, int T, int E, int N, void* stream) {
  const int threads = E < 1024 ? ((E + 31) / 32) * 32 : 1024;
  pc_table_update_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ti0, (const float*)tse, (const float*)tcnt,
      (const int*)idx, (const float*)i0, (const float*)se,
      (const float*)ema, (float*)oi0, (float*)ose, (float*)ocnt, E, N);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
