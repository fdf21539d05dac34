// PC-table kernel pair for Hopper (sm_90a): predict and update.
//
// Replaces repro/kernels/pc_table.py:pc_table_predict (_pc_table_kernel)
// and repro/kernels/pc_table.py:pc_table_update (_pc_table_update_kernel).
//
// Bound on this card: at the engine's shape (64 CUs x 40 WFs, 64 tables x
// 128 slots) predict's operands come to ~130 KB and update's to ~230 KB,
// i.e. 0.04-0.07 us of HBM time; both are bound by the launch and by
// their own latency chains, by orders of magnitude. So each wrapper call
// is one launch and nothing else (the index type is a template argument,
// the scalars are read through the caller's pointers or passed by value,
// and predict writes the per-WF hit mask the caller would otherwise
// gather), and the chains are short:
//   * predict: one warp per CU; every lane issues its WFs' slot, fallback
//     and the CU's table id loads at once, then the three table gathers
//     of each WF at once (read-only path): two dependent levels of loads.
//     Lane l sums WFs l, l+32, ... in that order, the warp reduces with
//     xor shuffles (every lane ends with the same bits), then lane k
//     evaluates and clips state k (<= 32 states).
//   * update: one CTA per table; the CTA copies the table's (idx, i0,
//     sens) into shared memory in one coalesced pass (in chunks of
//     kUpdChunk) while each slot's old values load, then one thread per
//     slot walks them in index order and sums the entries that hit its
//     slot: no float atomics, so the collision sums are reproducible and
//     keep the plain order. (A walk reading four slots per int4 was
//     slower, 2.42-2.45 against 2.27-2.29 us alone on the H100.)
#include "common.cuh"

namespace {

constexpr int kPredLanesWf = 4;    // WFs per lane held in flight per pass
constexpr int kPredMaxWarps = 8;   // warps (CUs) per predict CTA
constexpr int kUpdChunk = 1024;    // (idx, i0, sens) staged per pass: 12 KB
constexpr int kUpdMaxThreads = 1024;

// a slot clamped into [0, E), compared before narrowing an int64
template <typename IdxT>
__device__ __forceinline__ int clamp_slot(IdxT x, int E) {
  return x < 0 ? 0 : (x > (IdxT)(E - 1) ? E - 1 : (int)x);
}

template <typename IdxT>
__global__ void __launch_bounds__(kPredMaxWarps * 32)
    pc_table_predict_kernel(
    const float* __restrict__ ti0, const float* __restrict__ tse,
    const float* __restrict__ tcnt, const int* __restrict__ tid,
    const IdxT* __restrict__ idx, const float* __restrict__ fb0,
    const float* __restrict__ fbs, const float* __restrict__ F,
    const float* __restrict__ ep_p, const float* __restrict__ cap_p,
    float ep_v, float cap_v, int CU, int WF, int T, int E, int NF,
    float* __restrict__ out, float* __restrict__ hit) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= CU) return;
  // level 1: the table id, the scalars and this lane's slots and own
  // estimates, none waiting on another
  const int t = clampi(__ldg(tid + c), 0, T - 1);
  const float T_us = ep_p ? __ldg(ep_p) : ep_v;
  const float cap = cap_p ? __ldg(cap_p) : cap_v;
  const float f = lane < NF ? __ldg(F + lane) : 0.f;
  const size_t row = (size_t)c * WF;
  float i0 = 0.f, se = 0.f;
  for (int w0 = lane; w0 < WF; w0 += 32 * kPredLanesWf) {
    int e[kPredLanesWf] = {};
    float a0[kPredLanesWf] = {}, as[kPredLanesWf] = {};
#pragma unroll
    for (int k = 0; k < kPredLanesWf; ++k) {
      const int w = w0 + 32 * k;
      if (w < WF) {
        e[k] = clamp_slot(__ldg(idx + row + w), E);
        a0[k] = __ldg(fb0 + row + w);
        as[k] = __ldg(fbs + row + w);
      }
    }
    // level 2: the three gathers of every WF at once
    float n[kPredLanesWf] = {}, g0[kPredLanesWf] = {};
    float gs[kPredLanesWf] = {};
#pragma unroll
    for (int k = 0; k < kPredLanesWf; ++k) {
      if (w0 + 32 * k < WF) {
        const size_t s = (size_t)t * E + e[k];
        n[k] = __ldg(tcnt + s);
        g0[k] = __ldg(ti0 + s);
        gs[k] = __ldg(tse + s);
      }
    }
#pragma unroll
    for (int k = 0; k < kPredLanesWf; ++k) {
      const int w = w0 + 32 * k;
      if (w < WF) {
        const bool h = n[k] > 0.f;
        i0 += h ? g0[k] : a0[k];
        se += h ? gs[k] : as[k];
        if (hit) hit[row + w] = h ? 1.f : 0.f;
      }
    }
  }
  i0 = warp_sum(i0);
  se = warp_sum(se);
  if (lane < NF) {
    float ip = (i0 + se * f) * T_us;
    if (cap > 0.f) ip = fminf(fmaxf(ip, 0.f), cap * f * T_us * (float)WF);
    out[c * NF + lane] = ip;
  }
}

// one chunk of a table's (idx, i0, sens) into shared memory, each slot
// off the table as -1 (it matches no thread)
template <typename IdxT>
__device__ __forceinline__ void stage_chunk(
    const IdxT* __restrict__ idx, const float* __restrict__ i0,
    const float* __restrict__ se, int E, int nc, int* s_idx, float* s_i0,
    float* s_se) {
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const IdxT x = __ldg(idx + i);
    s_idx[i] = (x >= 0 && x < (IdxT)E) ? (int)x : -1;
    s_i0[i] = __ldg(i0 + i);
    s_se[i] = __ldg(se + i);
  }
}

template <typename IdxT>
__global__ void __launch_bounds__(kUpdMaxThreads) pc_table_update_kernel(
    const float* __restrict__ ti0, const float* __restrict__ tse,
    const float* __restrict__ tcnt, const IdxT* __restrict__ idx,
    const float* __restrict__ i0, const float* __restrict__ se,
    const float* __restrict__ ema_p, float ema_v, float* __restrict__ out,
    int T, int E, int N) {
  __shared__ int s_idx[kUpdChunk];
  __shared__ float s_i0[kUpdChunk], s_se[kUpdChunk];
  const int t = blockIdx.x;
  const size_t base = (size_t)t * N;
  const size_t TE = (size_t)T * E;
  const float ema = ema_p ? __ldg(ema_p) : ema_v;
  const bool one_chunk = N <= kUpdChunk;
  for (int e0 = 0; e0 < E; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    const size_t s = (size_t)t * E + e;
    // the slot's old values in flight while the chunk is staged
    float old_i0 = 0.f, old_se = 0.f, old_cnt = 0.f;
    if (e < E) {
      old_i0 = __ldg(ti0 + s);
      old_se = __ldg(tse + s);
      old_cnt = __ldg(tcnt + s);
    }
    float isum = 0.f, ssum = 0.f, cnt = 0.f;
    for (int n0 = 0; n0 < N; n0 += kUpdChunk) {
      const int nc = min(kUpdChunk, N - n0);
      if (!one_chunk || e0 == 0) {  // one chunk is staged once
        if (!one_chunk)
          __syncthreads();  // the previous chunk is walked by every thread
        stage_chunk(idx + base + n0, i0 + base + n0, se + base + n0, E, nc,
                    s_idx, s_i0, s_se);
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < nc; ++n) {
        if (s_idx[n] == e) {
          isum += s_i0[n];
          ssum += s_se[n];
          cnt += 1.f;
        }
      }
    }
    if (e < E)
      ema_write(old_i0, old_se, old_cnt, isum, ssum, cnt, ema, out + s,
                out + TE + s, out + 2 * TE + s);
  }
}

}  // namespace

// idx64: idx is int64 (else int32). ep_p / cap_p: the caller's f32
// scalars on the card, or null to use ep_v / cap_v. hit: the per-WF hit
// mask (CU, WF) f32, or null.
extern "C" int pc_table_predict_launch(
    const void* ti0, const void* tse, const void* tcnt, const void* tid,
    const void* idx, const void* fb0, const void* fbs, const void* F,
    const void* ep_p, const void* cap_p, float ep_v, float cap_v, int idx64,
    int CU, int WF, int T, int E, int NF, void* out, void* hit,
    void* stream) {
  if (NF > 32 || NF < 1) return (int)cudaErrorInvalidValue;
  // one CU per warp, and as few warps per CTA as spread the CUs over
  // every SM of the card (one warp each up to 132 CUs)
  const int sms = sm_count();
  if (!sms) return (int)cudaErrorInvalidDevice;
  int warps = (CU + sms - 1) / sms;
  warps = warps < 1 ? 1 : (warps > kPredMaxWarps ? kPredMaxWarps : warps);
  const dim3 grid((CU + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  if (idx64)
    pc_table_predict_kernel<long long><<<grid, warps * 32, 0, st>>>(
        (const float*)ti0, (const float*)tse, (const float*)tcnt,
        (const int*)tid, (const long long*)idx, (const float*)fb0,
        (const float*)fbs, (const float*)F, (const float*)ep_p,
        (const float*)cap_p, ep_v, cap_v, CU, WF, T, E, NF, (float*)out,
        (float*)hit);
  else
    pc_table_predict_kernel<int><<<grid, warps * 32, 0, st>>>(
        (const float*)ti0, (const float*)tse, (const float*)tcnt,
        (const int*)tid, (const int*)idx, (const float*)fb0,
        (const float*)fbs, (const float*)F, (const float*)ep_p,
        (const float*)cap_p, ep_v, cap_v, CU, WF, T, E, NF, (float*)out,
        (float*)hit);
  return (int)cudaGetLastError();
}

// out: one (3, T, E) f32 buffer, the new (i0, sens, count) tables.
// ema_p: the caller's f32 scalar on the card, or null to use ema_v.
extern "C" int pc_table_update_launch(
    const void* ti0, const void* tse, const void* tcnt, const void* idx,
    const void* i0, const void* se, const void* ema_p, float ema_v,
    int idx64, int T, int E, int N, void* out, void* stream) {
  const int threads =
      E < kUpdMaxThreads ? ((E + 31) / 32) * 32 : kUpdMaxThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (idx64)
    pc_table_update_kernel<long long><<<T, threads, 0, st>>>(
        (const float*)ti0, (const float*)tse, (const float*)tcnt,
        (const long long*)idx, (const float*)i0, (const float*)se,
        (const float*)ema_p, ema_v, (float*)out, T, E, N);
  else
    pc_table_update_kernel<int><<<T, threads, 0, st>>>(
        (const float*)ti0, (const float*)tse, (const float*)tcnt,
        (const int*)idx, (const float*)i0, (const float*)se,
        (const float*)ema_p, ema_v, (float*)out, T, E, N);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
