// K6's mask, shared by its forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu): query row `row` keeps key `col` where the causal
// and the window conditions hold, or where the key lies in the prefix
// (prefix-LM: every row sees the first `prefix` keys), in the reference's
// order (causal & window) | prefix. The mask travels as three ints, as the
// kernels take it: a struct of them made the bf16 forward slower (the
// compiler rereads its fields inside the loops).
#pragma once
#include <math.h>

namespace {

__device__ __forceinline__ bool keep(int row, int col, int causal,
                                     int window, int prefix) {
  bool k = true;
  if (causal) k = k && (col <= row);
  if (window > 0) k = k && (col > row - window);
  return k || col < prefix;
}

// no key of [k0, k1) is kept for any row of [r0, r1] (with a window and
// causal, a range this lets through may still keep nothing: its p is 0)
__device__ __forceinline__ bool keys_dead(int k0, int k1, int r0, int r1,
                                          int causal, int window,
                                          int prefix) {
  if (k0 < prefix) return false;
  return (causal && k0 > r1) || (window > 0 && k1 - 1 <= r0 - window);
}

// every key of [k0, k1) is kept for every row of [r0, r1]
__device__ __forceinline__ bool keys_whole(int k0, int k1, int r0, int r1,
                                           int causal, int window,
                                           int prefix) {
  if (k1 - 1 < prefix) return true;
  const int lo = max(k0, prefix);  // the first key past the prefix
  return !(causal && k1 - 1 > r0) && !(window > 0 && lo <= r1 - window);
}

// a row's log-sum-exp from its running max m and sum l: +inf where the row
// kept no key (l = 0), so that exp(s - lse) is 0 there
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(fmaxf(l, 1e-20f)) : INFINITY;
}

}  // namespace
