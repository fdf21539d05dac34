// f32 products on the tensor cores in three TF32 terms, and the cp.async
// row copies that feed them: the building blocks of K7 (rwkv_chunk.cu) and
// of its backward (rwkv_chunk_bwd.cu). K8's backward (ssm_scan_bwd.cu)
// uses the copies alone.
//
// A product runs as m16n8k8 TF32 mma.sync, each operand split into two
// TF32 values (hi rounded to nearest, lo the exact rest cut to TF32) and
// summed as a_lo b_hi + a_hi b_lo + a_hi b_hi: about 21 bits. Operand rows
// in shared memory are padded (8 floats for rows read along, 4 for rows
// read down) so the fragments' loads hit distinct banks.
#pragma once
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// C rows of one (batch, head) chunk into Cp padded rows of ``ld`` floats:
// cp.async for rows < C, ``pad`` in the rest. Each of the THREADS threads
// copies one 16-byte column of every (THREADS / (HD / 4))-th row.
template <int THREADS, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, size_t st, int C,
                                          int Cp, float pad) {
  constexpr int Q = HD / 4, STEP = THREADS / Q;
  const int q = threadIdx.x % Q;
  int t = threadIdx.x / Q;
  dst += t * ld + 4 * q;
  src += t * st + 4 * q;
  for (; t < Cp; t += STEP, dst += STEP * ld, src += STEP * st) {
    if (t < C)
      cp16(dst, src);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(pad, pad, pad, pad);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = hi + lo, each a TF32 value: hi rounded to nearest (ties away), lo
// the exact rest cut to TF32. A product in three TF32 terms keeps about 21
// bits. Integer and float operations: cvt.rna.tf32.f32 does the same
// rounding at a fraction of their rate.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// The same split with lo rounded to nearest too: x - hi - lo is then
// within 2^-24 |x|, as an f32 rounding.
__device__ __forceinline__ void split_rn(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] += A (16 x K) B (K x 8 NT columns) on the tensor cores, each
// product as a_lo b_hi + a_hi b_lo + a_hi b_hi (the lo x lo term dropped).
// A_ROWS: A row-major at P (16 rows, k along a row), else P holds A^T (K
// rows of 16). B_ROWS: B^T row-major at Q (8 NT rows), else Q holds B (K
// rows of 8 NT). Only the first nt column tiles are computed. The m16n8k8
// fragments' k index t / t + 4 (t = lane % 4) reads k0 + 2t / k0 + 2t + 1
// of both operands: the same sum, and a float2 load along a row, or four
// rows 8 banks apart down a column. The accumulator's element i of tile n
// is row g + 8 (i / 2), column 8 n + 2 (lane % 4) + i % 2 (g = lane / 4).
// ROUND_LO: the operands split by split_rn. A cut lo errs toward zero in
// every product; K7's backward sums such products into gradients that
// cancel (the decay's), where that bias shows.
template <int NT, bool A_ROWS, bool B_ROWS, bool ROUND_LO = false>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* P,
                                         int ldp, const float* Q, int ldq,
                                         int K, int nt = NT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    float a[4];
    if (A_ROWS) {
      const float2 x = ld2(P + g * ldp + k0 + t2),
                   z = ld2(P + (g + 8) * ldp + k0 + t2);
      a[0] = x.x, a[1] = z.x, a[2] = x.y, a[3] = z.y;
    } else {
      const float* p = P + (k0 + t2) * ldp + g;
      a[0] = p[0], a[1] = p[8], a[2] = p[ldp], a[3] = p[ldp + 8];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ROUND_LO)
        split_rn(a[i], ah[i], al[i]);
      else
        split(a[i], ah[i], al[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
      float b0, b1;
      if (B_ROWS) {
        const float2 x = ld2(Q + (8 * n + g) * ldq + k0 + t2);
        b0 = x.x, b1 = x.y;
      } else {
        const float* q = Q + (k0 + t2) * ldq + 8 * n + g;
        b0 = q[0], b1 = q[ldq];
      }
      uint32_t bh0, bl0, bh1, bl1;
      if (ROUND_LO) {
        split_rn(b0, bh0, bl0);
        split_rn(b1, bh1, bl1);
      } else {
        split(b0, bh0, bl0);
        split(b1, bh1, bl1);
      }
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

}  // namespace
