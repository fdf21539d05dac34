"""The rate of m16n8k8 TF32 ``mma.sync`` on one CUDA card.

    PYTHONPATH=src python3 scripts/tf32_rate_probe.py

Builds a small kernel with the library's flags (into a temporary
directory under ``build/``) and prints SM cycles per ``mma.sync`` per SM
for: (a) products alone, register operands, 8 independent accumulators a
warp; (b) ``warp_mma`` of ``csrc/tf32_mma.cuh`` as the K7 kernels call it
(operands read from shared memory and split into three TF32 terms, lo
rounded), 16 x 8 NT tiles, NT 4 and 8; each at 4, 8 and 16 warps a CTA,
one CTA per SM on every SM.
"""
from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch import kernels as K

SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
KERNEL = r"""
#include "tf32_mma.cuh"
// (a): 8 independent accumulators, ITERS x 8 products a warp
__global__ void pure(long long* cyc, float* sink, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 7);
  float acc[8][4] = {};
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32(acc[n], a, b0, b1);
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  float s = 0.f;
  for (int n = 0; n < 8; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// (b): warp_mma<NT, A rows, B rows, lo rounded> over K = 64 from shared
// memory, ITERS times
template <int NT>
__global__ void split(long long* cyc, float* sink, int iters) {
  extern __shared__ float sm[];
  const int ld = 68;
  float* P = sm + (threadIdx.x >> 5) * 16 * ld;  // a warp's 16 rows
  float* Q = sm + 16 * 16 * ld;                   // 8 NT shared rows
  for (int i = threadIdx.x; i < (16 * 16 + 64) * ld; i += blockDim.x)
    sm[i] = 1.f + 1e-3f * (i % 97);
  float acc[NT][4];
  zero(acc);
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
    warp_mma<NT, true, true, true>(acc, P, ld, Q, ld, 64);
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  float s = 0.f;
  for (int n = 0; n < NT; ++n) s += acc[n][0] + acc[n][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int which, int blocks, int threads, int iters,
                   long long* cyc, float* sink) {
  const int smem = (16 * 16 + 64) * 68 * 4;
  if (which == 0) pure<<<blocks, threads>>>(cyc, sink, iters);
  else if (which == 4) {
    cudaFuncSetAttribute(split<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    split<4><<<blocks, threads, smem>>>(cyc, sink, iters);
  } else {
    cudaFuncSetAttribute(split<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    split<8><<<blocks, threads, smem>>>(cyc, sink, iters);
  }
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
"""


def main():
    torch.cuda.init()
    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        d = Path(tmp)
        for h in SRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "rate.cu").write_text(KERNEL)
        out = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                              str(d / "lib.so"), str(d / "rate.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(out.stdout + out.stderr)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.run.restype = ctypes.c_int
        lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        cyc = torch.zeros(sms, dtype=torch.int64, device="cuda")
        sink = torch.zeros(sms * 1024, device="cuda")
        for which, what in ((0, "products alone, 8 accumulators a warp"),
                            (4, "warp_mma, NT 4, K 64, three terms"),
                            (8, "warp_mma, NT 8, K 64, three terms")):
            for warps in (4, 8, 16):
                iters = 2000 if which == 0 else 100
                code = lib.run(which, sms, 32 * warps, iters,
                               cyc.data_ptr(), sink.data_ptr())
                if code:
                    raise RuntimeError(f"cuda error {code}")
                mmas = warps * iters * (8 if which == 0 else 3 * 8 * which)
                per = float(cyc.double().mean()) / mmas
                print(f"{what}, {warps} warps a CTA: {per:.3f} SM cycles "
                      f"per mma.sync per SM ({1024 * 2 / per:.0f} FLOP a "
                      f"cycle an SM) on {name}", flush=True)


if __name__ == "__main__":
    main()
