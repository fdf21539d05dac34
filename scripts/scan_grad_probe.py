"""The gradients of K7 and K8 on one CUDA card, at the training layouts.

    PYTHONPATH=src python3 scripts/scan_grad_probe.py [--train ARCH ...] [--trace]
        [--ab OTHER_CSRC]

Prints nvcc's report for the K8 and K7 backward kernels (registers,
spills, shared memory), then holds K8's against its plain version at
hymba-1.5b's training layout (B 4, S 4096, 25 heads of 64, N 16, from a
non-zero h0 and g_hout), checks two calls bit for bit, times it by
``scripts/devtime.py`` beside its bound (bytes at 3.35e12 B/s), splits
it by its three launches with torch.profiler and prints the CTAs of
each launch resident on one SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
on a copy of the source built with the library's flags); holds K7's
backward kernel against its plain version (PyTorch operations,
``rwkv_chunked_bthd_bwd_ref``) and against autograd through K7's plain
version at rwkv6-3b's training microbatch (B 4, T 4096, 40 heads of 64,
chunk 128, with a gS), checks two calls bit for bit, times the kernel on
the card by ``scripts/devtime.py`` (the plain version by events over 5
calls) beside the kernel's bound (``roofline.work``), splits it by its
three launches with torch.profiler and prints the CTAs of each launch
resident on one SM. With ``--ab`` it also builds another checkout's
``ssm_scan_bwd.cu`` and ``rwkv_chunk_bwd.cu`` (a directory of csrc, e.g.
a parent unpacked with ``git archive`` under ``build/``), checks their
outputs against this tree's and times each pair in turns (other, this,
this, other) at the same layouts. With ``--train`` it trains each named
model at full width for ``--steps`` steps of 8 x 4096 tokens in
``--microbatches`` microbatches through ``make_train_step`` and prints
step seconds and peak memory. With ``--trace`` it also builds a copy of
``csrc/rwkv_chunk_bwd.cu`` whose gradients kernel stamps thread 0's SM
clock at each phase of every tile (the library's flags, into a temporary
directory under ``build/``), runs it once at rwkv6-3b's training
microbatch, and prints the mean SM cycles of each phase, how many tiles
were in flight at once and the tail, for thread 0 (warp 0: the query
side and dv of rows 0-15, the longest key side) and for the last thread
(a dk warp, and the thread that issues the tile's copies).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import devtime as DT  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.kernels import rwkv_chunk as RC  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.roofline import work as W  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def card() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.abs().max())


K8_BWD_KERNELS = ("ssm_scan_bwd_increments", "ssm_scan_bwd_chains",
                  "ssm_scan_bwd_grads")
# appended to a copy of csrc/ssm_scan_bwd.cu: the CTAs of each launch
# resident on one SM at (hd, N), as the launcher sizes them
OCCUPANCY = """
extern "C" int k8b_occupancy(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ssm_scan_bwd_increments<64, 16>, 128,
      sizeof(float) * Chunk<64, 16>::kEnd);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, ssm_scan_bwd_chains, kChainThreads, 0);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssm_scan_bwd_grads<64, 16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * Grads<64, 16>::kEnd));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, ssm_scan_bwd_grads<64, 16>, 128,
        sizeof(float) * Grads<64, 16>::kEnd);
  return (int)e;
}
"""


def build_copy(csrc: Path, tmp: Path, extra: str = "",
               name: str = "ssm_scan_bwd.cu") -> ctypes.CDLL:
    """``csrc``'s ``name`` (with ``extra`` appended) and its headers built
    alone, with the library's flags, into ``tmp``."""
    for h in csrc.glob("*.cuh"):
        (tmp / h.name).write_text(h.read_text())
    (tmp / name).write_text((csrc / name).read_text() + extra)
    out = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                          str(tmp / "lib.so"), str(tmp / name)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {csrc / name}:\n"
                           f"{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(tmp / "lib.so"))


def k8_occupancy(name):
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        lib = build_copy(SRC, Path(tmp), OCCUPANCY)
        out = (ctypes.c_int * 3)()
        code = lib.k8b_occupancy(out)
        if code:
            raise RuntimeError(f"k8b_occupancy: cuda error {code}")
    print("K8 bwd CTAs resident per SM at hd 64, N 16: " + ", ".join(
        f"{n} {v}" for n, v in zip(K8_BWD_KERNELS, out)) + f" on {name}",
        flush=True)


def other_k8_bwd(lib, src: str):
    """A call of another checkout's K8 backward entry point: its buffers
    by the names of its C prototype's parameters (the chunk or tile from
    the source's ``kChunk`` or ``kTile``)."""
    proto = re.search(r'extern "C" int ssm_scan_bwd_launch\((.*?)\)', src,
                      re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in proto.split(",")]
    span = int((re.search(r"kChunk = (\d+);", src)
                or re.search(r"kTile = (\d+);", src)).group(1))
    fn = lib.ssm_scan_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int if p in ("B", "S", "H", "hd", "N")
                   else ctypes.c_void_p for p in params]

    def call(xh, dt, B_, C_, A, h0, gy, g_hout):
        B, S, H, hd = xh.shape
        N = B_.shape[-1]
        n = -(-S // span)
        f32 = dict(dtype=torch.float32, device=xh.device)
        bufs = dict(xh=xh, dt=dt, Bm=B_, Cm=C_, A=A, h0=h0, gy=gy,
                    g_hout=g_hout, dx=torch.empty_like(xh),
                    ddt=torch.empty_like(dt), dh0=torch.empty_like(h0),
                    dB_part=torch.empty((B, S, H, N), **f32),
                    dC_part=torch.empty((B, S, H, N), **f32),
                    dA_part=torch.empty((B, H, n), **f32),
                    ck=torch.empty((B * H, n, N, hd), **f32),
                    hs=torch.empty((B * H, n, hd, N), **f32),
                    gs=torch.empty((B * H, n, hd, N), **f32),
                    dprod=torch.empty((B * H, n), **f32))
        ints = dict(B=B, S=S, H=H, hd=hd, N=N)
        args = [ints[p] if p in ints else
                torch.cuda.current_stream().cuda_stream if p == "stream"
                else bufs[p].data_ptr() for p in params]
        code = fn(*args)
        if code:
            raise RuntimeError(f"other K8 backward: cuda error {code}")
        # dA per (batch, head) in the checkpointing form, per (batch,
        # head, chunk) in the chunked one
        dA = (bufs["dA_part"].flatten()[:B * H].view(B, H).sum(0)
              if "ck" in params else bufs["dA_part"].sum((0, 2)))
        return (bufs["dx"], bufs["ddt"], bufs["dB_part"].sum(2),
                bufs["dC_part"].sum(2), dA, bufs["dh0"])
    return call


def k8_ab(dev, name, other: Path, args):
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        lib = build_copy(other, Path(tmp))
        call = other_k8_bwd(lib, (other / "ssm_scan_bwd.cu").read_text())
        theirs, ours = call(*args), SS.ssm_scan_bwd(*args)
        torch.cuda.synchronize()
        print("K8 bwd against the other tree's: " + ", ".join(
            f"{n} {rel(a, b):.3e}" for n, a, b in zip(
                ("dxh", "ddt", "dB_", "dC_", "dA", "dh0"), ours, theirs))
            + " of its largest magnitude", flush=True)
        del theirs, ours
        times = []
        for who in ("other", "this", "this", "other"):
            fn = (lambda: call(*args)) if who == "other" else (
                lambda: SS.ssm_scan_bwd(*args))
            times.append((who, DT.device_ms(fn, 20)))
    print("K8 bwd in turns at hymba's training layout (ms per call, "
          "device): " + " / ".join(f"{w} {t}" for w, t in times)
          + f" on {name}", flush=True)


def k8_bwd(dev, name, other=None):
    B, S, H, hd, N = 4, 4096, 25, 64, 16
    rng = np.random.default_rng(5)
    f = np.float32
    arrs = (rng.standard_normal((B, S, H, hd)), rng.uniform(0.01, 1.5,
                                                            (B, S, H)),
            rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
            -rng.uniform(0.2, 2.0, H), rng.standard_normal((B, H, hd, N)) * .5,
            rng.standard_normal((B, S, H, hd)),
            rng.standard_normal((B, H, hd, N)))
    args = [torch.as_tensor(a.astype(f)).to(dev) for a in arrs]
    got = SS.ssm_scan_bwd(*args)
    again = SS.ssm_scan_bwd(*args)
    t0 = time.perf_counter()
    want = SS.ssm_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for n, g, w in zip(("dxh", "ddt", "dB_", "dC_", "dA", "dh0"), got, want):
        print(f"K8 bwd {n}: max |err| {float((g - w).abs().max()):.3e}, "
              f"{rel(g, w):.3e} of its largest magnitude", flush=True)
    print(f"K8 bwd two calls bitwise equal: "
          f"{all(torch.equal(a, b) for a, b in zip(got, again))}")
    ms = DT.device_ms(lambda: SS.ssm_scan_bwd(*args), 20)
    nb = sum(t.numel() * 4 for t in args) + sum(t.numel() * 4 for t in got)
    split = DT.kernel_means(lambda: SS.ssm_scan_bwd(*args), K8_BWD_KERNELS,
                            20)
    print(f"K8 bwd at hymba's training layout (B {B} S {S} H {H} hd {hd} N "
          f"{N}): device {ms} ms per call, bound "
          f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes {nb / 1e6:.1f} MB), "
          f"plain {plain_s * 1e3:.1f} ms; by launch "
          + ", ".join(f"{n} {m} ms ({c} records)"
                      for n, (m, c) in split.items())
          + f" on {name}", flush=True)
    del got, again, want
    k8_occupancy(name)
    if other is not None:
        k8_ab(dev, name, other, args)


K7_BWD_KERNELS = ("rwkv_chunk_bwd_increments", "rwkv_chunk_bwd_chains",
                  "rwkv_chunk_bwd_grads")
# appended to a copy of csrc/rwkv_chunk_bwd.cu: the CTAs of each launch
# resident on one SM at head dim 64, chunk 128, as the launcher sizes them
K7_OCCUPANCY = """
extern "C" int k7b_occupancy(int* out) {
  const int ib = (int)(sizeof(float) * inc_floats(128, 64));
  const int gb = (int)(sizeof(float) * GradLayout(128, 64).floats);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv_chunk_bwd_increments<64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ib);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, rwkv_chunk_bwd_increments<64>, kIncThreads, ib);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, rwkv_chunk_bwd_chains<64>, kChainThreads, 0);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rwkv_chunk_bwd_grads<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, gb);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, rwkv_chunk_bwd_grads<64>, kThreads, gb);
  out[3] = gb;
  return (int)e;
}
"""


def k7_entry(lib):
    """``rwkv_chunk_bwd_launch`` of a built copy, as a call on the
    wrapper's operands (the buffers ``_bwd_launch`` allocates; du summed
    over the chunks and, for u (H, hd), the batch)."""
    fn = lib.rwkv_chunk_bwd_launch
    fn.restype, fn.argtypes = K.SIGNATURES["rwkv_chunk_bwd_launch"]

    def call(r, k, v, w, u, gy, gS, C):
        B, T, H, hd = r.shape
        nc = T // C
        ue = u.expand(B, H, hd)
        outs = [torch.empty_like(r) for _ in range(4)]
        du = torch.empty((B, H, nc, hd), device=r.device)
        states = torch.empty((2, B * H * nc, hd, hd), device=r.device)
        vecs = torch.empty((2, B * H * nc, hd), device=r.device)
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  ue.data_ptr(), gy.data_ptr(),
                  None if gS is None else gS.data_ptr(),
                  *(t.data_ptr() for t in outs), du.data_ptr(),
                  states[0].data_ptr(), states[1].data_ptr(),
                  vecs[0].data_ptr(), vecs[1].data_ptr(), B, T, H, hd, C,
                  ue.stride(0), ue.stride(1),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"K7 backward copy: cuda error {code}")
        du = du.sum(2)
        return (*outs, du.sum(0) if u.dim() == 2 else du)
    return call


def k7_occupancy(lib, who, name):
    out = (ctypes.c_int * 4)()
    code = lib.k7b_occupancy(out)
    if code:
        raise RuntimeError(f"k7b_occupancy: cuda error {code}")
    print(f"K7 bwd CTAs resident per SM at hd 64, chunk 128 ({who}): "
          + ", ".join(f"{n} {v}" for n, v in zip(K7_BWD_KERNELS, out))
          + f"; the gradients' shared memory {out[3]} B on {name}",
          flush=True)


def k7_ab(name, other: Path, args, C):
    """Another checkout's K7 backward against this tree's: outputs, both
    trees' CTAs per SM, and the two timed in turns."""
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        lib = build_copy(other, Path(tmp), K7_OCCUPANCY, "rwkv_chunk_bwd.cu")
        k7_occupancy(lib, "the other tree", name)
        call = k7_entry(lib)
        theirs = call(*args, C)
        ours = RC.rwkv_chunked_bthd_bwd(*args, chunk=C)
        torch.cuda.synchronize()
        print("K7 bwd against the other tree's: " + ", ".join(
            f"d{n} {rel(a, b):.3e}" for n, a, b in zip("rkvwu", ours, theirs))
            + " of its largest magnitude", flush=True)
        del theirs, ours
        times = []
        for who in ("other", "this", "this", "other"):
            fn = (lambda: call(*args, C)) if who == "other" else (
                lambda: RC.rwkv_chunked_bthd_bwd(*args, chunk=C))
            times.append((who, DT.device_ms(fn, 20)))
    print("K7 bwd in turns at rwkv6-3b's training microbatch (ms per call, "
          "device): " + " / ".join(f"{w} {t}" for w, t in times)
          + f" on {name}", flush=True)


def k7_bwd(dev, name, other=None):
    B, T, H, hd, C = 4, 4096, 40, 64, 128
    rng = np.random.default_rng(6)
    f = np.float32
    r, k, v, gy = (torch.as_tensor(rng.standard_normal(
        (B, T, H, hd)).astype(f) * 0.5).to(dev) for _ in range(4))
    w = torch.as_tensor(rng.uniform(0.6, 0.999, (B, T, H, hd)).astype(
        f)).to(dev)
    u = torch.as_tensor(rng.standard_normal((H, hd)).astype(f) * .1).to(dev)
    gS = torch.as_tensor(rng.standard_normal((B, H, hd, hd)).astype(f)
                         * .1).to(dev)
    args = (r, k, v, w, u, gy, gS)
    got = RC.rwkv_chunked_bthd_bwd(*args, chunk=C)
    again = RC.rwkv_chunked_bthd_bwd(*args, chunk=C)
    plain = RC.rwkv_chunked_bthd_bwd_ref(*args, chunk=C)
    ins = [t.clone().requires_grad_() for t in args[:5]]
    want = torch.autograd.grad(RC.rwkv_chunked_bthd_ref(
        *ins, chunk=C, return_state=True), ins, (gy, gS))
    for n, g, p, wt in zip("rkvwu", got, plain, want):
        print(f"K7 bwd d{n}: {rel(g, p):.3e} of its largest magnitude "
              f"against the plain version, {rel(g, wt):.3e} against "
              f"autograd", flush=True)
    print(f"K7 bwd two calls bitwise equal: "
          f"{all(torch.equal(a, b) for a, b in zip(got, again))}")
    del plain, want, ins, again

    def kernel():
        RC.rwkv_chunked_bthd_bwd(*args, chunk=C)
    ms = DT.device_ms(kernel, 20)
    # the plain version queues ~150 launches a call: events over 5 calls
    plain_ms = DT.events_ms(
        lambda: RC.rwkv_chunked_bthd_bwd_ref(*args, chunk=C), 5, 1)
    nb = W.nbytes(*args, *got)
    bound, by = W.bound_ms(nb, W.rwkv_bwd_flops(B * H, T, hd))
    split = DT.kernel_means(kernel, K7_BWD_KERNELS, 20)
    print(f"K7 bwd at rwkv6-3b's training microbatch (B {B} T {T} H {H} hd "
          f"{hd} C {C}): kernel {ms} ms per call (device), plain version "
          f"{plain_ms} ms, bound {bound:.4f} ms ({by}; {nb / 1e9:.3f} GB, "
          f"{W.rwkv_bwd_flops(B * H, T, hd) / 1e9:.2f} GFLOP); by launch "
          + ", ".join(f"{n} {m} ms ({c} records)"
                      for n, (m, c) in split.items())
          + f" on {name}", flush=True)
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        k7_occupancy(build_copy(SRC, Path(tmp), K7_OCCUPANCY,
                                "rwkv_chunk_bwd.cu"), "this tree", name)
    if other is not None:
        k7_ab(name, other, args, C)


# the gradients kernel's trace: the SM clock of thread 0 and of the last
# thread at the end of each phase of a tile (the stamp goes just before the
# line each anchor starts), then the global timer (ns) at the tile's start
# and end and the SM id. Thread 0 is in warp 0 (the query side and dv of
# rows 0-15); the last thread in warp 15 (dk of rows 64-79, and the thread
# that issues the copies).
TRACE_START = "    if (tid < HD) {\n      sU[tid]"
TRACE_PHASES = (
    ("w, r, k and the states in", "    // the prefix of logw down each"),
    ("logw's local prefix; gy and v in",
     "    row_dots<HD>(sDdiag, sGy, sV, ld, Cp);"),
    ("offsets, ddiag", "    for (int pu = warp; pu < PU; pu += kWarps) {\n"
     "      const int pb = pu / CQ, pe0 = (pu % CQ) * WP, p0 = pb * 16;\n"
     "      if (pb >= RB) continue;\n      float dg[2]"),
    ("cum, rP', kD', diag", "    // the products, a unit at a time"),
    ("key side by blocks: dv = A^T gy (warp 0), d_kD (the last)",
     "      // dv += kT G; d_kT = v G^T"),
    ("kT G (warp 0), v G^T (the last)",
     "      if (act && query) {  // dv + diag gy, written"),
    ("dv out (warp 0)", "      if (act && !query) {"),
    ("dk's fold (the last)", "      // the query side of rows t: d_rP 2^j"),
    ("gy S^T (warp 0)",
     "      if (qact) {\n#pragma unroll 1\n        for (int sb"),
    ("query side: dA kD' by blocks (warp 0)",
     "        // dr = d_rP P + ddiag u k; gP"),
    ("dr and gP (warp 0)", "    __syncthreads();  // every product done"),
    ("every warp's products",
     "    if (issuer) {\n      tc::mbar_expect_tx(barW"),
    ("copies issued; gP, -gE - gF out", "    // dw: dlogw = the suffix sum"),
    ("dcum's local suffix",
     "    if (tid < HD) {\n      // du's part of this tile"),
    ("du, d_total and the later blocks' sums",
     "    tc::mbar_wait(barW, it & 1);  // w again"),
    ("w in; dw out (warp 0)",
     "    __syncthreads();\n    if (issuer && next < tiles)\n      issue_gvs"),
    ("every warp's dw", "    if (issuer && next < tiles)\n      issue_gvs"))
NPT = 2 * (len(TRACE_PHASES) + 1) + 3
LAST = len(TRACE_PHASES) + 1  # where the last thread's stamps start


def _stamp(k):
    return (f"if (threadIdx.x == 0) k7b_trace[(size_t)tile * {NPT} + {k}] = "
            f"clock64();\nif (threadIdx.x == blockDim.x - 1) k7b_trace[("
            f"size_t)tile * {NPT} + {LAST + k}] = clock64();\n")


def traced_source(tiles):
    """The backward's source with the gradients kernel's stamps."""
    src = (SRC / "rwkv_chunk_bwd.cu").read_text()
    g = ("if (threadIdx.x == 0) {{ unsigned long long t; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); k7b_trace[(size_t)"
         "tile * {n} + {k}] = t; }}\n")
    edits = [("namespace {\n", "namespace {\n__device__ unsigned long long "
              f"k7b_trace[{tiles * NPT}];\n"),
             (TRACE_START, _stamp(0) + g.format(n=NPT, k=NPT - 3)
              + "if (threadIdx.x == 0) { unsigned sm; asm(\"mov.u32 %0, "
              f"%%smid;\" : \"=r\"(sm)); k7b_trace[(size_t)tile * "
              f"{NPT} + {NPT - 1}] = sm; }}\n" + TRACE_START)]
    for k, (_, anchor) in enumerate(TRACE_PHASES, start=1):
        stamp = _stamp(k)
        if k == len(TRACE_PHASES):
            stamp += g.format(n=NPT, k=NPT - 2)
        edits.append((anchor, stamp + anchor))
    edits.append(('extern "C" int rwkv_chunk_bwd_launch(',
                  'extern "C" int k7b_trace_read(void* dst) {\n  return (int)'
                  'cudaMemcpyFromSymbol(dst, k7b_trace, sizeof(k7b_trace));\n'
                  '}\n\nextern "C" int rwkv_chunk_bwd_launch('))
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"trace anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def k7_bwd_trace(dev, name):
    B, T, H, hd, C = 4, 4096, 40, 64, 128
    nc = T // C
    tiles = B * H * nc
    rng = np.random.default_rng(6)
    f = np.float32
    r, k, v, w, gy = (torch.as_tensor(a.astype(f)).to(dev) for a in (
        *(rng.standard_normal((B, T, H, hd)) * 0.5 for _ in range(3)),
        rng.uniform(0.6, 0.999, (B, T, H, hd)),
        rng.standard_normal((B, T, H, hd))))
    u = torch.as_tensor(rng.standard_normal((H, hd)).astype(f) * .1).to(dev)
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        d = Path(tmp)
        for h in SRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "rwkv_chunk_bwd.cu").write_text(traced_source(tiles))
        out = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                              str(d / "lib.so"), str(d / "rwkv_chunk_bwd.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed on the traced copy:\n"
                               f"{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.k7b_trace_read.restype = ctypes.c_int
        lib.k7b_trace_read.argtypes = [ctypes.c_void_p]
        outs = k7_entry(lib)(r, k, v, w, u, gy, None, C)
        torch.cuda.synchronize()
        want = RC.rwkv_chunked_bthd_bwd(r, k, v, w, u, gy)
        errs = [rel(a, b) for a, b in zip(outs, want)]
        buf = np.zeros(tiles * NPT, np.uint64)
        if lib.k7b_trace_read(buf.ctypes.data):
            raise RuntimeError("k7b_trace_read failed")
    t = buf.reshape(tiles, NPT).astype(np.float64)
    n = len(TRACE_PHASES)
    dt = np.diff(t[:, :n + 1], axis=1)
    dl = np.diff(t[:, LAST:LAST + n + 1], axis=1)
    total = t[:, n] - t[:, 0]
    print(f"K7 bwd trace of the gradients kernel at rwkv6-3b's training "
          f"microbatch ({tiles} tiles; the traced copy against the "
          f"shipped kernel, each gradient within "
          f"{max(errs):.1e} of its largest magnitude): {total.mean():.0f} SM "
          f"cycles a tile (median {np.median(total):.0f}, max "
          f"{total.max():.0f}) on {name}", flush=True)
    print("  phase: thread 0's cycles (share), the last thread's", flush=True)
    for i, (what, _) in enumerate(TRACE_PHASES):
        print(f"  {what}: {dt[:, i].mean():.0f} "
              f"({dt[:, i].sum() / total.sum():.1%}), {dl[:, i].mean():.0f}",
              flush=True)
    g0, g1 = t[:, NPT - 3], t[:, NPT - 2]
    span = g1.max() - g0.min()
    print(f"  global span {span / 1e3:.1f} us; mean tiles in flight "
          f"{(g1 - g0).sum() / span:.1f}; SMs used "
          f"{len(np.unique(t[:, NPT - 1]))}; mean tile "
          f"{(g1 - g0).mean() / 1e3:.2f} us; tail (last start to end) "
          f"{(g1.max() - g0.max()) / 1e3:.1f} us", flush=True)


def train(arch, steps, mb, dev, name):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = get_config(arch)
    tc = TrainConfig(total_steps=steps, warmup_steps=1, microbatches=mb)
    shape = ShapeConfig("probe", 4096, 8, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, tc, 0, dev)
    step = make_train_step(cfg, tc)
    print(f"{arch}: state {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"after init", flush=True)
    for i in range(steps):
        batch = make_batch(cfg, shape, i, microbatches=mb, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        print(f"{arch} step {i}: {time.perf_counter() - t0:.3f} s, loss "
              f"{loss:.4f}, grad_norm {float(m['grad_norm']):.4f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
              f"{name}", flush=True)
    del state, step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", nargs="*", default=[])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--only-train", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--ab", type=Path, default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    name = card()
    print(f"card: {name}", flush=True)
    no_tf32()
    K.library()
    log = K.BUILD["log"]
    for src in ("ssm_scan_bwd.cu", "rwkv_chunk_bwd.cu"):
        sec = log[log.index(f"== {src}"):]
        print(re.split(r"\n== ", sec)[0], flush=True)
    if not args.only_train:
        k8_bwd(dev, name, args.ab)
        k7_bwd(dev, name, args.ab)
    if args.trace:
        k7_bwd_trace(dev, name)
    for arch in args.train:
        train(arch, args.steps, args.microbatches, dev, name)


if __name__ == "__main__":
    main()
