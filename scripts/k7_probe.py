"""Where the chunked RWKV6 WKV kernel (K7) spends its time, measured by
taking parts of it away, and a clock64 trace of its phases.

    PYTHONPATH=src python3 scripts/k7_probe.py

Builds variants of ``src/repro_torch/kernels/csrc/rwkv_chunk.cu`` with
``nvcc`` (the library's own flags) into a temporary directory under
``build/``, one shared library each, all compiled together, and times
each at the rwkv6-3b prefill (B 4, T 2048, H 40 heads of 64, chunk 128,
f32) with CUDA events, in turns (shipped, variants..., shipped), on one
CUDA card:

* ``shipped``: the source as it is;
* ``no_load`` (no copies in: the tiles compute on what shared memory
  holds), ``no_logexp`` (the prefix without logf and expf),
  ``no_products`` (neither A nor kT^T v), ``no_y`` (neither A v nor
  rP S) and ``no_chain`` (no poll of the predecessor's flag: a tile reads
  whatever state is there) each take one part away and give wrong
  output; only their times are read;
* ``split_cvt`` splits the products' operands by ``cvt.rna.tf32.f32``
  (the same rounding; its time and error), ``split_none`` not at all
  (the products' time without the split; wrong output), ``split_trunc``
  with hi cut instead of rounded (its time and error);
* ``trace``: the shipped kernel with stamps at its phases (thread 0 of
  every tile, SM clock and global timer), read back after one call.

Prints each variant's ms per call (the shipped kernel first and last),
the shipped and traced kernels' max abs error against
``rwkv_chunked_bthd_ref``, the trace's mean SM cycles per phase, how many
tiles found their predecessor's state unpublished, how many tiles were
resident on average and the tail, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import rwkv_chunk as RC  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
B, T, H, HD, CH = 4, 2048, 40, 64, 128
TILES = B * H * (T // CH)

_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;\n")
# variant -> (old, new) text replacements in rwkv_chunk.cu
VARIANTS = {
    "shipped": [],
    "no_load": [("    if (t < C)\n      cp16(dst, src);\n    else\n",
                 "    if (t >= C)\n")],
    "no_logexp": [("logf(fmaxf(*wp, 1e-38f))", "(*wp)"),
                  ("expf(cum - lw[i])", "(cum - lw[i])"),
                  ("expf(-cum)", "(-cum)"), ("expf(tot - cum)", "(tot - cum)")],
    "no_products": [
        ("        if (job < NDS)\n          warp_mma<NT, false, false>(ds[m], "
         "sW + (job / DSC) * 16, l4,\n", "        if (false)\n"
         "          warp_mma<NT, false, false>(ds[m], sW + (job / DSC) * 16, "
         "l4,\n"),
        ("        warp_mma<4, true, true>(acc, sR + i * 16 * l8, l8, "
         "sK + j * 32 * l8,\n                                l8, HD, i % 2 || "
         "j < i / 2 ? 4 : 2);\n", "")],
    "no_y": [
        ("          warp_mma<NT, true, false>(acc, sA + r0 * lda, lda, "
         "sV + e0, l4,\n                                    r0 + 16);\n", ""),
        ("          if (c > 0)\n            warp_mma<NT, true, false>",
         "          if (false)\n            warp_mma<NT, true, false>")],
    "no_chain": [("if (tid == 0 && c > 0) ready = load_acquire(work + 1 + bh) "
                  ">= c * NDS;", "")],
    # the split by cvt.rna.tf32.f32 (the same rounding), and no split at
    # all (hi = lo = x: wrong output, the products' time without it)
    "split_cvt": [(_SPLIT,
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : "
                   "\"f\"(x));\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : "
                   "\"=r\"(lo) : \"f\"(x - __uint_as_float(hi)));\n")],
    "split_none": [(_SPLIT, "  hi = lo = __float_as_uint(x);\n")],
    "split_trunc": [(_SPLIT, "  hi = __float_as_uint(x) & 0xffffe000u;\n"
                     "  lo = __float_as_uint(x - __uint_as_float(hi)) & "
                     "0xffffe000u;\n")],
}
RIGHT = ("shipped", "trace", "split_cvt", "split_trunc")

# the trace: per tile (indexed by its ticket), thread 0's SM clock at 0 the
# tile's start in its CTA's loop, 1 w and k in (copied during the tile
# before), 2 the prefix of logw done and r in, 3 diag done, 4 rP, kD, kT
# done and v in, 5 A and kT^T v done, 6 S_{c-1} in shared memory, 7 S_c
# published, 8 y written (the loop's barrier); 9 and 10 the global timer
# (ns) at the start and the end, 11 the SM id, 12 whether S_{c-1} was
# published before the products began
NPT = 13
_T = ("if (threadIdx.x == 0) k7_trace[(size_t)tk * {n} + {{k}}] = "
      "clock64();").format(n=NPT)


def _at(k):
    return _T.format(k=k)


VARIANTS["trace"] = [
    ("namespace {\n",
     f"namespace {{\n__device__ unsigned long long k7_trace[{TILES * NPT}];"
     "\n__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  while (ticket < tiles) {\n",
     "  while (ticket < tiles) {\n    const int tk = ticket;\n"
     "    if (tid == 0) { unsigned sm; asm(\"mov.u32 %0, %%smid;\" : "
     f"\"=r\"(sm)); k7_trace[(size_t)tk * {NPT} + 9] = gtime(); "
     f"k7_trace[(size_t)tk * {NPT} + 11] = sm; }}\n    " + _at(0) + "\n"),
    ("    cp_wait<2>();\n    __syncthreads();\n",
     "    cp_wait<2>();\n    __syncthreads();\n    " + _at(1) + "\n"),
    ("    cp_wait<1>();\n    __syncthreads();\n",
     "    cp_wait<1>();\n    __syncthreads();\n    " + _at(2) + "\n"),
    ("      if (part == 0 && t < Cp) sDiag[t] = a;\n    }\n"
     "    __syncthreads();\n",
     "      if (part == 0 && t < Cp) sDiag[t] = a;\n    }\n"
     "    __syncthreads();\n    " + _at(3) + "\n"),
    ("    const bool early = sFlag[1] != 0;\n",
     "    const bool early = sFlag[1] != 0;\n    " + _at(4)
     + f"\n    if (tid == 0) k7_trace[(size_t)tk * {NPT} + 12] = early;\n"),
    ("    cp_wait<0>();\n    __syncthreads();\n\n    // the chain",
     "    cp_wait<0>();\n    __syncthreads();\n    " + _at(5)
     + "\n\n    // the chain"),
    ("      cp_wait<0>();\n      __syncthreads();\n    }\n",
     "      cp_wait<0>();\n      __syncthreads();\n    }\n    " + _at(6)
     + "\n"),
    ("    next = sFlag[0];\n",
     "    " + _at(7) + "\n    next = sFlag[0];\n"),
    ("    ticket = next;\n    __syncthreads();\n",
     "    ticket = next;\n    __syncthreads();\n    " + _at(8)
     + f"\n    if (tid == 0) k7_trace[(size_t)tk * {NPT} + 10] = gtime();\n"),
    ("extern \"C\" int rwkv_chunk_launch(",
     "extern \"C\" int k7_trace_read(void* dst) {\n  return (int)"
     "cudaMemcpyFromSymbol(dst, k7_trace, sizeof(k7_trace));\n}\n\n"
     "extern \"C\" int rwkv_chunk_launch("),
]


def build(tmp: Path) -> dict:
    src = (CSRC / "rwkv_chunk.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once: "
                                   f"{old!r}")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "rwkv_chunk.cu").write_text(text)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "rwkv_chunk.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        fn = lib.rwkv_chunk_launch
        fn.restype, fn.argtypes = K.SIGNATURES["rwkv_chunk_launch"]
        libs[name] = fn
        if name == "trace":
            libs["trace_read"] = lib.k7_trace_read
            lib.k7_trace_read.restype = ctypes.c_int
            lib.k7_trace_read.argtypes = [ctypes.c_void_p]
    return libs


def trace_report(read) -> None:
    """Mean SM cycles per phase over the tiles, the chain's waits, the
    tiles resident at once and the tail."""
    buf = np.zeros(TILES * NPT, np.uint64)
    if read(buf.ctypes.data):
        raise RuntimeError("k7_trace_read failed")
    t = buf.reshape(TILES, NPT).astype(np.float64)
    names = ("w and k in", "the prefix of logw, r in", "diag",
             "offsets, rP kD kT, v in", "A and kT^T v",
             "S_{c-1} in (the late path: wait and copy)", "publish S_c",
             "y")
    d = np.diff(t[:, :9], axis=1)
    total = t[:, 8] - t[:, 0]
    print(f"k7_probe trace: {TILES} tiles, {total.mean():.0f} SM cycles per "
          f"tile (median {np.median(total):.0f}, max {total.max():.0f})")
    for i, n in enumerate(names):
        share = d[:, i].sum() / total.sum()
        print(f"  {n}: {d[:, i].mean():.0f} cycles ({share:.1%})")
    late = t[:, 12] == 0
    print(f"  tiles that found S_(c-1) unpublished before their products: "
          f"{int(late.sum())} of {TILES} (chunk 0 never waits); their "
          f"wait and copy {d[late, 5].mean() if late.any() else 0:.0f} "
          f"cycles")
    g0, g1 = t[:, 9], t[:, 10]
    span = g1.max() - g0.min()
    print(f"  global span {span / 1e3:.1f} us; mean tiles resident "
          f"{(g1 - g0).sum() / span:.1f}; SMs used "
          f"{len(np.unique(t[:, 11]))}; tail (last start to end) "
          f"{(g1.max() - g0.max()) / 1e3:.1f} us; first tile "
          f"{(g1[0] - g0[0]) / 1e3:.1f} us, mean tile "
          f"{(g1 - g0).mean() / 1e3:.1f} us")


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(42)
    ins = [rng.standard_normal((B, T, H, HD)).astype(np.float32) * 0.5
           for _ in range(3)]
    ins.append(rng.uniform(0.6, 0.999, (B, T, H, HD)).astype(np.float32))
    ins.append(rng.standard_normal((H, HD)).astype(np.float32) * 0.1)
    r, k, v, w, u = (torch.as_tensor(a).to(dev) for a in ins)
    want = RC.rwkv_chunked_bthd_ref(r, k, v, w, u, chunk=CH)
    stream = torch.cuda.current_stream().cuda_stream
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build(Path(tmp))
        y = torch.empty_like(r)
        S = torch.empty((B, H, HD, HD), dtype=torch.float32, device=dev)
        work = torch.empty(1 + B * H, dtype=torch.int32, device=dev)

        def run(name):
            code = libs[name](r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), y.data_ptr(),
                              S.data_ptr(), work.data_ptr(), B, T, H, HD,
                              CH, 0, HD, stream)
            if code:
                raise RuntimeError(f"{name}: cuda error {code}")
            return y

        def ms(name, reps=50):
            for _ in range(5):
                run(name)
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(reps):
                run(name)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / reps

        order = list(VARIANTS) + ["shipped"]
        times = {}
        for name in order:
            times.setdefault(name, []).append(ms(name))
        for name in VARIANTS:
            line = (f"k7_probe {name}: "
                    + " / ".join(f"{t:.4f}" for t in times[name])
                    + " ms per call")
            if name in RIGHT:
                err = float((run(name) - want).abs().max())
                line += f", max abs err {err:.3e}"
            print(line + f" on {card}", flush=True)
        run("trace")
        torch.cuda.synchronize()
        trace_report(libs["trace_read"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
