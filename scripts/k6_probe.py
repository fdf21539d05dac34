"""Where the bf16 flash-attention kernel (K6) spends its time, measured by
taking parts of it away, and what rounding p to bf16 once would cost.

    PYTHONPATH=src python3 scripts/k6_probe.py

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``
with ``nvcc`` (the library's own flags) into a temporary directory under
``build/``, one shared library each, all compiled together, and times
each at the glm4-9b prefill (B 4, S 2048, 32 query heads over 2 KV heads of 128,
causal, bf16) with CUDA events, in turns (shipped, variants..., shipped),
on one CUDA card:

* ``shipped``: the source as it is;
* ``p_once``: p rounded to bf16 once (no p_lo term), as the reference's
  jnp ``_mha_block`` does: its time and its error against the plain
  version (the shipped kernel keeps p to 2^-17; this one to 2^-9);
* ``no_exp`` (p = s - m, no expf), ``no_pv`` (no p V products) and
  ``no_qk`` (no score products: s = 0) each take one part away and give
  wrong output; only their times are read;
* ``trace``: the shipped kernel with clock64 stamps at the phases of each
  key block (see ``VARIANTS["trace"]``), read back after one call.

Prints each variant's ms per call (the shipped kernel first and last),
its max abs error against ``flash_attention_bshd_ref`` where the output
is meant to be right, the trace's mean SM cycles per phase, and the
card's name and power limit.
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
from repro_torch.kernels import flash_attention as FA  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
B, S, H, HKV, HD = 4, 2048, 32, 2, 128

# variant -> (old, new) text replacements in flash_attention.cu
VARIANTS = {
    "shipped": [],
    "p_once": [("      wgmma_rs_n128<0>(acc, lo[kk], dv);\n", ""),
               ("      wgmma_rs_n64(acc, lo[kk], dv);\n", "")],
    "no_exp": [("expf(s[e] - ((e & 2) ? mn1 : mn0))",
                "(s[e] - ((e & 2) ? mn1 : mn0))")],
    "no_pv": [("      wgmma_rs_n128<0>(acc, hi[kk], dv);\n"
               "      wgmma_rs_n128<0>(acc, lo[kk], dv);\n", "")],
    "no_qk": [("    if (kk == 0)\n      wgmma_ss_n64_first(s, da, db);\n"
               "    else\n      wgmma_ss_n64_acc(s, da, db);\n",
               "    if (kk == 0)\n"
               "      for (int e = 0; e < 32; ++e) s[e] = 0.f;\n")],
}
RIGHT = ("shipped", "p_once", "trace")

# the trace variant: SM clock stamps (clock64) of the first wave's CTAs
# (the 128 longest query tiles, 16 key blocks each), thread 0 of each
# consumer warpgroup, in each key block: 5 its start, 0 its K ready, 1 its
# scores done, 2 its max and the rescale done, 3 sub-tile 0's p and split
# done, 4 both p V products done (sub-tile 1's p computed meanwhile); 6 Q
# arrived, 7 the consumer's start
NCTA, NBLK, NPT = 128, 16, 8
_STAMP = ("if ((threadIdx.x & 127) == 0 && blockIdx.x < {n} && {{jj}} < {b}) "
          "k6_trace[((blockIdx.x * 2 + g) * {b} + {{jj}}) * {p} + {{k}}] = "
          "clock64();").format(n=NCTA, b=NBLK, p=NPT)


def _stamp(k, jj="j"):
    return _STAMP.format(k=k, jj=jj)


VARIANTS["trace"] = [
    ("namespace tc {\n",
     "namespace tc {\n__device__ unsigned long long k6_trace["
     f"{NCTA * 2 * NBLK * NPT}];\n"),
    ("  mbar_wait(bar_q, 0);\n",
     "  " + _stamp(7, "0") + "\n  mbar_wait(bar_q, 0);\n  " + _stamp(6, "0")
     + "\n"),
    ("  for (int j = 0; j < jb1; ++j) {\n    if (keys_dead(",
     "  for (int j = 0; j < jb1; ++j) {\n    " + _stamp(5)
     + "\n    if (keys_dead("),
    ("    if (nsub == 1)\n",
     "    " + _stamp(0) + "\n    if (nsub == 1)\n"),
    ("    if constexpr (N == 2) fence_regs(s1);\n",
     "    if constexpr (N == 2) fence_regs(s1);\n    " + _stamp(1) + "\n"),
    ("    rescale(acc, m0, m1, l0, l1, mb0, mb1);\n    float ls0 = 0.f, "
     "ls1 = 0.f;\n    exponentiate(s0, t0",
     "    rescale(acc, m0, m1, l0, l1, mb0, mb1);\n    " + _stamp(2)
     + "\n    float ls0 = 0.f, ls1 = 0.f;\n    exponentiate(s0, t0"),
    ("      split_p(s0, hi0, lo0);\n"
     "      mbar_wait(full_v + 8 * (c % kStages), parity(c));\n",
     "      split_p(s0, hi0, lo0);\n      " + _stamp(3) + "\n"
     "      mbar_wait(full_v + 8 * (c % kStages), parity(c));\n"),
    ("    wgmma_wait<0>();\n    fence_regs(acc);\n#pragma unroll\n"
     "    for (int i = 0; i < N; ++i) release(empty_v, c + i);\n",
     "    wgmma_wait<0>();\n    fence_regs(acc);\n    " + _stamp(4)
     + "\n#pragma unroll\n"
     "    for (int i = 0; i < N; ++i) release(empty_v, c + i);\n"),
    ("extern \"C\" int flash_attention_launch(",
     "extern \"C\" int k6_trace_read(void* dst) {\n  return (int)"
     "cudaMemcpyFromSymbol(dst, tc::k6_trace, sizeof(tc::k6_trace));\n}\n\n"
     "extern \"C\" int flash_attention_launch("),
]


def build(tmp: Path) -> dict:
    src = (CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "flash_attention.cu").write_text(text)
        for h in ("common.cuh", "attention_mask.cuh", "hopper.cuh"):
            (d / h).write_text((CSRC / h).read_text())
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        fn = lib.flash_attention_launch
        fn.restype, fn.argtypes = K.SIGNATURES["flash_attention_launch"]
        libs[name] = fn
        if name == "trace":
            libs["trace_read"] = lib.k6_trace_read
            lib.k6_trace_read.restype = ctypes.c_int
            lib.k6_trace_read.argtypes = [ctypes.c_void_p]
    return libs


def trace_report(read) -> None:
    """Mean SM cycles per phase of a key block over the first wave's CTAs,
    and how far apart the two warpgroups run."""
    buf = np.zeros(NCTA * 2 * NBLK * NPT, np.uint64)
    if read(buf.ctypes.data):
        raise RuntimeError("k6_trace_read failed")
    t = buf.reshape(NCTA, 2, NBLK, NPT).astype(np.float64)
    start = t[:, :, 0, 7]
    prev_end = np.concatenate([t[:, :, :1, 6], t[:, :, :-1, 4]], axis=2)
    phases = {
        "releases, loop": t[..., 5] - prev_end,
        "wait for K": t[..., 0] - t[..., 5],
        "scores (wgmma)": t[..., 1] - t[..., 0],
        "block max, rescale": t[..., 2] - t[..., 1],
        "p and split, sub-tile 0": t[..., 3] - t[..., 2],
        "p V (sub-tile 1's p and split meanwhile)": t[..., 4] - t[..., 3],
    }
    total = t[:, :, -1, 4] - start
    print(f"k6_probe trace: first wave ({NCTA} CTAs x 2 warpgroups x "
          f"{NBLK} key blocks): {total.mean():.0f} SM cycles per "
          f"warpgroup, Q wait {(t[:, :, 0, 6] - start).mean():.0f}")
    for name, d in phases.items():
        print(f"  {name}: {d.mean():.0f} cycles per block "
              f"({d.sum() / total.sum():.1%})")
    lag = np.abs(t[:, 0, :, 1] - t[:, 1, :, 1])
    print(f"  |WG0 - WG1| at scores done: mean {lag.mean():.0f}, median "
          f"{np.median(lag):.0f} cycles")


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(41)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               .to(dev, torch.bfloat16)
               for s in ((B, S, H, HD), (B, S, HKV, HD), (B, S, HKV, HD)))
    want = FA.flash_attention_bshd_ref(q, k, v).float()
    stream = torch.cuda.current_stream().cuda_stream
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build(Path(tmp))

        def run(name):
            out = torch.empty_like(q)
            code = libs[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), None, B, S, H, HKV, HD, 128,
                              1, 0, 0, 1, stream)
            if code:
                raise RuntimeError(f"{name}: cuda error {code}")
            return out

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
            line = (f"k6_probe {name}: "
                    + " / ".join(f"{t:.4f}" for t in times[name])
                    + " ms per call")
            if name in RIGHT:
                got = run(name).float()
                err = (got - want).abs()
                worst = float((err / (1e-5 + 2.0 ** -7 * want.abs())).max())
                line += (f", max abs err {float(err.max()):.3e} (worst "
                         f"err / one-ulp limit {worst:.3f})")
            print(line + f" on {card}", flush=True)
        run("trace")
        torch.cuda.synchronize()
        trace_report(libs["trace_read"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
