"""Where the tiled epoch kernels' time goes, by variants of their source
(needs one CUDA card).

    PYTHONPATH=src python3 scripts/epoch_probe.py [variant ...]

Builds variants of ``src/repro_torch/kernels/csrc/epoch_fused.cu`` (text
replacements, below) with the library's own flags, each from a copy of
the sources under ``build/epoch_probe/<variant>/`` and all at once, then
times each in turns (shipped first and last), one process per reading:
K4 at the Fig-15 grid's 40 rows of 64 x 40, K5 at the service's 8 rows
of 304 x 40 / 38, K3 at 304 x 40 (pc) and K4 on one row, each by
``scripts/devtime.py`` (device time per call, and the profiler's split
by kernel). Prints each variant's registers and spills
from ptxas, its times, and a checksum of every output: the variants
change no arithmetic, so the checksums must agree. The ``trace`` variant
stamps the SM clock at the phase boundaries of passes A and B and prints
one K4 call's mean cycles per phase and its CTAs on the global timer.
"""
from __future__ import annotations

import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/epoch_probe"

# the trace variant's stamps: thread 0 of each of the first NCTA CTAs of
# pass A and of pass B writes the SM clock (clock64) at each phase
# boundary and the global timer (ns) at its start and end
NCTA, NST = 320, 24
_WHO = ("if (threadIdx.x == 0 && blockIdx.x + gridDim.x * blockIdx.y < "
        f"{NCTA}) ")
_AT = f"epoch_trace[(blockIdx.x + gridDim.x * blockIdx.y) * {NST} + K]"
_CLK = _WHO + _AT + " = clock64();"
_GLB = (_WHO + "{ unsigned long long g; asm volatile(\"mov.u64 %0, "
        "%%globaltimer;\" : \"=l\"(g)); " + _AT + " = g; }")


def _trace(src: str) -> str:
    """Stamps in passes A (0 start, 1 program copies issued, 2 predicted,
    3 selected and the program in, 4 end; 5/6 global start/end) and B (8
    start, 9 staged, 10 scaled and the program in, 11 fork rows, 12 end;
    13/14 global start/end)."""
    def stamp(k):
        return _CLK.replace("+ K]", f"+ {k}]")

    def glb(k):
        return _GLB.replace("+ K]", f"+ {k}]")
    a0 = src.index("epoch_pass_a(const EpochArgs G) {")
    b0 = src.index("epoch_pass_b(const EpochArgs G) {")
    e0 = src.index("epoch_epilogue(const EpochArgs G) {")
    pa, pb = src[a0:b0], src[b0:e0]
    pa = pa.replace("  load_program(A, s);\n",
                    f"  {glb(5)}\n  {stamp(0)}\n  load_program(A, s);\n"
                    f"  {stamp(1)}\n", 1)
    pa = pa.replace("  predict<FAM>(A, s, mech);\n  __syncthreads();\n",
                    "  predict<FAM>(A, s, mech);\n  __syncthreads();\n"
                    f"  {stamp(2)}\n", 1)
    pa = pa.replace("  program_ready();\n  __syncthreads();\n",
                    "  program_ready();\n  __syncthreads();\n"
                    f"  {stamp(3)}\n", 1)
    pa = pa.replace("  traffic_partials(A, s, R.traf + c0, R.CU);\n",
                    "  traffic_partials(A, s, R.traf + c0, R.CU);\n"
                    f"  __syncthreads();\n  {stamp(4)}\n  {glb(6)}\n", 1)
    pb = pb.replace("  load_program(A, s);\n",
                    f"  {glb(13)}\n  {stamp(8)}\n  load_program(A, s);\n", 1)
    pb = pb.replace("    s.traf[i] = R.traf[i];\n  __syncthreads();\n",
                    "    s.traf[i] = R.traf[i];\n  __syncthreads();\n"
                    f"  {stamp(9)}\n", 1)
    pb = pb.replace("  traffic_scale(A, s, s.traf, R.CU, R.CU);\n"
                    "  program_ready();\n  __syncthreads();\n",
                    "  traffic_scale(A, s, s.traf, R.CU, R.CU);\n"
                    "  program_ready();\n"
                    f"  __syncthreads();\n  {stamp(10)}\n", 1)
    pb = pb.replace("  fork_rows(A, s);\n  __syncthreads();\n",
                    "  fork_rows(A, s);\n  __syncthreads();\n"
                    f"  {stamp(11)}\n", 1)
    pb = pb.replace("  select_rows<FAM>(A, s, mech);\n",
                    "  select_rows<FAM>(A, s, mech);\n  __syncthreads();\n"
                    f"  {stamp(12)}\n  {glb(14)}\n", 1)
    src = src[:a0] + pa + pb + src[e0:]
    # the epilogue's warp 0 in each CTA: 17 slots zeroed, 18 walk done,
    # 19 blended
    t0 = src.index("__device__ void table_slots(")
    t1 = src.index("// The row's table hit rate")
    ts = src[t0:t1]
    ts = ts.replace("  for (int e = lane; e < E; e += 32) ai[e] = as[e] = "
                    "ac[e] = 0.f;\n  __syncwarp();\n",
                    "  for (int e = lane; e < E; e += 32) ai[e] = as[e] = "
                    f"ac[e] = 0.f;\n  __syncwarp();\n  {stamp(17)}\n", 1)
    ts = ts.replace("  __syncwarp();\n  for (int e = lane; e < E; e += 32)\n"
                    "    ema_write(",
                    f"  __syncwarp();\n  {stamp(18)}\n"
                    "  for (int e = lane; e < E; e += 32)\n    ema_write(", 1)
    ts = ts.rstrip()
    assert ts.endswith("}")
    ts = ts[:-1] + f"  __syncwarp();\n  {stamp(19)}\n}}\n\n"
    src = src[:t0] + ts + src[t1:]
    src = src.replace("namespace {\n\nstruct Pw {",
                      "namespace {\n\n__device__ unsigned long long "
                      f"epoch_trace[{NCTA * NST}];\n\nstruct Pw {{", 1)
    return src + ("\nextern \"C\" int epoch_trace_read(void* dst) {\n"
                  "  return (int)cudaMemcpyFromSymbol(dst, epoch_trace, "
                  "sizeof(epoch_trace));\n}\n")


def _sub(old, new):
    def edit(src):
        assert src.count(old) == 1, old
        return src.replace(old, new)
    return edit


# variant -> edit of epoch_fused.cu's text
VARIANTS = {
    "shipped": lambda src: src,
    # 512 and 128 threads per CTA of passes A and B
    "t512": _sub("constexpr int kTileThreads = 256;",
                 "constexpr int kTileThreads = 512;"),
    "t128": _sub("constexpr int kTileThreads = 256;",
                 "constexpr int kTileThreads = 128;"),
    # the program loaded before predict, not while it runs
    "sync_program": _sub(
        'asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(\n'
        "                   (unsigned)__cvta_generic_to_shared(dst)),\n"
        '               "l"(src)\n'
        '               : "memory");', "*dst = *src;"),
    # narrower and wider CTAs
    "cta4": _sub("constexpr int kMaxCtaCu = 8;", "constexpr int kMaxCtaCu = 4;"),
    "cta16": _sub("constexpr int kMaxCtaCu = 8;",
                  "constexpr int kMaxCtaCu = 16;"),
    "trace": _trace,
}


def _variant_dir(name: str) -> Path:
    return OUT / name / "csrc"


def _prepare(name: str) -> None:
    d = _variant_dir(name)
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    src = VARIANTS[name]((d / "epoch_fused.cu").read_text())
    (d / "epoch_fused.cu").write_text(src)


def _use(name: str):
    from repro_torch import kernels as K
    K._CSRC = _variant_dir(name)
    K._BUILD_ROOT = OUT / name / "lib"
    return K


def build(name: str) -> int:
    _use(name).library()
    return 0


def measure(name: str) -> int:
    import torch

    import chip_smoke as CS
    import devtime as DT
    from repro_torch import no_tf32
    K = _use(name)
    from repro_torch.kernels import epoch_fused as KEF
    dev = torch.device("cuda", 0)
    no_tf32()
    K.library()
    log = K.BUILD["log"].splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and "epoch_" in line:
            regs = next((x for x in log[i + 1:i + 4] if "registers" in x), "")
            spill = log[i + 1].strip()
            print(f"  {line.split('for ')[-1].strip()}: "
                  f"{regs.split(':')[-1].strip()}; {spill}")
    ids40 = [CS.SIM.FORK_MECH_IDS[m] for m in ("crisp", "accreac", "pcstall",
                                               "accpc")]
    a40, k40 = CS.fork_rows_case([i for i in ids40 for _ in range(10)],
                                 CS.FIG15_WORKLOADS, 31, dev)
    a8, k8 = CS.fork_rows_case([0, 1, 2, 3, 4, 5, 6, 5],
                               list(CS.SVC_WORKLOADS), 25, dev,
                               lens=[1024, 768, 896, 512], cu=304, wf=40,
                               tables=304)
    a3, k3 = CS.epoch_case("pc", False, None, 13, dev, cu=304, tables=304)
    a1, k1 = CS.fork_rows_case([5], ["comd"], 32, dev)
    cases = {
        "K4 R=40": lambda: KEF.epoch_fused_rows(*a40, **k40),
        "K5 R=8": lambda: KEF.epoch_fused_rows(*a8, **k8, block_cu=38),
        "K3 pc 304": lambda: KEF.epoch_fused(*a3, **k3),
        "K4 R=1": lambda: KEF.epoch_fused_rows(*a1, **k1),
    }
    names = ("epoch_pass_a", "epoch_pass_b", "epoch_epilogue")
    for label, fn in cases.items():
        out = CS.out_fields(fn())
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            v.detach().cpu().contiguous().numpy().tobytes()
            for v in out.values())).hexdigest()[:12]
        ms = DT.device_ms(fn)
        means = DT.kernel_means(fn, names)
        print(f"{name} {label}: "
              + (f"{ms * 1e3:.2f} us per call" if ms is not None
                 else "refused") + " (" + ", ".join(
                  f"{n} {m * 1e3:.2f}" for n, (m, c) in means.items()
                  if m is not None) + f") outputs {digest}", flush=True)
        if name == "trace" and label == "K4 R=40":
            fn()
            torch.cuda.synchronize()
            trace_report(K.library().epoch_trace_read)
    return 0


def trace_report(read) -> None:
    """Mean SM cycles per phase over the traced CTAs of one K4 call, and
    each pass's CTAs on the global timer."""
    import ctypes

    import numpy as np
    read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p]
    buf = np.zeros(NCTA * NST, np.uint64)
    if read(buf.ctypes.data):
        raise RuntimeError("epoch_trace_read failed")
    t = buf.reshape(NCTA, NST).astype(np.float64)
    for label, ks, g in (("pass A", ("program copies", "predict",
                                     "select, program in", "partials"),
                          (0, 5)),
                         ("pass B", ("program copies, staging",
                                     "scale, program in", "fork rows",
                                     "selected rows"), (8, 13))):
        k0, g0 = g
        cyc = [t[:, k0 + i + 1] - t[:, k0 + i] for i in range(len(ks))]
        tot = t[:, k0 + len(ks)] - t[:, k0]
        gs, ge = t[:, g0], t[:, g0 + 1]
        print(f"  {label}: {tot.mean():.0f} SM cycles per CTA (max "
              f"{tot.max():.0f}); " + ", ".join(
                  f"{k} {c.mean():.0f}" for k, c in zip(ks, cyc))
              + f"; CTAs start over {(gs.max() - gs.min()) / 1e3:.2f} us, "
              f"run {((ge - gs).mean()) / 1e3:.2f} us each, span "
              f"{(ge.max() - gs.min()) / 1e3:.2f} us", flush=True)
    e = [t[:, 18] - t[:, 17], t[:, 19] - t[:, 18]]
    print("  epilogue (warp 0 of each CTA): " + ", ".join(
        f"{k} {c.mean():.0f}" for k, c in zip(("walk", "blend"), e))
        + " SM cycles", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in ("--build", "--measure"):
        fn = build if sys.argv[1] == "--build" else measure
        return fn(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("epoch_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    print("card:", CS.card_line(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    if "shipped" not in names:
        names = ["shipped"] + names
    for n in names:
        _prepare(n)
    builds = [subprocess.Popen([sys.executable, __file__, "--build", n])
              for n in names]
    if any(p.wait() for p in builds):
        return 1
    for n in names + ["shipped"]:
        print(f"== {n}", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--measure", n])
        if rc.returncode:
            return rc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
