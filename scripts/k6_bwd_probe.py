"""K6's backward kernel on one CUDA card (``csrc/flash_attention_bwd.cu``).

    PYTHONPATH=src python3 scripts/k6_bwd_probe.py [--quick] [--variants]

Prints nvcc's report for the backward's kernels (registers, spills,
shared memory per instance), then at each layout below, from numpy-seeded
inputs in f32 and in bf16: K6's log-sum-exp against its plain version's,
the kernel's dq, dk and dv against the plain backward
(``flash_attention_bshd_bwd_ref``) on the same inputs and log-sum-exp and
against autograd through K6's plain forward in f32 (each over the
gradient's largest magnitude), and two calls bit for bit. At
musicgen-medium's training layout it times the kernel by
``scripts/devtime.py``, beside its bound (``roofline/work.py``), the plain
version (events) and the library's backward (autograd of
``scaled_dot_product_attention``, events), and splits a call by kernel
(the pre-pass, dk/dv, dq; torch.profiler). ``--quick`` keeps the small
layouts and musicgen's bf16 one, and times nothing but the kernel.
``--variants`` also rebuilds ``flash_attention_bwd.cu`` with other
pipeline choices (``VARIANTS``: text edits of the source, each built
alone with nvcc) and times each against this tree's at musicgen's and
hymba's training layouts and at head dim 128 in turns (forward order,
then reversed), every variant's gradients bit for bit this tree's, with
nvcc's registers and spills for the ``wgmma`` instances.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import devtime as DT  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.roofline import work as W  # noqa: E402

# (name, B, S, H, Hkv, hd, window, prefix): the card tests' four, odd
# ones (S not a multiple of a tile, non-causal), and the training layouts
SMALL = [("one block", 1, 128, 4, 2, 16, 0, 0),
         ("hd 256 prefix = S", 2, 256, 2, 1, 256, 0, 256),
         ("window GQA 4", 1, 512, 4, 1, 64, 100, 0),
         ("prefix 40", 1, 384, 4, 2, 16, 0, 40),
         ("S 100 hd 96", 2, 100, 3, 1, 96, 0, 0),
         ("S 200 hd 128 window", 1, 200, 4, 2, 128, 37, 0),
         ("S 96 hd 32 prefix", 1, 96, 2, 2, 32, 0, 9)]
TRAIN = [("musicgen-medium", 4, 4096, 24, 24, 64, 0, 0),
         ("paligemma-3b", 1, 2048, 8, 1, 256, 0, 256),
         ("hymba-1.5b", 1, 2048, 25, 5, 64, 1024, 0)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# pipeline choices of the bf16 wgmma kernels (head dims 16-128), as edits
# of flash_attention_bwd.cu's tile constants
_SUBKV = "static constexpr int kSubKV = NP == 1 ? 128 : 64;"
_SUBQ = "static constexpr int kSubQ = HD == 64 ? 128 : 64;"
_STAGES = "static constexpr int kStages = 4;"
_FMA = "static constexpr bool kFma = NP == 1;"
VARIANTS = {
    "this tree": [],
    "dk/dv: 64-row query tiles": [(_SUBKV, "static constexpr int kSubKV = "
                                           "64;")],
    "dq: 64-key sub-tiles": [(_SUBQ, "static constexpr int kSubQ = 64;")],
    "rings of 2 stages": [(_STAGES, "static constexpr int kStages = 2;")],
    "the exponent's argument by a multiply and a subtract":
        [(_FMA, "static constexpr bool kFma = false;")],
    "the exponent's argument by one fused multiply-add at every head dim":
        [(_FMA, "static constexpr bool kFma = true;")],
}
# (B, S, H, Hkv, hd, window) the variants are timed at: musicgen-medium's
# and hymba-1.5b's training layouts, and glm4-9b's heads at head dim 128
VARIANT_LAYOUTS = [(4, 4096, 24, 24, 64, 0), (4, 4096, 25, 5, 64, 1024),
                   (1, 4096, 32, 2, 128, 0)]
# the backward's three kernels, by the names the profiler reports
KERNELS = ("flash_attention_bwd_dot", "flash_attention_bwd_dkdv_wgmma",
           "flash_attention_bwd_dq_wgmma")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def report() -> None:
    """nvcc's lines for the backward's kernels."""
    keep = False
    for line in K.BUILD["log"].splitlines():
        if "Function properties for" in line:
            keep = "flash_attention_bwd" in line
        if keep and ("Function properties" in line or "registers" in line
                     or "spill" in line):
            print("  " + line.strip())


def case(dev, dt, B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(
        dev, dt) for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                           (B, S, H, hd))]


def layout(dev, name, B, S, H, Hkv, hd, w, pre, dt, autograd, fails):
    causal = not name.startswith("noncausal")
    # K6's key block: 128, or one that divides S (the backward has none)
    blk = 128 if S % 128 == 0 else S if S < 128 else math.gcd(S, 128)
    kw = dict(causal=causal, window=w, prefix_len=pre)
    q, k, v, do = case(dev, dt, B, S, H, Hkv, hd, S + H + hd)
    out, lse = FA.flash_attention_bshd(q, k, v, blk_k=blk, return_lse=True,
                                       **kw)
    _, lse_ref = FA.flash_attention_bshd_ref(q, k, v, blk_k=blk,
                                             return_lse=True, **kw)
    n = FA.flash_attention_bshd_bwd.launches
    got = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse, **kw)
    again = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = FA.flash_attention_bshd_bwd_ref(q, k, v, out, do, lse, **kw)
    errs = [rel(a, b) for a, b in zip(got, want)]
    lerr = rel(lse, lse_ref)
    line = (f"{name} (B {B} S {S} H {H} Hkv {Hkv} hd {hd} window {w} "
            f"prefix {pre}, {str(dt).split('.')[-1]}): lse {lerr:.2e}; "
            f"against the plain backward dq {errs[0]:.2e} dk "
            f"{errs[1]:.2e} dv {errs[2]:.2e}; bit for bit twice {same}; "
            f"launches {FA.flash_attention_bshd_bwd.launches - n}")
    ok = same and max(errs) < TOL[dt] and lerr < 1e-5
    if autograd:
        ins = [t.float().requires_grad_() for t in (q, k, v)]
        ag = torch.autograd.grad(FA.flash_attention_bshd_ref(
            *ins, blk_k=blk, **kw), ins, do.float())
        aerr = [rel(a, b) for a, b in zip(got, ag)]
        line += (f"; against autograd in f32 dq {aerr[0]:.2e} dk "
                 f"{aerr[1]:.2e} dv {aerr[2]:.2e}")
        ok = ok and max(aerr) < TOL[dt]
        del ins, ag
    print(("PASS " if ok else "FAIL ") + line, flush=True)
    if not ok:
        fails.append(name)
    return q, k, v, out, do, lse, got


def timing(dev, q, k, v, out, do, lse, got, full) -> None:
    B, S, H, hd = q.shape
    kern = DT.device_ms(lambda: FA.flash_attention_bshd_bwd(
        q, k, v, out, do, lse), 20)
    ops = W.attention_bwd_flops(B, S, H, hd)
    nb = W.nbytes(q, k, v, out, do, lse, *got)
    bound, by = W.bound_ms(nb, ops, W.PEAK_FLOPS_BF16)
    split = DT.kernel_means(lambda: FA.flash_attention_bshd_bwd(
        q, k, v, out, do, lse), KERNELS, reps=20)
    line = (f"time K6 backward kernel at musicgen-medium's training layout "
            f"(bf16): device {kern:.4f} ms per call (devtime), bound "
            f"{bound:.4f} ms ({by}; {ops / 1e9:.1f} GFLOP, {nb / 1e9:.3f} GB)"
            f", {kern / bound:.2f}x; by kernel (profiler, ms a launch and "
            f"records kept) " + ", ".join(
                f"{n} {'-' if t is None else f'{t:.4f}'} ({c})"
                for n, (t, c) in split.items()))
    if full:
        plain = DT.events_ms(lambda: FA.flash_attention_bshd_bwd_ref(
            q, k, v, out, do, lse), reps=2, warm=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lo = sdpa(ql, kl, vl, is_causal=True)
        lib = DT.events_ms(lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do.transpose(1, 2), retain_graph=True),
            reps=20, warm=3)
        line += (f"; plain version {plain:.2f} ms (events); library "
                 f"backward {lib:.4f} ms (events), ours {kern / lib:.2f}x")
    print(line + f" on {card()}", flush=True)


def build_variants(tmp: Path) -> dict:
    """{name: (the variant's C entry point, nvcc's report)}: each variant
    of flash_attention_bwd.cu built alone into its own library."""
    csrc = Path(K.__file__).resolve().parent / "csrc"
    src = (csrc / "flash_attention_bwd.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once")
            text = text.replace(old, new)
        d = tmp / str(i)
        d.mkdir()
        (d / "flash_attention_bwd.cu").write_text(text)
        for h in ("common.cuh", "attention_mask.cuh", "hopper.cuh"):
            (d / h).write_text((csrc / h).read_text())
        procs[name] = (d, subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(d / "lib.so")).flash_attention_bwd_launch
        fn.restype, fn.argtypes = K.SIGNATURES["flash_attention_bwd_launch"]
        out[name] = (fn, log)
    return out


def variants(dev) -> None:
    """Time each of ``VARIANTS`` against this tree's kernels in turns."""
    with tempfile.TemporaryDirectory(dir=Path(K._BUILD_ROOT).parent) as tmp:
        libs = build_variants(Path(tmp))
        for name, (_, log) in libs.items():
            lines = log.splitlines()
            regs = [f"{'dk/dv' if 'dkdv' in ln else 'dq'} hd "
                    f"{re.search(r'wgmmaILi(\d+)E', ln).group(1)} "
                    f"{lines[i + 2].split(':')[-1].strip()}, "
                    f"{lines[i + 1].strip()}"
                    for i, ln in enumerate(lines)
                    if "Function properties" in ln and "_wgmmaILi" in ln]
            print(f"  {name}: {'; '.join(regs)}", flush=True)
        for B, S, H, Hkv, hd, w in VARIANT_LAYOUTS:
            q, k, v, do = case(dev, torch.bfloat16, B, S, H, Hkv, hd, 3)
            out, lse = FA.flash_attention_bshd(q, k, v, window=w,
                                               return_lse=True)
            st = torch.cuda.current_stream().cuda_stream
            D = torch.empty((B, H, S), device=dev)
            grads = [torch.empty_like(t) for t in (q, k, v)]

            def call(fn):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          D.data_ptr(), *(g.data_ptr() for g in grads), B, S,
                          H, Hkv, hd, 1, w, 0, 1, st)
                if code:
                    raise RuntimeError(f"cuda error {code}")
            call(libs["this tree"][0])
            base = [g.clone() for g in grads]
            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    fn = libs[name][0]
                    times[name].append(DT.device_ms(lambda: call(fn), 20))
            print(f"variants at B {B} S {S} H {H} Hkv {Hkv} hd {hd} window "
                  f"{w} (bf16, devtime, two turns) on {card()}:", flush=True)
            for name, ts in times.items():
                call(libs[name][0])
                same = all(torch.equal(a, b) for a, b in zip(grads, base))
                print(f"  {name}: " + " / ".join(f"{t:.4f}" for t in ts)
                      + f" ms; bit for bit this tree's: {same}", flush=True)
            del q, k, v, do, out, lse, D, grads, base
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    no_tf32()
    print(f"card: {card()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    K.library()
    print(f"nvcc build {K.BUILD['seconds']:.1f} s; the backward's kernels:")
    report()
    fails = []
    for name, *shape in SMALL + [("noncausal", 1, 192, 2, 1, 64, 0, 0)]:
        for dt in (torch.float32, torch.bfloat16):
            layout(dev, name, *shape, dt, True, fails)
    for name, *shape in TRAIN:
        for dt in (torch.bfloat16,) if args.quick else (torch.bfloat16,
                                                         torch.float32):
            if args.quick and name != "musicgen-medium":
                continue
            res = layout(dev, name, *shape, dt, False, fails)
            if name == "musicgen-medium" and dt == torch.bfloat16:
                timing(dev, *res, full=not args.quick)
            del res
            torch.cuda.empty_cache()
    if args.variants:
        print("pipeline variants of flash_attention_bwd.cu (nvcc: registers "
              "and spills of the wgmma instances):", flush=True)
        variants(dev)
    print(f"k6_bwd_probe: {len(fails)} layout(s) failed {fails}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
