"""Why torch.profiler loses kernel records, against the events method
(needs one CUDA card).

    PYTHONPATH=src python3 scripts/timing_probe.py [--stress N]

For K6 in f32 and bf16 at the glm4-9b prefill, K4 at the Fig-15 grid's
40 rows and K1 at the main path's layout, three readings of the device
time per call:

* ``profiler``: the mean duration over the kernel records of one
  torch.profiler session (CPU and CUDA activity) of the calls;
* ``cuda only``: the same with CUDA activity alone;
* ``events``: ``scripts/devtime.py`` (CUDA events around the calls queued
  behind a spin kernel): everything a call launches.

Each profiler reading prints how many kernel records it kept against the
launches made, and how many ``cudaLaunchKernel`` runtime records. With
``--stress N`` one session first traces N small kernels, as a profile of a
whole prefill does; the readings after it show what that does to the
records of every later session.

With ``--sessions N`` it does only this, from the process's first
session on: N torch.profiler sessions of four K1 calls each at the main
path's layout (``devtime.session_counts``), each session's device
records beside the launching runtime calls it recorded, then what
``devtime.kernel_counts`` returns for four calls:

    PYTHONPATH=src python3 scripts/timing_probe.py --sessions 200
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as CS  # noqa: E402
import devtime as DT  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.core import power as PWR  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import pc_table as KPT  # noqa: E402


def profiled(fn, name, reps, cpu=True):
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count, launches = 0.0, 0, 0
    for ev in prof.key_averages():
        if name in ev.key and ev.count:
            t = getattr(ev, "device_time_total", None)
            total += getattr(ev, "cuda_time_total", 0.0) if t is None else t
            count += ev.count
        if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += ev.count
    return total / max(count, 1) / 1e3, count, launches


def sessions(dev, n: int) -> int:
    """``--sessions N`` (see the module docstring)."""
    tbl, tid, idx, fb = CS.table_case(7, dev)
    idx = idx.long()
    F = PWR.freqs_ghz(PWR.DEFAULT, CS.NF, device=dev)

    def k1():
        return KPT.pc_table_predict(*tbl, tid, idx, *fb, F,
                                    epoch_us=1.0, cap_per_ghz=5500.0,
                                    return_hit=True)

    short = []
    for i in range(n):
        ran, launched = DT.session_counts(k1, 4)
        kept = sum(ran.values())
        if kept != 4 or launched != 4 or len(ran) != 1:
            short.append(i)
        print(f"session {i}: {kept} device records, {launched} launching "
              f"runtime calls, {len(ran)} names", flush=True)
    print(f"{len(short)} of {n} sessions kept other than 4 records of one "
          f"kernel and 4 launching calls: {short}", flush=True)
    print(f"kernel_counts over four calls: {DT.kernel_counts(k1, 4)}",
          flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("timing_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    no_tf32()
    print("card:", CS.card_line(), flush=True)
    if "--sessions" in sys.argv:
        return sessions(dev, int(sys.argv[sys.argv.index("--sessions") + 1]))
    k6, _ = CS.lm_cases(dev)
    qf, kf, vf = k6[torch.float32]
    qb, kb, vb = k6[torch.bfloat16]
    ids40 = [SIM.FORK_MECH_IDS[m] for m in ("crisp", "accreac", "pcstall",
                                            "accpc")]
    a40, kw40 = CS.fork_rows_case([i for i in ids40 for _ in range(10)],
                                  CS.FIG15_WORKLOADS, 31, dev)
    tbl, tid, idx, fb = CS.table_case(7, dev)
    F = PWR.freqs_ghz(PWR.DEFAULT, CS.NF, device=dev)
    cases = [
        ("K6 f32", lambda: FA.flash_attention_bshd(qf, kf, vf, causal=True),
         "flash_attention_kernel<", 10),
        ("K6 bf16", lambda: FA.flash_attention_bshd(qb, kb, vb, causal=True),
         "flash_attention_kernel_wgmma", 20),
        ("K4 R=40", lambda: KEF.epoch_fused_rows(*a40, **kw40),
         "epoch_pass_b", 100),
        ("K1", lambda: KPT.pc_table_predict(*tbl, tid, idx, *fb, F,
                                            epoch_us=1.0, cap_per_ghz=5500.0),
         "pc_table_predict_kernel", 100),
    ]
    if "--stress" in sys.argv:
        n = int(sys.argv[sys.argv.index("--stress") + 1])
        x = torch.zeros(1024, device=dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                x.add_(1.0)
            torch.cuda.synchronize()
        kept = sum(1 for ev in prof.events()
                   if "cuda" in str(ev.device_type).lower())
        print(f"stress trace: {kept} device records of {n} launches",
              flush=True)
    for label, fn, name, reps in cases:
        for variant, cpu in (("profiler", True), ("cuda only", False)):
            ms, count, launches = profiled(fn, name, reps, cpu)
            print(f"{label} [{variant}]: {ms * 1e3:.2f} us per launch over "
                  f"{count} kernel records of {reps} launches "
                  f"(cudaLaunchKernel records {launches})", flush=True)
        ms = DT.device_ms(fn, reps)
        print(f"{label} [events]: "
              + (f"{ms * 1e3:.2f} us per call" if ms is not None
                 else "refused (the host outlasted the spin)"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
