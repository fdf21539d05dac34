"""Host-wall times of the port's epoch engines and of the Fig-15 grid by
mechanism family, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/time_sweep.py --label change [--grid]

Uses whichever ``repro_torch`` is first on ``PYTHONPATH``, so the same
script times two checkouts in turns (``PYTHONPATH=<other>/src``). Prints
the card's name and power limit, then:

* ``engine``: ms per epoch of ``run_sim`` (pcstall on ``comd``, 64 CUs x
  40 WFs), kernel engine and unfused engine, each over 100 epochs after a
  warm-up run, host wall ending in a synchronise;
* with ``--grid`` (needs ``repro_torch.core.sweep``): the paper's Fig-15
  grid (ten workloads, 800 epochs, ``{"epoch_us": [1.0]}``) split into its
  dispatch families -- the four traced mechanisms (one fork-family
  dispatch), the three statics, the oracle -- each timed alone on the
  kernel engine and on the unfused engine, and the device busy share of
  the fork family on the kernel engine: the summed device time of every
  kernel and copy ``torch.profiler`` records over 100 epochs, over the
  host wall of the same 100 epochs run without the profiler;
* with ``--first``: the Fig-15 grid's first and second ``run_grid`` calls
  in the process (all eight mechanisms, 800 epochs, kernel engine; the
  first holds the call's one-time costs, the dispatch guard's
  axis-liveness audits among them where the checkout has the auditor),
  and those audits alone, their cache cleared;
* with ``--service``: one micro-batch of the 304-CU DVFS service (the
  first 8 requests of ``dvfs_request_stream(32, seed=7)`` at
  ``SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38)``, 400 epochs,
  bucket 8) split into its two dispatch families -- pcstall (the fork
  family on the CU-tiled kernel) and static17 (unfused, ``vmap``) -- each
  dispatched alone through a ``GridExecutor``, with each family's device
  busy share over the same 400 epochs.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from repro_torch.core import simulate as SIM
from repro_torch.core.workloads import get_workload

FIG15_WORKLOADS = ["comd", "hpgmg", "lulesh", "xsbench", "hacc", "quickS",
                   "dgemm", "BwdBN", "BwdPool", "FwdSoft"]
FIG15_MECHS = ("static13", "static17", "static22", "crisp", "accreac",
               "pcstall", "accpc", "oracle")
FAMILIES = {"forks": ("crisp", "accreac", "pcstall", "accpc"),
            "statics": ("static13", "static17", "static22"),
            "oracle": ("oracle",)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def engine_ms(prog, n_epochs=100):
    out = {}
    for up in (True, False):
        cfg = SIM.SimConfig(n_epochs=n_epochs, use_pallas=up)
        SIM.run_sim(prog, cfg, "pcstall")
        out[f"use_pallas={up}"] = wall(
            lambda: SIM.run_sim(prog, cfg, "pcstall")) / n_epochs * 1e3
    return out


def busy_ms(fn) -> float:
    """Summed device time (ms) of the kernels and copies ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            total += t
    return total / 1e3


def grid_times(n_epochs=800):
    from repro_torch.core import sweep as SW
    progs = {w: get_workload(w) for w in FIG15_WORKLOADS}
    out = {}
    for up in (True, False):
        sim = SIM.SimConfig(n_epochs=n_epochs, use_pallas=up)
        for fam, mechs in FAMILIES.items():
            SW.run_grid(progs, dataclasses.replace(sim, n_epochs=3),
                        {"epoch_us": [1.0]}, mechs)     # builds, warm-up
            s = wall(lambda: SW.run_grid(progs, sim, {"epoch_us": [1.0]},
                                         mechs))
            out[f"{fam} use_pallas={up}"] = {
                "s": s, "ms_per_epoch": s / n_epochs * 1e3}
    sim = SIM.SimConfig(n_epochs=100)

    def forks():
        SW.run_grid(progs, sim, {"epoch_us": [1.0]}, FAMILIES["forks"])
    host = wall(forks)
    dev = busy_ms(forks)
    out["forks kernel engine, 100 epochs"] = {
        "host_ms": host * 1e3, "device_busy_ms": dev,
        "busy_share": dev / (host * 1e3)}
    return out


def first_calls(n_epochs=800):
    from repro_torch.core import sweep as SW
    progs = {w: get_workload(w) for w in FIG15_WORKLOADS}
    sim = SIM.SimConfig(n_epochs=n_epochs)

    def grid():
        SW.run_grid(progs, sim, {"epoch_us": [1.0]}, FIG15_MECHS)
    out = {"first_s": wall(grid), "second_s": wall(grid)}
    try:
        from repro_torch.analysis import deps as DEPS
    except ImportError:          # a checkout without the auditor
        return out
    DEPS.axis_liveness.cache_clear()
    t0 = time.perf_counter()
    for m in FIG15_MECHS:
        DEPS.require_dedup_sound(m, sim)
    out["audit_s"] = time.perf_counter() - t0
    out["audits"] = DEPS.axis_liveness.cache_info().misses
    return out


def service_times(n_epochs=400):
    from repro_torch.core import sweep as SW
    from repro_torch.data.pipeline import dvfs_request_stream
    sim = SIM.SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38,
                        n_epochs=n_epochs)
    jobs = [(p, ax) for p, ax, _ in dvfs_request_stream(8, seed=7)]
    out = {}
    for mech in ("pcstall", "static17"):
        ex = SW.GridExecutor(sim, (mech,), buckets=(8,))
        ex.run(jobs[:1])                                    # warm-up

        def batch():
            ex.run(jobs)
        host = wall(batch)
        dev = busy_ms(batch)
        out[mech] = {"s": host, "ms_per_epoch": host / n_epochs * 1e3,
                     "device_busy_ms": dev,
                     "busy_share": dev / (host * 1e3)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--service", action="store_true")
    ap.add_argument("--first", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sweep: needs a CUDA device")
    card = card_line()
    res = {"label": a.label, "card": card,
           "engine_ms_per_epoch": engine_ms(get_workload("comd"))}
    if a.first:
        res["fig15_first_calls"] = first_calls()
    if a.grid:
        res["fig15_families"] = grid_times()
    if a.service:
        res["service_families"] = service_times()
    for k, v in res.items():
        print(f"{k}: {v}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
