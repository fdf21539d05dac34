"""The PC-table pair (K1 predict, K2 update) of one checkout, as the v1
epoch calls it: outputs to compare two checkouts bit for bit, and device
times, launches per epoch and run walls to compare them in turns (needs
one CUDA card).

    python3 scripts/pc_table_ab.py [--root CHECKOUT] [--out run.pt]
    python3 scripts/pc_table_ab.py --compare a.pt b.pt

``--root`` names the checkout whose ``src/`` is imported (default: the
one that holds this script), so a parent unpacked with ``git archive``
is measured by the same script. Each run feeds that checkout's wrappers
the same numpy-seeded inputs at ``chip_smoke.py``'s shapes (64 CUs x 40
WFs, 64 tables x 128 slots, 10 states) and saves:

* K1's I_pred and K2's tables with int32 slots and 0-dim scalars on the
  card, and what the v1 epoch's call sites produce from its int64 slots
  (I_pred, the hit mask, the tables);
* the 600-epoch v1 pcstall run on comd (every output channel).

It prints, for each wrapper called as the v1 epoch calls it (int64
slots, 0-dim scalars, K1 with its hit mask): the device time per call
(``scripts/devtime.py``), the time per call with the host (events over
200 back-to-back calls) and the kernel alone (torch.profiler); the launch
floor (``torch.cuda._sleep(1)`` by the same methods); what a few v1
epochs run on the card, per epoch (torch.profiler); and three walls of
the 600-epoch v1 run. ``--compare`` prints, per output, whether the two
runs are bitwise equal.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import devtime as DT  # noqa: E402

CU, WF, NF, T_TABLES, ENTRIES = 64, 40, 10, 64, 128
N_EPOCHS, PROFILED_EPOCHS, WALLS = 600, 5, 3


def _inputs(dev):
    """chip_smoke.py's ``table_case(7)``: tables, ids, slots (int64) and
    the WFs' own estimates."""
    rng = np.random.default_rng(7)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    tbl = [f32(rng.uniform(0, 60, (T_TABLES, ENTRIES))),
           f32(rng.uniform(0, 40, (T_TABLES, ENTRIES))),
           f32((rng.uniform(size=(T_TABLES, ENTRIES)) > 0.4)
               * rng.integers(1, 9, (T_TABLES, ENTRIES)))]
    tid = torch.as_tensor(np.arange(CU) % T_TABLES, dtype=torch.int64).to(dev)
    idx = torch.as_tensor(rng.integers(0, ENTRIES, (CU, WF))).to(dev)
    fb = [f32(rng.uniform(0, 60, (CU, WF))), f32(rng.uniform(0, 40, (CU, WF)))]
    return tbl, tid, idx, fb


def run(out_path: str) -> int:
    from repro_torch import no_tf32
    from repro_torch.core import power as PWR
    from repro_torch.core import simulate as SIM
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels import pc_table as KPT
    dev = torch.device("cuda", 0)
    no_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; checkout: {ROOT}", flush=True)

    tbl, tid64, idx64, fb = _inputs(dev)
    tid = tid64.to(torch.int32)
    idx32 = idx64.to(torch.int32)
    F = PWR.freqs_ghz(PWR.DEFAULT, NF, device=dev)
    kp = dict(epoch_us=torch.tensor(1.0, device=dev),
              cap_per_ghz=torch.tensor(5500.0, device=dev))
    ema = torch.tensor(0.5, device=dev)
    shp = (T_TABLES, CU // T_TABLES * WF)
    upd = (fb[0].reshape(shp), fb[1].reshape(shp))

    # the call sites of the v1 epoch
    def k1_site():
        return KPT.pc_table_predict(*tbl, tid, idx64, *fb, F, **kp,
                                    return_hit=True)

    def k2_site():
        return KPT.pc_table_update(*tbl, idx64.reshape(shp), *upd, ema=ema)

    saved = {}
    saved["K1 int32"] = {"I_pred": KPT.pc_table_predict(
        *tbl, tid, idx32, *fb, F, **kp)}
    saved["K2 int32"] = dict(zip(("i0", "sens", "count"), KPT.pc_table_update(
        *tbl, idx32.reshape(shp), *upd, ema=ema)))
    saved["K1 call site"] = dict(zip(("I_pred", "hit"), k1_site()))
    saved["K2 call site"] = dict(zip(("i0", "sens", "count"), k2_site()))
    saved = {k: {f: v.detach().cpu() for f, v in d.items()}
             for k, d in saved.items()}

    # what a v1 epoch runs on the card (profiled before any other session:
    # CUPTI drops records once a process has traced a few thousand)
    prog = get_workload("comd", device=dev)
    sim = SIM.SimConfig(n_epochs=N_EPOCHS, use_pallas="v1")
    st, ax = sim.static_part(), sim.axes(dev)
    step = SIM._make_step(prog, prog.n_blocks, 0, st, ax, "pcstall")
    box = [SIM.init_carry(prog.n_blocks, st, dev)]

    def one_epoch():
        box[0], _ = step(box[0])

    counts = DT.kernel_counts(one_epoch, PROFILED_EPOCHS)
    total = sum(counts.values())
    pair = {re.search(r"pc_table_\w+_kernel", n).group(0): c
            for n, c in counts.items() if "pc_table_" in n}
    print(f"v1 epoch: {total / PROFILED_EPOCHS:.1f} launches on the card per "
          f"epoch over {PROFILED_EPOCHS} epochs ({len(counts)} distinct); "
          f"the pair: " + ", ".join(f"{n} {c}"
                                    for n, c in sorted(pair.items()))
          + f" on {card}", flush=True)
    for n, c in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"  {c / PROFILED_EPOCHS:5.1f}  {n[:110]}", flush=True)

    times = {}
    for label, fn, kern in (
            ("K1 call site", k1_site, "pc_table_predict_kernel"),
            ("K2 call site", k2_site, "pc_table_update_kernel"),
            ("launch floor", lambda: torch.cuda._sleep(1), "spin_kernel")):
        dv = DT.device_ms(fn)
        ev = DT.events_ms(fn)
        alone, kept = DT.kernel_means(fn, [kern])[kern]
        ran = DT.kernel_counts(fn, 4)
        times[label] = (dv, ev, alone)
        print(f"time {label}: device "
              + ("refused" if dv is None else f"{dv * 1e3:.2f} us")
              + f" per call, {ev * 1e3:.2f} us with the host (events), "
              "kernel alone "
              + ("not traced" if alone is None else f"{alone * 1e3:.2f} us")
              + f" ({kept} records); "
              f"{sum(ran.values()) / 4:.1f} launches per call on {card}",
              flush=True)

    # the 600-epoch v1 run: outputs (the first run) and walls
    walls = []
    for i in range(WALLS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = SIM.run_sim(prog, sim, "pcstall")
        torch.cuda.synchronize()
        if i == 0:
            saved["v1 run"] = {k: torch.as_tensor(v) for k, v in tr.items()}
        else:
            walls.append(time.perf_counter() - t0)
    print(f"v1 pcstall run ({N_EPOCHS} epochs, comd, 64 x 40): walls "
          + ", ".join(f"{w:.3f}" for w in walls) + " s; "
          + ", ".join(f"{w / N_EPOCHS * 1e3:.3f}" for w in walls)
          + f" ms per epoch on {card}", flush=True)
    if out_path:
        torch.save({"outputs": saved, "times": times, "walls": walls,
                    "epoch_launches": total / PROFILED_EPOCHS}, out_path)
    return 0


def compare(a_path: str, b_path: str) -> int:
    a, b = (torch.load(p)["outputs"] for p in (a_path, b_path))
    differ = 0
    for label in a:
        bad = [k for k in a[label] if not torch.equal(a[label][k],
                                                      b[label][k])]
        differ += len(bad)
        print(f"{label}: " + ("bitwise equal in every output ("
                              + ", ".join(a[label]) + ")" if not bad
                              else "differ in " + ", ".join(bad)))
    return 1 if differ else 0


def main() -> int:
    global ROOT
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    a = ap.parse_args()
    if a.compare:
        return compare(*a.compare)
    if not torch.cuda.is_available():
        print("pc_table_ab: CUDA is not available", file=sys.stderr)
        return 2
    ROOT = Path(a.root).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    return run(a.out)


ROOT = HERE.parent

if __name__ == "__main__":
    sys.exit(main())
