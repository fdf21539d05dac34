"""Sweep the IVR transition-latency regime, the paper's core hardware
premise, and print the ED2P crossover table (port of
``examples/ivr_regime.py``).

On-chip integrated voltage regulators shrink the V/f transition latency
from microseconds to nanoseconds (4ns dead time at 1us epochs, paper §5),
which is what makes fine-grain DVFS worth doing. Each hardware regime is
a ``PowerConfig`` value on the ``power`` axis of ``run_grid``, so the
whole ladder runs as one dispatch family (crisp and pcstall on the
fork-family kernel, K4, on the card). At the 4ns regime PCSTALL converts
most of the oracle's headroom; as the regulator slows, the dead time eats
the gains until predictive DVFS stops beating the static baseline.

  PYTHONPATH=src python examples_torch/ivr_regime.py             # the card
  PYTHONPATH=src python examples_torch/ivr_regime.py --device cpu
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.core import mechanisms as MECH
from repro_torch.core import power as PWR
from repro_torch.core.simulate import SimConfig
from repro_torch.core.sweep import run_grid, suite_metrics
from repro_torch.core.workloads import get_workload

WORKLOADS = ("comd", "hacc", "xsbench")
MECHS = ("static17", "crisp", "pcstall", "oracle")

# label = transition latency at the 1us operating point; the slope
# ``lat_per_us`` scales the paper's schedule (4ns @ 1us, capped at 400ns)
# from the on-chip IVR regime up two decades toward off-chip regulators
# (lat_cap_us stays below the epoch: dead time beyond it has no physical
# reading)
REGIMES = {
    "  4ns": PWR.PowerConfig(),                    # paper: on-chip IVR
    " 13ns": PWR.PowerConfig(lat_per_us=1.3e-2),
    " 40ns": PWR.PowerConfig(lat_per_us=4e-2),
    "130ns": PWR.PowerConfig(lat_per_us=1.3e-1, lat_cap_us=0.9),
    "400ns": PWR.PowerConfig(lat_per_us=4e-1, lat_cap_us=0.9),
}


def main(device="cuda", n_epochs=500, workloads=WORKLOADS, n_cu=64):
    """Prints the table and returns {regime: {mechanism: geomean ED2P vs
    static 1.7 GHz}}."""
    progs = {w: get_workload(w, device=device) for w in workloads}
    cfg = SimConfig(n_epochs=n_epochs, n_cu=n_cu)   # 1us epochs
    # one dispatch family for the whole regime ladder: power is an axis
    grid = run_grid(progs, cfg, {"power": list(REGIMES.values())}, MECHS)
    print(f"ED^2P vs static 1.7 GHz (geomean over {', '.join(workloads)}; "
          "1us epochs)")
    header = "  ".join(f"{MECH.get(m).label.split()[0]:>8s}"
                       for m in MECHS[1:])
    print(f"{'regime':>6s}  {header}")
    rows = {}
    for label, pw in REGIMES.items():
        sim = dataclasses.replace(cfg, power=pw)
        r = suite_metrics(None, sim, MECHS, n=2, traces=grid[(pw,)])
        rows[label] = {m: float(np.exp(np.mean(
            [np.log(r[w][m]["ednp_norm"]) for w in workloads])))
            for m in MECHS}
        print(f"{label:>6s}  " + "  ".join(f"{rows[label][m]:8.3f}"
                                           for m in MECHS[1:]))
    crossed = [label for label, r in rows.items() if r["pcstall"] >= 1.0]
    if crossed:
        print(f"\ncrossover: predictive fine-grain DVFS stops beating the "
              f"static baseline at the {crossed[0].strip()} regime")
    else:
        print("\nno crossover in this range: predictive DVFS still pays at "
              "the slowest regime swept")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
