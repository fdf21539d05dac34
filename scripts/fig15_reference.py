"""The JAX reference's Fig-15 numbers, for ``chip_smoke.py`` to print
beside the port's.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/fig15_reference.py

Runs the reference package (``repro``) exactly as
``benchmarks/paper_figs.py::fig15_ed2p`` does: the ten ``WORKLOADS_FAST``
programs, ``FAST_MECHS``, ``SimConfig(n_epochs=800)`` (64 CUs x 40 WFs),
one ``run_grid`` point ``{"epoch_us": [1.0]}``, then ``suite_metrics``.
Prints one JSON object: each mechanism's geometric-mean ED2P normalised to
static 1.7 GHz and its mean prediction accuracy over the workloads.
"""
import json

import numpy as np

from benchmarks.paper_figs import FAST_MECHS, WORKLOADS_FAST
from repro.core.sweep import run_grid, suite_metrics
from repro.core.simulate import SimConfig
from repro.core.workloads import get_workload


def main():
    sim = SimConfig(n_epochs=800)
    progs = {w: get_workload(w) for w in WORKLOADS_FAST}
    traces = run_grid(progs, sim, {"epoch_us": [1.0]}, FAST_MECHS)[(1.0,)]
    r = suite_metrics(None, sim, FAST_MECHS, n=2, traces=traces)
    ed2p = {m: float(np.exp(np.mean([np.log(r[w][m]["ednp_norm"])
                                     for w in WORKLOADS_FAST])))
            for m in FAST_MECHS}
    acc = {m: float(np.mean([r[w][m]["accuracy"] for w in WORKLOADS_FAST]))
           for m in FAST_MECHS if not m.startswith("static")}
    print(json.dumps({"geomean_ed2p": ed2p, "mean_accuracy": acc}))


if __name__ == "__main__":
    main()
