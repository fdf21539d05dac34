"""Scalability study (paper Fig 18b + 17): PCSTALL across V/f-domain
granularities, epoch durations and objectives on a phased workload (port
of ``examples/dvfs_granularity.py``).

The V/f-domain size reshapes (CU -> domain) arrays, so it is a static
shape looped in Python; epoch duration and objective are ``run_grid``
axes, so each domain size runs its whole (epoch_us x objective) grid as
one dispatch family (pcstall on the fork-family kernel, K4, on the card).
The static-1.7 baseline is deduplicated across the two objectives.

  PYTHONPATH=src python examples_torch/dvfs_granularity.py       # the card
  PYTHONPATH=src python examples_torch/dvfs_granularity.py --device cpu
"""
import argparse
import dataclasses

from repro_torch.core import mechanisms as MECH
from repro_torch.core.simulate import SimConfig
from repro_torch.core.sweep import run_grid, suite_metrics
from repro_torch.core.workloads import get_workload

WORKLOAD = "hacc"
GRID = {"epoch_us": [1.0, 10.0], "objective": ["ed2p", "edp"]}


def main(device="cuda", n_epochs=500, domains=(1, 4, 16), n_cu=64):
    """Prints and returns {(domain CUs, epoch_us, objective): {"pcstall",
    "oracle"}} of ED^nP vs static 1.7 GHz."""
    prog = get_workload(WORKLOAD, device=device)
    # resolved through the MechanismSpec registry: the baseline and the
    # two predictors, addressable by name or spec everywhere below
    mechs = tuple(MECH.get(m) for m in ("static17", "pcstall", "oracle"))
    out = {}
    for g in domains:
        cfg = SimConfig(n_epochs=n_epochs, n_cu=n_cu, cus_per_domain=g,
                        cus_per_table=g)
        res = run_grid([prog], cfg, GRID, mechs)
        for (T, obj), traces in res.items():
            n = 2 if obj == "ed2p" else 1
            r = suite_metrics(None, dataclasses.replace(cfg, epoch_us=T,
                                                        objective=obj),
                              mechs, n=n, traces=traces,
                              baseline=mechs[0])[prog.name]
            out[(g, T, obj)] = {m: r[m]["ednp_norm"]
                                for m in ("pcstall", "oracle")}
            print(f"{g:2d}-CU domains {T:5.1f}us {obj:4s}: "
                  f"pcstall ED^{n}P={r['pcstall']['ednp_norm']:.3f} "
                  f"oracle={r['oracle']['ednp_norm']:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
