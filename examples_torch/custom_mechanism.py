"""Register a NEW DVFS mechanism without touching the engine or the sweep
layer (port of ``examples/custom_mechanism.py``).

The mechanism is a DSO-style fused static+dynamic estimator (after Wang
et al., "DSO: A GPU Energy Efficiency Optimizer by Fusing Dynamic and
Static Information", arXiv:2407.13096): next-epoch instructions are
predicted from a blend of

  * a *static code feature*: the per-CU linear (i0, sens) model the
    program text implies at the wavefronts' current PC blocks, and
  * the *dynamic* CU-level reactive state digested from hardware counters
    (the CRISP estimator feeding the standard reactive carry).

Registration is pure data: a ``MechanismSpec`` with ``predict``/``update``
hooks on torch tensors. ``register`` audits the spec's ``exec_axes``
(``repro_torch.analysis.deps`` follows one epoch of it operation by
operation), so a hook that read an undeclared axis would be refused with
an ``AxisLivenessError``. The custom spec runs the unfused epoch body, as
in the reference; static17, crisp and pcstall run the fork-family kernel
(K4) on the card.

  PYTHONPATH=src python examples_torch/custom_mechanism.py       # the card
  PYTHONPATH=src python examples_torch/custom_mechanism.py --device cpu
"""
import argparse
import dataclasses

from repro_torch.core import estimators as EST
from repro_torch.core import mechanisms as MECH
from repro_torch.core import simulate as SIM
from repro_torch.core.mechanisms import MechanismSpec
from repro_torch.core.simulate import SimConfig
from repro_torch.core.sweep import run_grid, suite_metrics
from repro_torch.core.workloads import get_workload

ALPHA = 0.5  # static-code-feature weight of the blend
WORKLOADS = ("comd", "hacc", "xsbench")
MECHS = ("static17", "crisp", "dso", "pcstall")


def dso_predict(carry, ctx, st, ax):
    """Blend static code features with the dynamic reactive state and
    lower to the capacity-clipped (CU, 10) prediction."""
    i0_code = ctx.i0_l.sum(-1)
    s_code = ctx.s_l.sum(-1)
    i0 = ALPHA * i0_code + (1.0 - ALPHA) * carry.react_i0
    sens = ALPHA * s_code + (1.0 - ALPHA) * carry.react_sens
    return SIM.predict_instr(i0, sens, st, ax)


def dso_update(counters, f_sel, I_f, carry, ctx, st, ax):
    """Digest this epoch's counters with the CRISP model into the dynamic
    half of the blend (rate units: instr/us, instr/us/GHz)."""
    i0_cu, s_cu = EST.cu_estimate(counters, f_sel, "crisp")
    return i0_cu / ax.epoch_us, s_cu / ax.epoch_us


DSO = MechanismSpec(
    "dso", "reactive",
    # "power" is mandatory for every spec: the V/f ladder and the energy
    # accounting make the traced IVR regime live in all mechanisms
    exec_axes=("epoch_us", "sigma", "cap_per_ghz", "membw", "obj", "n_ep",
               "power"),
    label="DSO (static+dynamic blend)",
    predict=dso_predict, update=dso_update)


def main(device="cuda", n_epochs=400, workloads=WORKLOADS, n_cu=64):
    """Registers DSO (audited), sweeps it beside the builtins over two
    objectives, prints each ED^nP, unregisters it and returns
    {(objective, workload): {label: ED^nP vs static 1.7}}."""
    MECH.register(DSO)
    try:
        progs = {w: get_workload(w, device=device) for w in workloads}
        cfg = SimConfig(n_epochs=n_epochs, n_cu=n_cu)
        grid = run_grid(progs, cfg, {"objective": ["ed2p", "edp"]}, MECHS)
        out = {}
        for obj, n in (("ed2p", 2), ("edp", 1)):
            r = suite_metrics(None, dataclasses.replace(cfg, objective=obj),
                              MECHS, n=n, traces=grid[(obj,)])
            for wl in progs:
                out[(obj, wl)] = {MECH.get(m).label: r[wl][m]["ednp_norm"]
                                  for m in MECHS if m != "static17"}
                row = "  ".join(f"{k}={v:.3f}"
                                for k, v in out[(obj, wl)].items())
                print(f"{obj:4s} {wl:8s} ED^{n}P vs static1.7: {row}")
    finally:
        MECH.unregister(DSO.name)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
