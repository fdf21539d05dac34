"""Quickstart on the PyTorch/CUDA port: the paper's mechanism in 30 lines
(port of ``examples/quickstart.py``).

Runs PCSTALL vs reactive CRISP vs ORACLE on one GPU workload and prints
prediction accuracy + normalized ED2P (paper Figs 14/15). On the card
crisp and pcstall run the fused epoch kernel (K3).

  PYTHONPATH=src python examples_torch/quickstart.py            # the card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

from repro_torch.core.simulate import SimConfig, run_workload
from repro_torch.core.workloads import get_workload

WORKLOAD = "comd"
MECHANISMS = ("static17", "crisp", "pcstall", "oracle")


def main(device="cuda", n_epochs=600):
    """Prints the table and returns ``run_workload``'s results
    ({mechanism: {"accuracy", "ednp_norm", ...}})."""
    sim = SimConfig(n_epochs=n_epochs)         # 64-CU GPU, 1us epochs, ED2P
    prog = get_workload(WORKLOAD, device=device)   # comd: Molecular Dynamics
    results = run_workload(prog, sim, mechanisms=MECHANISMS)
    print(f"{'mechanism':10s} {'accuracy':>9s} {'ED2P vs 1.7GHz':>15s}")
    for mech, r in results.items():
        acc = "-" if mech.startswith("static") else f"{r['accuracy']:.3f}"
        print(f"{mech:10s} {acc:>9s} {r['ednp_norm']:>15.3f}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
