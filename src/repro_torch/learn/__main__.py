"""End-to-end learned-predictor pipeline (port of ``python -m repro.learn``).

    PYTHONPATH=src python -m repro_torch.learn --mini --steps 300 \\
        --kind both --out learn_artifacts --device cpu

Generates a factory dataset (``--mini``: 2 workloads x 1 seed at 8 CUs;
otherwise the full ``DatasetConfig()``), trains the requested head(s),
freezes and registers the weights (the registration audits them), and
dispatches the registered specs through an unmodified ``run_grid`` beside
crisp and pcstall, asserting the fork-family build bound and the dedup
row accounting (:func:`run_pipeline`). Runs on the card unless
``--device cpu`` is given. Exits nonzero on any violated invariant."""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path
from typing import Callable, ContextManager, Optional, Sequence

import numpy as np

from repro_torch.core import mechanisms as MECH
from repro_torch.core import sweep as SW
from repro_torch.core.workloads import get_workload
from repro_torch.learn import dataset as LDS
from repro_torch.learn import mechanism as LMECH
from repro_torch.learn import train as LTR

KIND_NAMES = {"linear": "learned_lin", "mlp": "learned_mlp"}
SWEEP_OBJECTIVES = ("ed2p", "deadline05")


def _no_stage(name: str) -> ContextManager:
    return contextlib.nullcontext()


def run_pipeline(cfg: LDS.DatasetConfig, kinds: Sequence[str] = ("linear",),
                 *, steps: int = 300,
                 sweep_workloads: Optional[Sequence[str]] = None,
                 out: Optional[Path] = None,
                 stage: Callable[[str], ContextManager] = _no_stage
                 ) -> dict:
    """Train -> freeze -> register -> sweep on ``cfg.device``, asserting
    the reference's invariants.

    Generates ``cfg``'s dataset, fits each head of ``kinds`` (``steps``
    of ``train.fit``'s batch; the probe loss must fall), registers each
    frozen head as ``KIND_NAMES[kind]`` (audited), and sweeps them all
    beside crisp and pcstall through ``run_grid(dedup=True)`` over
    ``sweep_workloads`` (default: ``cfg``'s first two, as the
    reference's CLI) x
    :data:`SWEEP_OBJECTIVES`: at most two ``grid_forks`` builds, and
    ``DISPATCH_ROWS`` of W x G per learned spec. Writes the dataset and
    the weights under ``out`` when given. ``stage(name)`` wraps each step
    ("dataset", "fit <kind>", "register <name>", "sweep") for a caller
    that times them.

    Returns ``{"data", "meta", "fits": {kind: (params, curves)}, "specs":
    {kind: spec}, "progs", "grid", "report"}``; the specs stay registered
    (the caller unregisters them)."""
    with stage("dataset"):
        data, meta = LDS.generate_dataset(cfg)
    if out is not None:
        LDS.save_dataset(out / "dataset.npz", data, meta)
    _, val_mask = LDS.split_masks(data)
    if not val_mask.any():       # a mini split may hold out zero runs
        val_mask = ~val_mask
    report = {"rows": int(data["x"].shape[0]),
              "runs": len(meta["runs"]),
              "reactive_choice_acc": LTR.reactive_choice_baseline(
                  data, meta, val_mask)}

    fits, specs = {}, {}
    for kind in kinds:
        with stage(f"fit {kind}"):
            params, curves = LTR.fit(data, meta, kind=kind, steps=steps,
                                     device=cfg.device)
        assert curves["probe"][-1] < curves["probe"][0], \
            f"{kind}: probe loss did not decrease: {curves['probe']}"
        if out is not None:
            LTR.save_weights(out / f"weights_{kind}.npz", params,
                             extra_meta={"steps": steps})
        fits[kind] = (params, curves)
        with stage(f"register {KIND_NAMES[kind]}"):
            specs[kind] = LMECH.register_learned(KIND_NAMES[kind], params,
                                                 allow_override=True)

    # deployment contract: unmodified grid dispatch, bounded builds,
    # dedup accounting (the learned pc specs consume every axis)
    names = (list(cfg.workloads[:2]) if sweep_workloads is None
             else list(sweep_workloads))
    progs = {w: get_workload(w, device=cfg.device) for w in names}
    SW.reset_counters()
    with stage("sweep"):
        grid = SW.run_grid(progs, cfg.sim(),
                           {"objective": list(SWEEP_OBJECTIVES)},
                           ("crisp", "pcstall",
                            *(s.name for s in specs.values())))
    assert SW.TRACE_COUNTS.get("grid_forks", 0) <= 2, dict(SW.TRACE_COUNTS)
    W, G = len(progs), len(SWEEP_OBJECTIVES)
    for spec in specs.values():
        assert SW.DISPATCH_ROWS[f"grid_{spec.name}"] == W * G, \
            dict(SW.DISPATCH_ROWS)

    for kind, (_, curves) in fits.items():
        tr = grid[("ed2p",)][names[0]][specs[kind].name]
        report[kind] = {
            "first_loss": curves["probe"][0],
            "final_loss": curves["probe"][-1],
            "val_mse": curves.get("val_mse"),
            "val_choice_acc": curves.get("val_choice_acc"),
            "deployed_mean_f": float(
                np.take(meta["freqs_ghz"], tr["fidx"].astype(int)).mean()),
        }
    return {"data": data, "meta": meta, "fits": fits, "specs": specs,
            "progs": progs, "grid": grid, "report": report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.learn")
    ap.add_argument("--mini", action="store_true",
                    help="miniature dataset (2 workloads x 1 seed, 8 CUs)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--kind", choices=("linear", "mlp", "both"),
                    default="linear")
    ap.add_argument("--out", type=Path, default=Path("learn_artifacts"))
    ap.add_argument("--device", default="cuda",
                    help="where the sweep and the training run "
                         "(default: the card)")
    args = ap.parse_args(argv)

    cfg = LDS.DatasetConfig(device=args.device)
    if args.mini:
        cfg = LDS.DatasetConfig(workloads=("comd", "xsbench"), seeds=(0,),
                                epoch_us=(1.0,), n_cu=8, n_epochs=120,
                                warmup=16, val_frac=0.25,
                                device=args.device)
    kinds = ("linear", "mlp") if args.kind == "both" else (args.kind,)
    res = run_pipeline(cfg, kinds, steps=args.steps, out=args.out)
    for spec in res["specs"].values():
        MECH.unregister(spec.name)

    (args.out / "report.json").write_text(
        json.dumps(res["report"], indent=2))
    print(json.dumps(res["report"], indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
