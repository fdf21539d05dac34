"""DVFS manager (port of ``repro.dvfs_runtime.manager``): PCSTALL-driven
per-device frequency scheduling for a training or serving job, simulated —
it reports what the paper's mechanism would buy on the job's phase
structure.

Reports are thin clients of the sweep layer's
``repro_torch.core.sweep.GridExecutor``: the manager holds one executor per
(baseline, mechanism) pair — the handle the streaming
``repro_torch.dvfs_runtime.service.DVFSService`` is built on — so a single
``report`` is a one-job dispatch and ``grid_report`` evaluates a whole
epoch-granularity x objective grid as one micro-batch, through the same
batched steps ``run_grid`` runs (rows bitwise equal to it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import mechanisms as MECH
from repro_torch.core.mechanisms import MechanismSpec
from repro_torch.core.simulate import SimConfig, ednp, prediction_accuracy
from repro_torch.core.sweep import GridExecutor
from repro_torch.core.workloads import Program
from repro_torch.dvfs_runtime.telemetry import arch_program

Mechanism = Union[str, MechanismSpec]

StepLog = Sequence[Tuple[int, float]]


def step_time_stats(step_log: StepLog) -> Dict[str, float]:
    """Summarize observed (step, seconds) telemetry pairs: count, mean and
    p50/p99 step seconds, plus the observed step span (steps need not be
    contiguous — a decode loop may only sample every K-th token)."""
    if not step_log:
        return {"n_steps": 0, "mean_step_s": 0.0, "p50_step_s": 0.0,
                "p99_step_s": 0.0, "first_step": -1, "last_step": -1}
    steps = [int(s) for s, _ in step_log]
    secs = np.asarray([t for _, t in step_log], np.float64)
    return {"n_steps": int(secs.size),
            "mean_step_s": float(secs.mean()),
            "p50_step_s": float(np.percentile(secs, 50)),
            "p99_step_s": float(np.percentile(secs, 99)),
            "first_step": min(steps), "last_step": max(steps)}


def point_report(traces: Dict, epoch_us: float, base_spec: MechanismSpec,
                 mech_spec: MechanismSpec, n_freqs: int,
                 step_log: StepLog = ()) -> Dict[str, float]:
    """One job's DVFS report from its ``{mechanism: trace}`` dict: ED^2P /
    energy / delay vs the baseline, the V/f residency histogram (one bin
    per state of the job's ladder, ``n_freqs``) and the observed step-time
    stats. Shared by the manager's reports and the streaming service's
    per-request reports, so both speak one schema."""
    base, tr = traces[base_spec.name], traces[mech_spec.name]
    budget = 0.9 * base["work"].sum()
    E0, D0, M0 = ednp(base, budget, epoch_us)
    E, D, M = ednp(tr, budget, epoch_us)
    h = np.bincount(tr["fidx"].ravel(), minlength=n_freqs) / tr["fidx"].size
    stats = step_time_stats(step_log)
    return {
        # a static mechanism never predicts (its trace carries err == 0),
        # so its accuracy is undefined, as in suite_metrics
        "accuracy": prediction_accuracy(tr)
        if mech_spec.family != "static" else float("nan"),
        "energy_norm": E / E0,
        "delay_norm": D / D0,
        "ed2p_norm": M / M0,
        "freq_timeshare": [round(float(x), 3) for x in h],
        "mean_step_s": stats["mean_step_s"],  # alias of step_time's mean
        "step_time": stats,
    }


@dataclasses.dataclass
class DVFSManager:
    program: Program
    sim: SimConfig
    # the mechanism this deployment evaluates and the baseline its metrics
    # normalize to: any registered MechanismSpec (or name)
    mechanism: Mechanism = "pcstall"
    baseline: Mechanism = "static17"
    # observed (step, seconds) telemetry pairs (``observe_step``)
    step_log: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)
    _executors: Dict[tuple, GridExecutor] = dataclasses.field(
        default_factory=dict, repr=False)

    @classmethod
    def for_model(cls, cfg: ModelConfig, shape: ShapeConfig,
                  objective: str = "ed2p", n_cu: int = 16,
                  mechanism: Mechanism = "pcstall",
                  baseline: Mechanism = "static17",
                  device: DeviceLike = "cuda") -> "DVFSManager":
        """A manager for one (arch x shape) job: its step program on
        ``device``, 400 epochs at ``n_cu`` CUs."""
        prog = arch_program(cfg, shape, device=device)
        sim = SimConfig(n_cu=n_cu, n_epochs=400, objective=objective)
        return cls(program=prog, sim=sim, mechanism=mechanism,
                   baseline=baseline)

    def observe_step(self, step: int, seconds: float) -> None:
        self.step_log.append((int(step), float(seconds)))

    def _mechs(self, baseline: Optional[Mechanism]):
        """(baseline_spec, mechanism_spec) for one report, resolved
        through the registry (``baseline=None`` = the manager default)."""
        base = MECH.resolve(self.baseline if baseline is None else baseline)
        return base, MECH.resolve(self.mechanism)

    def _executor(self, base_spec: MechanismSpec,
                  mech_spec: MechanismSpec) -> GridExecutor:
        """The executor of one (baseline, mechanism) pair, built once and
        reused by every later report (its batched steps are cached with
        the sweep layer's own)."""
        key = (base_spec.name, mech_spec.name)
        if key not in self._executors:
            self._executors[key] = GridExecutor(
                self.sim, (base_spec, mech_spec),
                p_max=self.program.n_blocks)
        return self._executors[key]

    def _point_report(self, traces: Dict, epoch_us: float,
                      base_spec: MechanismSpec,
                      mech_spec: MechanismSpec) -> Dict[str, float]:
        return point_report(traces, epoch_us, base_spec, mech_spec,
                            self.sim.power.n_freqs, self.step_log)

    def report(self, baseline: Optional[Mechanism] = None
               ) -> Dict[str, float]:
        """Run the managed mechanism against ``baseline`` (default the
        manager's, normally static 1.7 GHz) on this job's phase program (a
        one-job executor dispatch)."""
        base_spec, mech_spec = self._mechs(baseline)
        trs = self._executor(base_spec, mech_spec).run(
            [(self.program, {"objective": self.sim.objective})])[0]
        return self._point_report(trs, self.sim.epoch_us, base_spec,
                                  mech_spec)

    def grid_report(self, epoch_us: Sequence[float] = (1.0, 10.0),
                    objectives: Optional[Sequence[str]] = None,
                    baseline: Optional[Mechanism] = None
                    ) -> Dict[tuple, Dict[str, float]]:
        """Sweep epoch granularity x objective for this job as ONE executor
        micro-batch (what a deployment would use to pick its DVFS
        operating point). Returns ``{(epoch_us, objective): report}``."""
        objectives = [self.sim.objective] if objectives is None \
            else list(objectives)
        base_spec, mech_spec = self._mechs(baseline)
        points = [{"epoch_us": float(e), "objective": o}
                  for e in epoch_us for o in objectives]
        res = self._executor(base_spec, mech_spec).run(
            [(self.program, p) for p in points])
        return {(p["epoch_us"], p["objective"]):
                self._point_report(tr, p["epoch_us"], base_spec, mech_spec)
                for p, tr in zip(points, res)}
