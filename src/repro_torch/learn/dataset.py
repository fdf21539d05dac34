"""Trace-dataset generator (port of ``repro.learn.dataset``): ``run_grid``
as a labeled-data factory.

One batched sweep over workloads x seeds x epoch granularities, the same
dispatch every figure uses, produces per run the oracle's trace (labels)
and PCSTALL's trace (hit telemetry). On the card with ``use_pallas`` True
(the default) the PCSTALL rows step on the fork family's fused epoch
kernel, one launch per epoch for all rows; the oracle steps the unfused
body. From the traces this module reconstructs, offline and causally, the
per-epoch feature vector the deployed hook computes online
(``models.FEATURE_NAMES``; the online counterpart is
``learn.mechanism.epoch_features``).

Offline/online feature bridge (as in the reference):

* ``react_i0/react_sens``: the EMA (``models.REACT_BETA``) of the exact
  per-epoch fork-linear digest; offline ``sens`` is the trace's
  ``true_sens`` and ``i0`` is ``work/T - sens * f_sel``.
* ``pc_i0/pc_sens``: online WF-summed PC-table lookups; offline the
  table's EMA over the CU-level estimates, seeded at the engine's per-WF
  init (``1.2/0.8 * n_wf``).
* ``hit``: the trace's epoch-scalar ``hit_rate`` broadcast per CU.

``f_prev`` and ``pbar`` are exact given the trace and the engine's
warm-start constants.

Each run contributes two trajectories, the oracle's (labels: its own
choices) and PCSTALL's (labels: :func:`select_fidx` on the realized
next-epoch linear), so the policy-coupled features cover a realistic
non-oracle policy; ``data["policy"]`` records the source (0 oracle, 1
pcstall).

Determinism: the same ``DatasetConfig`` gives a bitwise-identical npz on
one device and engine (the grid dispatch is deterministic, the
reconstruction is numpy, ``data.pipeline.export_npz`` writes
canonically). The engine and the device are part of a dataset's identity,
like every other field. Train/val splits are by run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import power as PWR
from repro_torch.core import simulate as SIM
from repro_torch.core.simulate import SimConfig
from repro_torch.core.sweep import run_grid
from repro_torch.core.workloads import get_workload
from repro_torch.data import pipeline as PIPE
from repro_torch.learn import models as LM


@dataclass(frozen=True)
class DatasetConfig:
    """The labeled-data factory's sweep + reconstruction settings."""
    workloads: Tuple[str, ...] = ("comd", "hpgmg", "lulesh", "minife",
                                  "xsbench", "hacc", "pennant", "dgemm")
    seeds: Tuple[int, ...] = (0, 1)
    epoch_us: Tuple[float, ...] = (1.0, 10.0)
    n_cu: int = 32
    n_epochs: int = 240
    warmup: int = 24            # epochs dropped while EMAs burn in
    objective: str = "ed2p"
    val_frac: float = 0.25
    seed: int = 0               # split stream seed
    # the sweep's engine (SimConfig.use_pallas): the port's kernels by
    # default; the engine is part of a dataset's identity
    use_pallas: Union[bool, str] = True
    # where the factory sweep runs
    device: DeviceLike = "cuda"

    def sim(self) -> SimConfig:
        return SimConfig(n_cu=self.n_cu, n_epochs=self.n_epochs,
                         objective=self.objective,
                         use_pallas=self.use_pallas)


def _run_features(otr: Dict[str, np.ndarray], hit: np.ndarray, T: float,
                  sim: SimConfig, F: np.ndarray, e0: float, t0: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One run's causal feature/target reconstruction.

    ``otr``: a trace (epoch-leading arrays), ``hit``: PCSTALL's hit_rate
    channel (E,). Returns ``(x (E,CU,F), y (E,CU,2), fidx (E,CU))`` over
    ALL epochs; the caller drops warmup."""
    work = np.asarray(otr["work"], np.float64)         # (E, CU)
    energy = np.asarray(otr["energy"], np.float64)
    fidx = np.asarray(otr["fidx"], np.int64)
    sens = np.asarray(otr["true_sens"], np.float64)
    E, CU = work.shape
    f_sel = F[fidx]
    i0_est = work / T - sens * f_sel

    beta, ema = LM.REACT_BETA, sim.table_ema
    pc_i0 = np.full(CU, 1.2 * sim.n_wf)
    pc_sens = np.full(CU, 0.8 * sim.n_wf)
    react_i0 = np.full(CU, 50.0)
    react_sens = np.full(CU, 30.0)
    f_prev = np.full(CU, PWR.F_STATIC)
    e_acc, t_acc = np.full(CU, e0), t0

    x = np.zeros((E, CU, LM.N_FEATURES))
    for t in range(E):
        pbar = e_acc / max(t_acc, 1e-3)
        x[t] = np.stack([pc_i0, pc_sens, react_i0, react_sens,
                         f_prev, pbar, np.full(CU, hit[t])], axis=-1)
        pc_i0 = (1.0 - ema) * pc_i0 + ema * i0_est[t]
        pc_sens = (1.0 - ema) * pc_sens + ema * sens[t]
        react_i0 = (1.0 - beta) * react_i0 + beta * i0_est[t]
        react_sens = (1.0 - beta) * react_sens + beta * sens[t]
        f_prev = f_sel[t]
        e_acc = e_acc + energy[t]
        t_acc = t_acc + T
    y = np.stack([i0_est, sens], axis=-1)
    return (x.astype(np.float32), y.astype(np.float32),
            fidx.astype(np.int32))


def generate_dataset(cfg: DatasetConfig = DatasetConfig()
                     ) -> Tuple[Dict[str, np.ndarray], dict]:
    """Run the factory sweep on ``cfg.device`` and reconstruct the labeled
    dataset.

    Returns ``(arrays, meta)`` ready for :func:`save_dataset`:

    * ``x (N, n_features)`` raw features, ``y (N, 2)`` regression targets
      ``(i0_rate, sens_rate)``, ``fidx (N,)`` the (greedy-)oracle
      frequency label, ``t_us (N,)`` the row's epoch length, ``run (N,)``
      run id, ``policy (N,)`` source trajectory,
    * ``train_runs``/``val_runs``: the seeded by-run split (both policy
      trajectories of a run land on the same side)."""
    dev = resolve_device(cfg.device)
    sim = cfg.sim()
    progs = {w: get_workload(w, device=dev) for w in cfg.workloads}
    grid = run_grid(progs, sim, {"epoch_us": list(cfg.epoch_us)},
                    ("pcstall", "oracle"), seeds=list(cfg.seeds))
    carry0 = SIM.init_carry(next(iter(progs.values())).n_blocks,
                            sim.static_part(), "cpu")
    e0, t0 = float(carry0.e_acc[0]), float(carry0.t_acc)
    F = PWR.freqs_ghz(sim.power).numpy().astype(np.float64)
    # the selection-mirror context for the pcstall-trajectory labels
    meta_sel = {"freqs_ghz": [float(f) for f in F],
                "cap_per_ghz": sim.cap_per_ghz, "n_wf": sim.n_wf,
                "objective": cfg.objective}
    pbar_col = LM.FEATURE_NAMES.index("pbar")

    xs, ys, fs, ts, rs, ps, runs = [], [], [], [], [], [], []
    for T in cfg.epoch_us:
        for w in cfg.workloads:
            for si, seed in enumerate(cfg.seeds):
                point = grid[(T,)][w]
                run_id = len(runs)
                runs.append({"workload": w, "seed": int(seed),
                             "epoch_us": float(T)})
                hit = np.asarray(point["pcstall"]["hit_rate"][si],
                                 np.float64)
                for pol, mech in ((0, "oracle"), (1, "pcstall")):
                    tr = {k: np.asarray(v[si])
                          for k, v in point[mech].items()}
                    x, y, fidx = _run_features(tr, hit, float(T), sim,
                                               F, e0, t0)
                    x, y, fidx = (a[cfg.warmup:] for a in (x, y, fidx))
                    n = x.shape[0] * x.shape[1]
                    x, y = x.reshape(n, -1), y.reshape(n, -1)
                    if pol == 1:
                        # greedy-oracle label for the behavior trajectory
                        fidx = select_fidx(y[:, 0], y[:, 1],
                                           x[:, pbar_col],
                                           np.full(n, T), meta_sel)
                    xs.append(x)
                    ys.append(y)
                    fs.append(fidx.reshape(n))
                    ts.append(np.full(n, T, np.float32))
                    rs.append(np.full(n, run_id, np.int32))
                    ps.append(np.full(n, pol, np.int8))
    tr, va = PIPE.train_val_split(len(runs), val_frac=cfg.val_frac,
                                  seed=cfg.seed)
    data = {"x": np.concatenate(xs), "y": np.concatenate(ys),
            "fidx": np.concatenate(fs), "t_us": np.concatenate(ts),
            "run": np.concatenate(rs), "policy": np.concatenate(ps),
            "train_runs": tr, "val_runs": va}
    meta = {"feature_names": list(LM.FEATURE_NAMES),
            "target_names": list(LM.TARGET_NAMES),
            "workloads": list(cfg.workloads), "seeds": list(cfg.seeds),
            "epoch_us": list(cfg.epoch_us), "runs": runs,
            "n_cu": sim.n_cu, "n_wf": sim.n_wf,
            "n_epochs": cfg.n_epochs, "warmup": cfg.warmup,
            "objective": cfg.objective, "table_ema": sim.table_ema,
            "cap_per_ghz": sim.cap_per_ghz,
            "react_beta": LM.REACT_BETA, "split_seed": cfg.seed,
            "val_frac": cfg.val_frac,
            "freqs_ghz": [float(f) for f in F],
            "e_acc0": e0, "t_acc0": t0, "power": "default"}
    return data, meta


def save_dataset(path, data: Dict[str, np.ndarray], meta: dict):
    """Canonical npz export (bitwise-reproducible; see ``pipeline``)."""
    return PIPE.export_npz(path, data, meta)


def load_dataset(path) -> Tuple[Dict[str, np.ndarray], dict]:
    return PIPE.load_npz(path)


def split_masks(data: Dict[str, np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Row masks for the by-run train/val split."""
    return (np.isin(data["run"], data["train_runs"]),
            np.isin(data["run"], data["val_runs"]))


def _power_mirror(F: np.ndarray, act: np.ndarray) -> np.ndarray:
    """``power.power`` at the default regime in the reference's selection
    mirror's precision: the voltage terms in f64, then the activity
    clip, product, sum and quotient each rounded to f32."""
    pw = PWR.DEFAULT
    v = PWR.v_of_f(F, pw)
    a = np.clip(np.asarray(act, np.float32), np.float32(0.05),
                np.float32(1.0))
    p_dyn = np.asarray(pw.c_eff * v * v * F, np.float32) * a
    p_leak = np.asarray(pw.k_leak * v, np.float32)
    eta = np.asarray(PWR.ivr_eta(v, pw), np.float32)
    return (p_dyn + p_leak) / eta


def select_fidx(i0: np.ndarray, sens: np.ndarray, pbar: np.ndarray,
                t_us: np.ndarray, meta: dict) -> np.ndarray:
    """Offline mirror of the engine's frequency selection at
    ``cus_per_domain=1`` (the factory configs'): lower a per-row
    ``(i0, sens)`` linear model through ``predict_instr``'s clipping and
    ``_select_freq``'s objective cost, vectorized over rows (numpy, on the
    host). Metric-only: the deployed hook goes through the real engine."""
    F = np.asarray(meta["freqs_ghz"], np.float64)
    cap, n_wf = meta["cap_per_ghz"], meta["n_wf"]
    w_pbar, use_rate, capf = np.asarray(
        SIM.objective_weights(meta["objective"]), np.float64)
    T = np.asarray(t_us, np.float64)[:, None]
    I = (np.asarray(i0, np.float64)[:, None]
         + np.asarray(sens, np.float64)[:, None] * F[None, :]) * T
    cap_row = cap * F[None, :] * T * n_wf
    I = np.clip(I, 0.0, cap_row)
    act = I / cap_row
    p = np.asarray(_power_mirror(F[None, :], act), np.float64)
    I_sum = np.maximum(I, 1e-3)
    denom = I_sum if use_rate > 0.0 else np.ones_like(I_sum)
    infeasible = I_sum < capf * I_sum[:, -1:]
    cost = (p + w_pbar * np.asarray(pbar, np.float64)[:, None]) / denom \
        + 1e9 * infeasible
    return np.argmin(cost, axis=-1).astype(np.int32)


def choice_accuracy(pred_y: np.ndarray, data: Dict[str, np.ndarray],
                    meta: dict, mask: np.ndarray) -> float:
    """Fraction of rows where the predicted ``(i0, sens)`` model selects
    the oracle's frequency index, over ``mask``'s rows."""
    pbar_col = list(meta["feature_names"]).index("pbar")
    f = select_fidx(pred_y[mask, 0], pred_y[mask, 1],
                    data["x"][mask, pbar_col], data["t_us"][mask], meta)
    return float(np.mean(f == data["fidx"][mask]))
