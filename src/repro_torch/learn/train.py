"""Train the learned predictors on a factory dataset (port of
``repro.learn.train``).

AdamW with the cosine schedule (``optim.adamw``) drives a pure
``(state, batch) -> (state, metrics)`` step over a plain-dict state, with
gradients from ``torch.autograd``. Batches and jitter are drawn with the
counter-based ``data.pipeline.stream_rng``, exactly as the reference
draws them: step ``s`` of seed ``k`` is a function of ``(k, s)`` alone, so
both packages train on the same rows.

Training runs on ``device`` (the card unless the caller asks for the
CPU), in f32 with TF32 off, in standardized feature/target space;
:func:`fit` returns FOLDED raw-space numpy parameters
(``models.fold_norm``), the frozen artifact a ``learn.mechanism`` spec
deploys, plus the loss/accuracy curves.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, no_tf32, resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as PIPE
from repro_torch.learn import dataset as LDS
from repro_torch.learn import models as LM
from repro_torch.optim import adamw


def norm_stats(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column (mean, std) with a floor so constant columns normalize
    to zero instead of exploding."""
    mu = a.mean(0).astype(np.float32)
    sd = np.maximum(a.std(0), 1e-6).astype(np.float32)
    return mu, sd


def make_train_step(kind: str, tc: TrainConfig, mu_y: np.ndarray,
                    sd_y: np.ndarray, device: DeviceLike = "cuda"
                    ) -> Tuple[Callable, Callable]:
    """The MSE step and the loss, on ``device``.

    The loss is computed through the DEPLOYED prediction: the residual
    un-normalized and trust-clamped against the batch's raw react digest
    exactly as ``models.predict_targets`` does at inference, then
    re-normalized. Clipped rows contribute no gradient to pushing
    further."""
    apply_fn = LM.APPLY[kind]
    dev = resolve_device(device)
    mu_y = torch.as_tensor(mu_y, dtype=torch.float32, device=dev)
    sd_y = torch.as_tensor(sd_y, dtype=torch.float32, device=dev)

    def loss_fn(p, batch):
        delta = apply_fn(p, batch["x"]) * sd_y + mu_y
        lim = LM.TRUST_RADIUS * torch.abs(batch["react"])
        pred = batch["react"] + torch.minimum(torch.maximum(delta, -lim),
                                              lim)
        return torch.mean(((pred - batch["y"]) / sd_y) ** 2)

    def step(state, batch):
        keys = sorted(state["params"])
        p = {k: state["params"][k].detach().requires_grad_(True)
             for k in keys}
        loss = loss_fn(p, batch)
        grads = dict(zip(keys, torch.autograd.grad(loss,
                                                   [p[k] for k in keys])))
        with torch.no_grad():
            params, opt, om = adamw.update(grads, state["opt"],
                                           state["params"], tc)
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                {"loss": loss.detach(), **om})

    def loss_only(p, batch):
        with torch.no_grad():
            return loss_fn(p, batch)

    return step, loss_only


def default_tc(kind: str, steps: int) -> TrainConfig:
    """Small-model defaults: shorter warmup, light decay; the cosine
    horizon is the actual step budget so the LR anneals to ~0."""
    return TrainConfig(lr=3e-2 if kind == "linear" else 1e-2,
                       warmup_steps=max(steps // 10, 1), total_steps=steps,
                       weight_decay=1e-3, grad_clip=1.0)


def fit(data: Dict[str, np.ndarray], meta: dict, *, kind: str = "linear",
        steps: int = 400, batch_size: int = 4096, seed: int = 0,
        hidden: int = 24, tc: Optional[TrainConfig] = None,
        noise_sigma: float = 1.0,
        noise_features: Tuple[str, ...] = ("pc_i0", "pc_sens", "f_prev",
                                           "pbar", "hit"),
        device: DeviceLike = "cuda"
        ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Train ``kind`` on the dataset's train runs, on ``device``.

    Returns ``(params, curves)``: ``params`` are frozen RAW-space numpy
    weights (normalization folded in); ``curves`` carries the per-step
    training loss, a deterministic jitter-free probe-loss curve
    (``curves["probe"]``), normalized-space train/val MSE of the frozen
    model, and oracle frequency-choice agreement on both splits.

    Every feature except the react digest gets Gaussian jitter of
    ``noise_sigma`` normalized units at train time (``noise_features``):
    the react pair is the only one whose offline reconstruction is exact,
    and the jitter keeps the head from banking on workload-identity
    shortcuts in the others."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        no_tf32()
    train_mask, val_mask = LDS.split_masks(data)
    xt, yt_raw = data["x"][train_mask], data["y"][train_mask]
    react_raw = xt[:, list(LM.REACT_COLS)]
    # residual-head normalization stats: the net predicts the correction
    # over the reactive digest (models.predict_targets adds it back)
    mu_x, sd_x = norm_stats(xt)
    mu_y, sd_y = norm_stats(yt_raw - react_raw)
    xn = ((xt - mu_x) / sd_x).astype(np.float32)
    names = list(meta["feature_names"])
    noise_cols = np.asarray([names.index(f) for f in noise_features
                             if f in names], np.int64)

    params0 = (LM.init_linear(seed) if kind == "linear"
               else LM.init_mlp(seed, hidden))
    tc = tc or default_tc(kind, steps)
    if tc.total_steps != steps:
        tc = replace(tc, total_steps=steps)
    p0 = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
          for k, v in params0.items()}
    state = {"params": p0, "opt": adamw.init(p0), "step": 0}
    step_fn, loss_fn = make_train_step(kind, tc, mu_y, sd_y, dev)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    n = xn.shape[0]
    bs = min(batch_size, n)
    Yd = on_dev(yt_raw.astype(np.float32))
    Rd = on_dev(react_raw.astype(np.float32))
    # deterministic jitter-free probe batch (counter ``steps`` is disjoint
    # from the per-step batch counters): the smoke-testable "training
    # improves the objective" signal
    pidx = on_dev(PIPE.stream_rng(seed, steps).integers(
        0, n, size=min(8192, n)))
    probe_batch = {"x": on_dev(xn)[pidx], "react": Rd[pidx], "y": Yd[pidx]}
    probe_every = max(1, steps // 10)
    losses = []
    probe = [float(loss_fn(state["params"], probe_batch))]
    for s in range(steps):
        rng = PIPE.stream_rng(seed, s)
        idx = rng.integers(0, n, size=bs)
        xb = xn[idx]
        if noise_sigma > 0.0 and noise_cols.size:
            xb = xb.copy()
            xb[:, noise_cols] += rng.normal(
                0.0, noise_sigma, size=(bs, noise_cols.size)
            ).astype(np.float32)
        jdx = on_dev(idx)
        state, m = step_fn(state, {"x": on_dev(xb), "react": Rd[jdx],
                                   "y": Yd[jdx]})
        losses.append(float(m["loss"]))
        if (s + 1) % probe_every == 0 or s == steps - 1:
            probe.append(float(loss_fn(state["params"], probe_batch)))

    trained = {k: v.cpu().numpy() for k, v in state["params"].items()}
    params = LM.fold_norm(trained, mu_x, sd_x, mu_y, sd_y)

    with torch.no_grad():
        pred = LM.predict_targets(params, on_dev(data["x"])).cpu().numpy()
    norm = {"mu_x": mu_x, "sd_x": sd_x, "mu_y": mu_y, "sd_y": sd_y}
    curves = {"loss": losses, "probe": probe, "kind": kind,
              "steps": steps, "norm": norm}
    for split, mask in (("train", train_mask), ("val", val_mask)):
        if not mask.any():
            continue
        err_n = (pred[mask] - data["y"][mask]) / sd_y
        curves[f"{split}_mse"] = float(np.mean(err_n ** 2))
        curves[f"{split}_choice_acc"] = LDS.choice_accuracy(
            pred, data, meta, mask)
    return params, curves


def reactive_choice_baseline(data: Dict[str, np.ndarray], meta: dict,
                             mask: np.ndarray) -> float:
    """The reactive baseline's frequency-choice agreement with the oracle
    on the same rows: select from the EMA fork-linear digest (feature
    columns react_i0/react_sens). The bar for the learned heads."""
    names = list(meta["feature_names"])
    i, j = names.index("react_i0"), names.index("react_sens")
    pred = np.stack([data["x"][:, i], data["x"][:, j]], axis=-1)
    return LDS.choice_accuracy(pred, data, meta, mask)


def save_weights(path, params: Dict[str, np.ndarray], *,
                 extra_meta: Optional[dict] = None):
    """Frozen-weights artifact (canonical npz; see ``data.pipeline``): the
    reference's layout, so either package reads the other's."""
    meta = {"kind": LM.kind_of(params),
            "feature_names": list(LM.FEATURE_NAMES),
            "target_names": list(LM.TARGET_NAMES)}
    meta.update(extra_meta or {})
    return PIPE.export_npz(path, params, meta)


def load_weights(path) -> Tuple[Dict[str, np.ndarray], dict]:
    return PIPE.load_npz(path)
