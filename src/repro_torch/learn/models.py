"""Predictor models for the learned DVFS mechanisms (port of
``repro.learn.models``).

Two deliberately tiny heads map a per-CU feature vector to the per-CU
``(i0, sens)`` linear-rate pair the engine's ``predict_instr`` lowering
consumes, the representation every builtin predictor speaks:

* ``linear``: one affine map from runtime telemetry to the I(f) model
  (Ilager et al., arXiv:2004.08177). 16 weights.
* ``mlp``: one tanh hidden layer, for phase structure the linear head
  cannot express.

Both heads are residual over the reactive EMA digest: the deployed
prediction is ``react_(i0, sens) + net(features)``, clamped to a trust
region (:func:`predict_targets`), so zero weights reproduce the reactive
baseline exactly.

Training happens in standardized feature/target space; :func:`fold_norm`
folds the standardization into the weights at freeze time, so the frozen
artifact is a function of RAW engine features. Parameters are flat
``{name: array}`` dicts of numpy arrays (the artifact, byte for byte the
reference's layout) or f32 tensors; the apply functions take either and
compute on the input's device.

The feature vector (order is the contract between ``learn.dataset``'s
offline reconstruction and ``learn.mechanism``'s online computation):

====  ===========  ======================================================
 idx   name         per-CU semantics
====  ===========  ======================================================
 0     pc_i0        PC-table i0 lookup at the current blocks, WF-summed
 1     pc_sens      PC-table sens lookup, WF-summed
 2     react_i0     EMA(beta=REACT_BETA) of the exact fork-linear i0
 3     react_sens   EMA of the exact fork-linear sensitivity
 4     f_prev       previous epoch's chosen frequency (GHz)
 5     pbar         online average power e_acc / t_acc (the Pbar term)
 6     hit          PC-table hit rate (stall/hit telemetry)
====  ===========  ======================================================
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch import clip

FEATURE_NAMES = ("pc_i0", "pc_sens", "react_i0", "react_sens",
                 "f_prev", "pbar", "hit")
N_FEATURES = len(FEATURE_NAMES)
TARGET_NAMES = ("i0_rate", "sens_rate")
N_TARGETS = len(TARGET_NAMES)

# EMA weight of the per-epoch exact fork-linear digest maintained in
# carry.react_* by the learned update hook; learn.dataset reproduces the
# same recursion offline so train-time and deploy-time features agree.
REACT_BETA = 0.5

Params = Dict[str, Union[np.ndarray, torch.Tensor]]


def _w(params: Params, k: str, x: torch.Tensor) -> torch.Tensor:
    """Parameter ``k`` as an f32 tensor on ``x``'s device (no copy when it
    already is one)."""
    return torch.as_tensor(params[k], dtype=torch.float32, device=x.device)


def _x(x) -> torch.Tensor:
    """Features as a tensor (numpy rows from the offline evaluation)."""
    return x if isinstance(x, torch.Tensor) else \
        torch.as_tensor(x, dtype=torch.float32)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed over the shared axis in index order, one product
    and one add at a time. Each output's bits then do not depend on how
    many rows share the call: on the card a matmul's kernel, and with it
    the summation order, changes with the row count, and the learned rows
    of a grid must equal the same rows run alone."""
    acc = x[..., 0, None] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k, None] * w[k]
    return acc


def init_linear(seed: int = 0) -> Dict[str, np.ndarray]:
    """Near-zero init: the folded-norm output starts at the target mean."""
    rng = np.random.default_rng((seed, N_FEATURES))
    w = rng.standard_normal((N_FEATURES, N_TARGETS)).astype(np.float32)
    return {"w": 0.01 * w, "b": np.zeros((N_TARGETS,), np.float32)}


def linear_apply(params: Params, x) -> torch.Tensor:
    x = _x(x)
    return _dot(x, _w(params, "w", x)) + _w(params, "b", x)


def init_mlp(seed: int = 0, hidden: int = 24) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, hidden))
    w1 = rng.standard_normal((N_FEATURES, hidden)).astype(np.float32)
    w2 = rng.standard_normal((hidden, N_TARGETS)).astype(np.float32)
    return {"w1": w1 * np.sqrt(2.0 / N_FEATURES, dtype=np.float32),
            "b1": np.zeros((hidden,), np.float32),
            "w2": 0.01 * w2,
            "b2": np.zeros((N_TARGETS,), np.float32)}


def mlp_apply(params: Params, x) -> torch.Tensor:
    x = _x(x)
    h = torch.tanh(_dot(x, _w(params, "w1", x)) + _w(params, "b1", x))
    return _dot(h, _w(params, "w2", x)) + _w(params, "b2", x)


def kind_of(params: Params) -> str:
    """The head, from the parameter keys (disjoint between heads)."""
    return "linear" if "w" in params else "mlp"


def apply_model(params: Params, x) -> torch.Tensor:
    """Dispatch on parameter keys (a static, host-side branch)."""
    return (linear_apply if kind_of(params) == "linear" else mlp_apply)(
        params, x)


APPLY = {"linear": linear_apply, "mlp": mlp_apply}
INIT = {"linear": init_linear, "mlp": init_mlp}

# Residual head contract: the network predicts a CORRECTION to the
# reactive EMA digest, so zero weights ARE the reactive baseline and
# weight decay anchors deployment there. Columns follow TARGET_NAMES
# order: (react_i0, react_sens).
REACT_COLS = (FEATURE_NAMES.index("react_i0"),
              FEATURE_NAMES.index("react_sens"))

# Trust region on the learned correction: |delta| <= TRUST * |react|, so
# a misprediction from the proxy features degrades the mechanism to
# reactive behavior instead of letting the closed loop diverge.
TRUST_RADIUS = 0.15


def predict_targets(params: Params, x) -> torch.Tensor:
    """The deployed prediction: reactive digest + trust-clamped residual.

    One definition shared by the online hook (``learn.mechanism``),
    offline evaluation (``learn.train``) and the reports."""
    x = _x(x)
    react = x[..., list(REACT_COLS)]
    delta = apply_model(params, x)
    lim = TRUST_RADIUS * torch.abs(react)
    return react + clip(delta, -lim, lim)


def fold_norm(params: Params, mu_x: np.ndarray, sd_x: np.ndarray,
              mu_y: np.ndarray, sd_y: np.ndarray) -> Dict[str, np.ndarray]:
    """Fold feature/target standardization into the weights (numpy f32).

    Training computes ``y_n = f(x_n)`` with ``x_n = (x - mu_x) / sd_x``
    and ``y = y_n * sd_y + mu_y``; the returned parameters satisfy
    ``apply(folded, x) == apply(trained, x_n) * sd_y + mu_y`` up to f32
    rounding."""
    mu_x, sd_x = (np.asarray(a, np.float32) for a in (mu_x, sd_x))
    mu_y, sd_y = (np.asarray(a, np.float32) for a in (mu_y, sd_y))
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    if kind_of(p) == "linear":
        w = (p["w"] / sd_x[:, None]) * sd_y[None, :]
        b = p["b"] * sd_y + mu_y - mu_x @ w
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}
    w1 = p["w1"] / sd_x[:, None]
    b1 = p["b1"] - mu_x @ w1
    w2 = p["w2"] * sd_y[None, :]
    b2 = p["b2"] * sd_y + mu_y
    return {"w1": w1.astype(np.float32), "b1": b1.astype(np.float32),
            "w2": w2.astype(np.float32), "b2": b2.astype(np.float32)}
