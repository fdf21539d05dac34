"""Frequency-sensitivity estimators (port of ``repro.core.estimators``).

All estimators consume hardware-counter-visible quantities of the executed
epoch: ``committed`` (CU,WF), ``core_frac`` (fraction of the epoch not
stalled), ``issue_q`` (issued/demanded). The wavefront-level STALL model is
PCSTALL's estimator; the CU-level models are the reactive baselines, in the
paper's order of faithfulness STALL < LEAD < CRIT < CRISP.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

CU_MODELS = ("stall", "lead", "crit", "crisp")


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the WF axis as sum / n (the reference divides; torch's
    CUDA mean multiplies by 1/n, which rounds differently)."""
    return x.sum(-1) / x.shape[-1]


def wf_stall_estimate(counters: Dict[str, torch.Tensor], f: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-wavefront STALL model, age/contention-normalized. Returns
    (i0_wf, sens_wf), shapes (CU,WF). f is (CU,) executed GHz."""
    c = counters["committed"]
    # one scheduling-contention counter per CU: the CU-mean issue ratio
    q_cu = torch.clamp(_mean(counters["issue_q"])[:, None], min=0.05)
    fb = f[:, None]
    # stall time in coarse ticks -> quantized core fraction (torch.round is
    # round-half-to-even, as the reference's)
    cf = torch.round(counters["core_frac"] * 16.0) / 16.0
    demand = c / q_cu
    sens = demand * cf / fb
    i0 = torch.clamp(demand - sens * fb, min=0.0)
    return i0, sens


def cu_estimate(counters: Dict[str, torch.Tensor], f: torch.Tensor,
                model: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """CU-level estimators of the reactive baselines. Returns (i0_cu,
    sens_cu), shapes (CU,)."""
    c = counters["committed"]          # (CU,WF)
    cf = counters["core_frac"]
    q = torch.clamp(counters["issue_q"], min=0.05)
    I_cu = c.sum(-1)

    if model == "stall":
        # single-thread view: unweighted mean core fraction of the CU
        cf_cu = _mean(cf)
        sens = I_cu * cf_cu / f
    elif model == "lead":
        # leading-load accounting ~ committed-weighted core fraction
        cf_cu = (c * cf).sum(-1) / torch.clamp(c.sum(-1), min=1e-6)
        sens = I_cu * cf_cu / f
    elif model == "crit":
        # critical-path: committed-weighted + contention correction
        cf_cu = (c * cf).sum(-1) / torch.clamp(c.sum(-1), min=1e-6)
        sens = I_cu * cf_cu / (f * torch.clamp(_mean(q), min=0.05))
    elif model == "crisp":
        # per-WF core products summed at CU level (store stalls + overlap)
        sens = ((c / q) * cf).sum(-1) / f
    else:
        raise ValueError(model)
    i0 = torch.clamp(I_cu - sens * f, min=0.0)
    return i0, sens
