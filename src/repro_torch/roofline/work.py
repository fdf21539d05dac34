"""The work of each kernel of the port, and the H100's peaks.

One definition of a kernel's work, whatever runs it: ``chip_smoke.py``
divides it by the peaks for each kernel's bound (``PERF.md`` §6), and on
the ``meta`` device the K6, K7 and K8 wrappers and K8's backward add it
to the open :class:`WorkCounter` in place of a launch, so that
``roofline.analysis.analyze`` counts a whole step.

Operations are floating-point operations of the function (a multiply and
an add are two), counted for the data of the call (the pairs a mask
keeps, not the full square). Bytes are what the function must move: each
input read once and each output written once (:func:`nbytes`).
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np

# NVIDIA H100 SXM data-sheet peaks (dense)
PEAK_FLOPS_BF16 = 989e12     # tensor cores, bf16 in, f32 sums
PEAK_FLOPS_F32 = 67e12       # CUDA cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way (one card: no collective)

# the simulator's main-path shapes (``SimConfig`` defaults)
_CU, _WF, _NF, _TABLES, _ENTRIES = 64, 40, 10, 64, 128


def nbytes(*ts) -> int:
    """Bytes of the tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(nb, ops, flop_rate=PEAK_FLOPS_F32):
    """(the least time in ms for ``nb`` bytes and ``ops`` operations at
    ``flop_rate``, what bounds it: ``"bytes"`` or ``"operations"``)."""
    t_bytes = nb / HBM_BW
    t_ops = ops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def epoch_flops(family, cu=_CU, wf=_WF, tables=_TABLES, nf=_NF,
                entries=_ENTRIES):
    """Floating-point operations of one epoch's function (K3) at a row of
    ``cu`` CUs x ``wf`` WFs, counted from the plain version: ~27 per WF
    for each of the 3 execute rows any output reads (fork rows 0 and NF-1
    and the selected row; the other fork rows set only their own scale),
    ~25 per WF for the selected row's counters and energy, ~10 per WF for
    the estimator, ~40 per (CU, state) for predict and select, and for pc
    the lookup (2 per WF) and update (3 per WF + 12 per slot)."""
    n = cu * wf
    ops = 27 * 3 * n + 25 * n + 10 * n + 40 * cu * nf
    if family == "pc":
        ops += 2 * n + 3 * n + 12 * tables * entries
    return ops


def fork_flops(rows, cu=_CU, wf=_WF, tables=_TABLES):
    """Operations of ``rows`` fork-family rows (K4, K5): a pc row's epoch
    plus the reactive predictor and the four counter estimators (~20 per
    WF)."""
    return rows * (epoch_flops("pc", cu, wf, tables) + 20 * cu * wf)


def attention_flops(B, S, H, hd, window=0, prefix=0, causal=True):
    """Operations of K6: the two products over the kept (query, key)
    pairs, 2 x hd each. Row i keeps the keys of its window, max(0, i - W +
    1) .. i (.. S - 1 without ``causal``) with W the window or S, and the
    first ``prefix`` keys besides: S (S + 1) / 2 pairs causal, W (W + 1) /
    2 + (S - W) W with a window, P^2 + (S (S + 1) - P (P + 1)) / 2 with a
    prefix of P."""
    W = min(window, S) if window > 0 else S
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - W + 1)
    hi = i if causal else np.full_like(i, S - 1)
    kept = (hi - lo + 1) + np.minimum(prefix, lo) \
        + np.maximum(0, prefix - 1 - hi)
    return 4 * B * H * hd * int(kept.sum())


def attention_bwd_flops(B, S, H, hd, window=0, prefix=0, causal=True):
    """Operations of K6's gradient: five products over the kept pairs (q
    k^T again, dv, dp, dq, dk), 2.5x the forward's: the least the
    function needs, from the log-sum-exp the forward saved. The backward
    kernel (``csrc/flash_attention_bwd.cu``) does seven: its dk/dv and its
    dq kernels each compute q k^T and dp, so that no output is summed
    across CTAs, and so its least time is 1.4x this bound."""
    return 2.5 * attention_flops(B, S, H, hd, window, prefix, causal)


def scan_flops(B, S, H, hd, N):
    """Operations of the selective scan (K8): per channel and token dt x,
    and per state the product with B, the decay's product and the sum
    into the state, the product with C and the sum into y (5 N + 1); per
    (batch, token, head) the decay's product and exp."""
    return B * S * H * (hd * (5 * N + 1) + 2)


def scan_bwd_flops(B, S, H, hd, N):
    """Operations of K8's backward: per channel and token the carried
    gradient's update with C gy (2 N), its products with B and with the
    previous state (4 N), the dC and dB terms (4 N), the decay's product
    into the carry (N), and dx and the ddt and dA terms (5); per (batch,
    token, head) the decay's exp and its products (4). The recompute of
    the states is the kernel's choice, not counted."""
    return B * S * H * (hd * (11 * N + 5) + 4)


def rwkv_flops(BH, T, hd):
    """Operations the WKV (K7) needs, counted from the exact token
    recurrence (the least of its forms): per (batch, head) and token, r .
    S (2 hd^2), the decay w * S and the outer product k v^T with their
    sum (3 hd^2), and the u bonus (r u k) v (5 hd). The chunked form K7
    computes does more (the (C, C) intra-chunk weights, the logs and
    exps)."""
    return BH * T * (5 * hd * hd + 5 * hd)


class WorkCounter:
    """Calls, operations and bytes of each kernel that ran on the
    ``meta`` device while the counter was open (``with WorkCounter() as
    c``): ``c.kernels[name] = {"calls", "flops", "bytes"}``. One counter
    is open at a time in a thread."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, int]] = {}

    def add(self, name: str, flops: int, nb: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nb)

    def __enter__(self) -> "WorkCounter":
        if getattr(_LOCAL, "counter", None) is not None:
            raise RuntimeError("a WorkCounter is already open")
        _LOCAL.counter = self
        return self

    def __exit__(self, *exc) -> None:
        _LOCAL.counter = None


_LOCAL = threading.local()


def record(name: str, flops: int, nb: int) -> None:
    """A kernel's call on the ``meta`` device: its work goes to this
    thread's open counter (none: nothing)."""
    c = getattr(_LOCAL, "counter", None)
    if c is not None:
        c.add(name, flops, nb)
