"""One card's step counted in torch: the counterpart of the reference's
``repro/roofline/hlo_analysis.py``.

The reference parses XLA's optimized HLO text (dot FLOPs, the output
bytes of top-level ops, collective bytes, each scaled by its loop's trip
count). The port runs eagerly and has no HLO, so :func:`analyze` runs the
step itself on ``meta`` tensors (``launch.input_specs``: shapes and
dtypes, no memory, nothing computed) and counts what it dispatches:

* ``flops``: matrix-product FLOPs from ``torch.utils.flop_counter.
  FlopCounterMode`` (the forward, the remat recompute and the backward),
  plus each hand-written kernel's operations by its formula
  (``roofline.work``): on the ``meta`` device the K6, K7 and K8 wrappers
  and K8's backward report their work to the open
  :class:`~repro_torch.roofline.work.WorkCounter` in place of a launch;
* ``hbm_bytes``: the bytes of every aten op's outputs (in the eager port
  each op writes its output to HBM; its reads are earlier ops' writes),
  allocations and views excepted, plus each kernel's bytes (its inputs
  read once and its outputs written once);
* ``collective_bytes`` and the ``coll_*`` keys: 0 on one card.

:func:`roofline_terms` turns the counts into the reference's time terms
against the H100's peaks.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline import work as W

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# ops that allocate without writing
_ALLOCS = ("empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided")


def _is_view(func) -> bool:
    """An op whose output aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _BytesMode(TorchDispatchMode):
    """Bytes of every aten op's outputs, and the count of those ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _ALLOCS \
                and not _is_view(func):
            self.ops += 1
            self.bytes += W.nbytes(*(t for t in pytree.tree_leaves(out)
                                     if isinstance(t, torch.Tensor)))
        return out


def analyze(fn: Callable, *inputs) -> Dict[str, object]:
    """Count one call ``fn(*inputs)`` on ``meta`` tensors. Returns the
    reference's keys (``flops``, ``hbm_bytes``, ``collective_bytes``,
    ``coll_*``) and the parts: ``matmul_flops`` (FlopCounterMode's),
    ``aten_ops`` (the ops that wrote), and ``kernels`` ({name: {"calls",
    "flops", "bytes"}} of the kernels that ran)."""
    leaves = [t for t in pytree.tree_leaves(inputs)
              if isinstance(t, torch.Tensor)]
    if not all(t.is_meta for t in leaves):
        raise ValueError("analyze takes meta tensors "
                         "(launch.input_specs), not data")
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, _BytesMode() as bytes_mode, W.WorkCounter() as kernels:
        fn(*inputs)
    mm = flop_mode.get_total_flops()
    k_flops = sum(k["flops"] for k in kernels.kernels.values())
    k_bytes = sum(k["bytes"] for k in kernels.kernels.values())
    return {"flops": float(mm + k_flops),
            "hbm_bytes": float(bytes_mode.bytes + k_bytes),
            "collective_bytes": 0.0,
            **{f"coll_{c}": 0.0 for c in COLLECTIVES},
            "matmul_flops": float(mm), "aten_ops": bytes_mode.ops,
            "kernels": kernels.kernels}


def roofline_terms(analysis: Dict[str, float],
                   peak_flops: float = W.PEAK_FLOPS_BF16
                   ) -> Dict[str, float]:
    """The reference's time terms of one card: compute at ``peak_flops``
    (the bf16 tensor-core rate unless the model runs in f32), memory at
    the HBM rate, collectives over NVLink (0 on one card); the dominant
    term and the compute term's share of the largest."""
    t_compute = analysis["flops"] / peak_flops
    t_memory = analysis["hbm_bytes"] / W.HBM_BW
    t_coll = analysis["collective_bytes"] / W.NVLINK_BW
    terms = {"t_compute_s": t_compute, "t_memory_s": t_memory,
             "t_collective_s": t_coll}
    bound = max(t_compute, t_memory, t_coll)
    terms["dominant"] = max(terms, key=terms.get)
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms
