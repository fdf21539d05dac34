"""PyTorch/CUDA port of the fine-grain DVFS simulator (``repro``).

The package mirrors ``repro``'s module layout (``core/workloads.py``,
``kernels/epoch_fused.py``, ...) and never imports JAX or ``repro``. Entry
points run on the CUDA device unless the caller asks for the CPU; asking
for ``"cuda"`` on a machine without a card raises instead of falling back.
On a CUDA tensor every kernel wrapper launches its hand-written CUDA
kernel (``kernels/csrc``); on a CPU tensor it runs the kernel's plain
PyTorch version.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is present (nothing carries on on the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def no_tf32() -> None:
    """Keep every f32 matmul in full f32. The lean epoch body computes the
    per-CU prefix sum as a tril matmul; TF32 would drop ~10 mantissa bits
    there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` semantics, minimum(maximum(x, lo), hi), with tensor
    bounds allowed (``torch.clamp`` takes both bounds of one kind)."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def clamp_blocks(n: torch.Tensor, p_blocks) -> torch.Tensor:
    """``clip(n, 1, p_blocks)`` for a block count that is an int or a
    tensor broadcasting against ``n`` (one per grid row)."""
    if isinstance(p_blocks, torch.Tensor):
        return torch.minimum(torch.clamp(n, min=1), p_blocks)
    return torch.clamp(n, 1, p_blocks)


def prog_len(p_blocks, instr_per_block: int):
    """A program's length in instructions as f32: a float for an int block
    count, a tensor for a tensor."""
    if isinstance(p_blocks, torch.Tensor):
        return (p_blocks * instr_per_block).to(torch.float32)
    return float(p_blocks * instr_per_block)


def select_id(mech: torch.Tensor, vals, default) -> torch.Tensor:
    """``jnp.select([mech == k for k in range(len(vals))], vals,
    default)``: the value of the traced id ``mech``, else ``default``."""
    out = default
    for k in reversed(range(len(vals))):
        out = torch.where(mech == k, vals[k], out)
    return out


def any_id(mech: torch.Tensor, ids) -> torch.Tensor:
    """Whether the traced id ``mech`` is one of ``ids`` (a bool tensor)."""
    out = torch.zeros((), dtype=torch.bool, device=mech.device)
    for i in ids:
        out = out | (mech == i)
    return out
