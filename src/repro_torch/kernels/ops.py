"""Public wrappers of the kernels, as ``repro/kernels/ops.py`` has them.

``flash_attention`` takes the model's (B,S,H,hd) layout with grouped KV
heads and ``rwkv_chunked`` the reference's (BH,T,hd) one. Each launches
its CUDA kernel (K6, K7) on a CUDA tensor and runs the plain version on a
CPU tensor; ``flash_attention`` is differentiable
(``flash_attention.FlashAttention``). The launches are counted in
``flash_attention.flash_attention_bshd.launches`` and
``rwkv_chunk.rwkv_chunked_bthd.launches``. ``pc_table_predict`` and
``pc_table_update`` are the PC-table pair (K1, K2) of ``pc_table``, which
take the reference's operands.

The reference's ``set_backend`` is not ported: it switches its Pallas
kernels between interpret mode and the TPU. Here the tensor's device
chooses: the kernel on a CUDA tensor, its plain version on a CPU one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rwkv_chunk as _rc
from repro_torch.kernels.pc_table import (  # noqa: F401
    pc_table_predict, pc_table_update)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0, blk_q: int = 128,
                    blk_k: int = 128) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,Hkv,hd) with H % Hkv == 0. Returns
    (B,S,H,hd) in q's dtype. ``blk_q`` is the reference's and has no
    effect (K6 tiles its own query rows); keys are walked in blocks of
    ``min(blk_k, S)``, which must divide S. ``prefix_len`` (the port's,
    the reference's jnp attention has it): every row also sees the first
    ``prefix_len`` keys. Gradients reach q, k and v through
    ``flash_attention.flash_attention_bshd_bwd``."""
    return _fa.FlashAttention.apply(q, k, v, causal, window, prefix_len,
                                    blk_k)


def rwkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """r/k/v/w (BH,T,hd), u (BH,hd). Returns y (BH,T,hd) f32."""
    return _rc.rwkv_chunked(r, k, v, w, u, chunk=chunk)
