"""The selective scan of the hybrid family's mamba heads, K8
(``csrc/ssm_scan.cu``).

Replaces no TPU kernel: the reference computes the scan as a sequential
``lax.scan`` over the tokens (``repro/models/ssm.py:16 ssm_scan``), which
eager PyTorch would run as a few small launches per token. Per (batch,
head, head-dim channel) and token, with the state h (B,H,hd,N)::

    decay = exp(dt A),   dBx = (dt x) B_
    h = h decay + dBx,   y = sum_n h C_

:func:`ssm_scan_ref` is the plain PyTorch version (the reference's step,
a Python loop over the tokens) on any device. On a CUDA tensor
:func:`ssm_scan` launches K8 on the current stream (counted once per call
in ``ssm_scan.launches``): three launches over chunks of ``FWD_CHUNK``
tokens, parallel over (batch, head, chunk): each chunk's decay product
and its state walked from zero, those chained over the chunks from h0,
then each chunk's tokens walked from the state entering it, y written
and, by the last chunk, h_out. One thread per channel holds its N states
(two at head dim 16); the chunk's operands are staged in shared memory.
At S <= ``FWD_CHUNK`` only the last launch runs, from h0. On a CPU tensor
it runs the plain version.

The gradient: :class:`SsmScan` is K8 as an autograd Function, its
backward :func:`ssm_scan_bwd`, the K8 backward kernel
(``csrc/ssm_scan_bwd.cu``: three launches over chunks of ``BWD_CHUNK``
tokens, parallel over (batch, head, chunk): each chunk's decay product
and its state and carried-gradient increments, the two chains over the
chunks, then each chunk's gradients walked in reverse; counted once per
call in ``ssm_scan_bwd.launches``) on a CUDA tensor and
:func:`ssm_scan_bwd_ref`, the reverse scan in PyTorch operations, on a
CPU tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import check, library, require, stream_ptr
from repro_torch.roofline import work as W

_F32 = torch.float32
# head dims and state sizes K8 is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
STATE_SIZES = (8, 16)
# tokens per chunk of the forward kernel (its kChunk): the scratch holds
# one state per chunk but the last
FWD_CHUNK = 64
# tokens per chunk of the backward kernel (its kChunk): the chain arrays
# hold one state and one carried gradient per chunk
BWD_CHUNK = 32


def ssm_scan_ref(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8 in f32. xh (B,S,H,hd), dt (B,S,H), B_/C_
    (B,S,N), A (H,), h0 (B,H,hd,N). Returns y (B,S,H,hd) and h_out."""
    xh, dt, B_, C_, A = (t.float() for t in (xh, dt, B_, C_, A))
    h = h0.float()
    ys = []
    for t in range(xh.shape[1]):
        dtt = dt[:, t]
        decay = torch.exp(dtt * A[None])
        dBx = dtt[..., None, None] * xh[:, t, ..., None] \
            * B_[:, t, None, None, :]
        h = h * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhdn,bn->bhd", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


def ssm_scan(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shapes as :func:`ssm_scan_ref`. Returns y (B,S,H,hd) f32 and h_out
    (B,H,hd,N) f32. On CUDA: every operand f32 and contiguous, hd in
    ``HEAD_DIMS``, N in ``STATE_SIZES``. On the ``meta`` device the same
    checks, then empty outputs, and K8's work
    (``roofline.work.scan_flops``) goes to the open work counter in
    place of a launch (not counted in ``launches``)."""
    if not xh.is_cuda and not xh.is_meta:
        return ssm_scan_ref(xh, dt, B_, C_, A, h0)
    B, S, H, hd = xh.shape
    N = B_.shape[-1]
    if hd not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(f"K8 has kernels for head dims {HEAD_DIMS} and "
                         f"state sizes {STATE_SIZES}, not hd {hd}, N {N}")
    dev = xh.device
    for name, t, shape in (("xh", xh, (B, S, H, hd)), ("dt", dt, (B, S, H)),
                           ("B_", B_, (B, S, N)), ("C_", C_, (B, S, N)),
                           ("A", A, (H,)), ("h0", h0, (B, H, hd, N))):
        require(t, name, _F32, shape, dev)
    if xh.is_meta:
        y, h_out = torch.empty_like(xh), torch.empty_like(h0)
        W.record("ssm_scan", W.scan_flops(B, S, H, hd, N),
                 W.nbytes(xh, dt, B_, C_, A, h0, y, h_out))
        return y, h_out
    for name, t in (("xh", xh), ("B_", B_), ("C_", C_)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K8 reads it in 16-byte vectors; its "
                             f"storage must start 16-byte aligned")
    y = torch.empty_like(xh)
    h_out = torch.empty_like(h0)
    # each chunk's increments, then the state entering it (none at S <=
    # FWD_CHUNK)
    nk = -(-S // FWD_CHUNK) - 1
    hs = dprod = None
    if nk:
        hs = torch.empty((B * H, nk, hd, N), dtype=_F32, device=dev)
        dprod = torch.empty((B * H, nk), dtype=_F32, device=dev)
    code = library().ssm_scan_launch(
        xh.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        A.data_ptr(), h0.data_ptr(), None if hs is None else hs.data_ptr(),
        None if dprod is None else dprod.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), B, S, H, hd, N, stream_ptr(xh))
    check(code, "ssm_scan")
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0


def ssm_scan_bwd_ref(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                     C_: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                     gy: torch.Tensor, g_hout: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K8's backward in f32, on any device: the gradients
    (dxh, ddt, dB_, dC_, dA, dh0) of :func:`ssm_scan_ref`'s (y, h_out) for
    the output gradients gy (B,S,H,hd) and g_hout (B,H,hd,N). The forward's
    states are recomputed and kept, then the tokens are walked in reverse
    with the carried gradient g (g_hout before the last token)::

        gh = g + C_t gy_t,   dx_t = dt_t sum_n gh B_t
        dC_t = sum_{h,d} h_t gy_t,   dB_t = sum_{h,d} gh dt_t x_t
        ddt_t = sum_{d,n} gh (x_t B_t + A a_t h_{t-1})
        dA += sum_{b,d,n} gh a_t dt_t h_{t-1},   g = a_t gh

    with a_t = exp(dt_t A); dh0 is the last g."""
    xh, dt, B_, C_, A, gy = (t.float() for t in (xh, dt, B_, C_, A, gy))
    decay = torch.exp(dt * A)                               # (B,S,H)
    hs = [h0.float()]
    for t in range(xh.shape[1]):
        dBx = dt[:, t, :, None, None] * xh[:, t, ..., None] \
            * B_[:, t, None, None, :]
        hs.append(hs[-1] * decay[:, t, :, None, None] + dBx)
    g = g_hout.float()
    dA = torch.zeros_like(A)
    dxs, ddts, dBs, dCs = [], [], [], []
    for t in reversed(range(xh.shape[1])):
        gh = g + C_[:, t, None, None, :] * gy[:, t, ..., None]
        dCs.append(torch.einsum("bhdn,bhd->bn", hs[t + 1], gy[:, t]))
        sB = torch.einsum("bhdn,bn->bhd", gh, B_[:, t])
        sH = (gh * hs[t]).sum(-1).sum(-1)                    # (B,H)
        dxs.append(dt[:, t, :, None] * sB)
        dBs.append(torch.einsum("bhdn,bhd->bn", gh,
                                dt[:, t, :, None] * xh[:, t]))
        ddts.append((xh[:, t] * sB).sum(-1) + A * decay[:, t] * sH)
        dA = dA + (decay[:, t] * dt[:, t] * sH).sum(0)
        g = gh * decay[:, t, :, None, None]

    def stack(ts):
        return torch.stack(ts[::-1], dim=1)
    return stack(dxs), stack(ddts), stack(dBs), stack(dCs), dA, g


def ssm_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                 gy: torch.Tensor, g_hout: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """(dxh, ddt, dB_, dC_, dA, dh0), f32, as :func:`ssm_scan_bwd_ref`.
    On a CUDA tensor one call of the K8 backward kernel (its three
    launches, counted once): every operand f32 and contiguous, hd in
    ``HEAD_DIMS``, N in ``STATE_SIZES``, xh, gy, B_ and C_ 16-byte
    aligned; it writes dB_ and dC_ per head and dA per (batch row,
    chunk), which are then summed (torch's reductions, in a fixed
    order). On a CPU tensor the plain version. On the ``meta`` device
    the same checks, then empty gradients, and the backward's work
    (``roofline.work.scan_bwd_flops``) goes to the open work counter in
    place of a launch (not counted in ``launches``)."""
    if not xh.is_cuda and not xh.is_meta:
        return ssm_scan_bwd_ref(xh, dt, B_, C_, A, h0, gy, g_hout)
    B, S, H, hd = xh.shape
    N = B_.shape[-1]
    if hd not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(f"K8 has kernels for head dims {HEAD_DIMS} and "
                         f"state sizes {STATE_SIZES}, not hd {hd}, N {N}")
    dev = xh.device
    for name, t, shape in (("xh", xh, (B, S, H, hd)), ("dt", dt, (B, S, H)),
                           ("B_", B_, (B, S, N)), ("C_", C_, (B, S, N)),
                           ("A", A, (H,)), ("h0", h0, (B, H, hd, N)),
                           ("gy", gy, (B, S, H, hd)),
                           ("g_hout", g_hout, (B, H, hd, N))):
        require(t, name, _F32, shape, dev)
    if xh.is_meta:
        grads = tuple(torch.empty_like(t) for t in (xh, dt, B_, C_, A, h0))
        W.record("ssm_scan_bwd", W.scan_bwd_flops(B, S, H, hd, N),
                 W.nbytes(xh, dt, B_, C_, A, h0, gy, g_hout, *grads))
        return grads
    for name, t in (("xh", xh), ("gy", gy), ("B_", B_), ("C_", C_)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K8's backward copies it in 16-byte "
                             f"pieces; its storage must start 16-byte "
                             f"aligned")
    nc = -(-S // BWD_CHUNK)
    hs = torch.empty((B * H, nc, hd, N), dtype=_F32, device=dev)
    gs = torch.empty_like(hs)
    dprod = torch.empty((B * H, nc), dtype=_F32, device=dev)
    dx, ddt, dh0 = (torch.empty_like(t) for t in (xh, dt, h0))
    dB_part = torch.empty((B, S, H, N), dtype=_F32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((B, H, nc), dtype=_F32, device=dev)
    code = library().ssm_scan_bwd_launch(
        xh.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        A.data_ptr(), h0.data_ptr(), gy.data_ptr(), g_hout.data_ptr(),
        hs.data_ptr(), gs.data_ptr(), dprod.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
        dA_part.data_ptr(), dh0.data_ptr(), B, S, H, hd, N, stream_ptr(xh))
    check(code, "ssm_scan_bwd")
    ssm_scan_bwd.launches += 1
    return (dx, ddt, dB_part.sum(2), dC_part.sum(2), dA_part.sum((0, 2)),
            dh0)


ssm_scan_bwd.launches = 0


class SsmScan(torch.autograd.Function):
    """K8 with a gradient: the forward is :func:`ssm_scan` (the kernel on
    a CUDA tensor, its plain version on a CPU tensor), the backward
    :func:`ssm_scan_bwd`. The operands are saved only where an input needs
    a gradient, so a forward over frozen weights (serving) saves nothing
    and launches nothing more. Under a non-reentrant checkpoint the
    recompute launches K8 again and saves its own operands."""

    @staticmethod
    def forward(ctx, xh, dt, B_, C_, A, h0):
        y, h_out = ssm_scan(xh, dt, B_, C_, A, h0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(xh, dt, B_, C_, A, h0)
        return y, h_out

    @staticmethod
    def backward(ctx, gy, g_hout):
        grads = ssm_scan_bwd(*ctx.saved_tensors, gy.float().contiguous(),
                             g_hout.float().contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
