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
:func:`ssm_scan` launches K8 on the current stream (one kernel, counted
in ``ssm_scan.launches``): one CTA per (batch, head), one thread per
channel holding its N states (two at head dim 16), tiles of tokens staged
in shared memory.
On a CPU tensor it runs the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import check, library, require, stream_ptr

_F32 = torch.float32
# head dims and state sizes K8 is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
STATE_SIZES = (8, 16)


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
    ``HEAD_DIMS``, N in ``STATE_SIZES``."""
    if not xh.is_cuda:
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
    for name, t in (("xh", xh), ("B_", B_), ("C_", C_)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K8 reads it in 16-byte vectors; its "
                             f"storage must start 16-byte aligned")
    y = torch.empty_like(xh)
    h_out = torch.empty_like(h0)
    code = library().ssm_scan_launch(
        xh.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, S,
        H, hd, N, stream_ptr(xh))
    check(code, "ssm_scan")
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0
