"""Mamba-style selective SSM head of the hymba hybrid arch (port of
``repro.models.ssm``).

Per-head scalar decay A, data-dependent dt/B/C, a causal depthwise conv
in front. ``ssm_scan`` runs K8 (``kernels.ssm_scan``) on a CUDA tensor and
its plain version, the reference's token loop, on a CPU tensor, through
the autograd Function ``SsmScan`` (its backward the K8 backward kernel,
or its plain version on a CPU tensor); the prefill scans the whole prompt
and a decode step one token. Parameters
are indexed by the reference's keys (``p["w_in"]``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, no_tf32, resolve_device
from repro_torch.kernels import ssm_scan as SS


def ssm_scan(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan. xh (B,S,H,hd), dt (B,S,H), B_/C_ (B,S,N), A (H,)
    negative, h0 (B,H,hd,N); every operand taken in f32. Returns y
    (B,S,H,hd) and h_out, both f32; differentiable (K8's Function),
    the gradients carried back to each operand's dtype."""
    return SS.SsmScan.apply(*(t.float().contiguous()
                              for t in (xh, dt, B_, C_, A, h0)))


def depthwise_conv(x: torch.Tensor, kernel: torch.Tensor,
                   carry: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv. x (B,S,Di), kernel (K,Di), carry (B,K-1,Di).
    The K shifted products summed in order, as the reference's ``sum``.
    Returns (out, the last K-1 inputs as the next carry)."""
    K, S = kernel.shape[0], x.shape[1]
    xp = torch.cat([carry, x], dim=1)  # (B, S+K-1, Di)
    out = xp[:, 0:S] * kernel[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * kernel[i]
    return out, xp[:, -(K - 1):]


def mamba_head(x: torch.Tensor, p, state: Dict[str, torch.Tensor],
               head_dim: int, n_state: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,D) -> (y (B,S,D), new state). state: {'h': (B,H,hd,N) f32,
    'conv': (B,K-1,Di)}. The products in x's dtype, dt (TF32 off) and the
    skip term in f32."""
    no_tf32()
    B, S, _ = x.shape
    xz = x @ p["w_in"]  # (B,S,2*Di)
    Di = xz.shape[-1] // 2
    xi, z = xz[..., :Di], xz[..., Di:]
    xi, conv_carry = depthwise_conv(xi, p["conv_k"], state["conv"])
    xi = F.silu(xi)
    H = Di // head_dim
    dt = F.softplus(xi.float() @ p["w_dt"] + p["dt_bias"])  # (B,S,H)
    B_ = xi @ p["w_b"]  # (B,S,N)
    C_ = xi @ p["w_c"]
    A = -torch.exp(p["a_log"].float())  # (H,)
    xh = xi.reshape(B, S, H, head_dim)
    y, h_out = ssm_scan(xh, dt, B_, C_, A, state["h"])
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, Di).to(x.dtype) * F.silu(z)
    return y @ p["w_out"], {"h": h_out, "conv": conv_carry}


def init_mamba_state(batch: int, d_inner: int, head_dim: int, n_state: int,
                     conv_width: int, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = "cuda"
                     ) -> Dict[str, torch.Tensor]:
    """A zero state: ``h`` (B,H,hd,N) in f32, ``conv`` (B,K-1,Di) in
    ``dtype``."""
    device = resolve_device(device)
    return {
        "h": torch.zeros((batch, d_inner // head_dim, head_dim, n_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                            device=device),
    }
