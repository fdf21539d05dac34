"""RWKV-6 (Finch) blocks: time-mix with data-dependent decay and
channel-mix (port of ``repro.models.rwkv``).

``time_mix`` scans token by token (the exact recurrence; the decode step
runs it on one token). ``time_mix_chunked`` computes the same WKV in
chunks through K7 (``kernels.rwkv_chunk.rwkv_chunked_bthd``): the kernel on
a CUDA tensor, its plain version on a CPU tensor; from the zero state
through the autograd Function ``RwkvChunk``, whose backward is PyTorch
operations. Parameters are indexed
by the reference's keys (``p["wr"]``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv_chunk as RC


def token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Shift by one along the sequence; x (B,S,D), x_prev (B,1,D)."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def time_mix_step(S, r, k, v, w, u):
    """One-token WKV update over any leading batch dims. S (...,hd,hd);
    r,k,v,w (...,hd); u broadcastable to (...,hd). Returns (S', y)."""
    a = k[..., :, None] * v[..., None, :]
    y = torch.einsum("...d,...de->...e", r, S + u[..., :, None] * a)
    return w[..., :, None] * S + a, y


def _rkvwg(x, x_prev, p):
    xs = token_shift(x, x_prev)
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mu_{c}"]) for c in "rkvwg")
    r = (xr @ p["wr"]).float()
    k = (xk @ p["wk"]).float()
    v = (xv @ p["wv"]).float()
    g = F.silu(xg @ p["wg"])
    wln = p["w0"] + torch.tanh(xw.float() @ p["wa"]) @ p["wb"]
    w = torch.exp(-torch.exp(wln.float()))
    return r, k, v, w, g


def _out(y, g, x, p, n_heads, head_dim):
    """Per-head group norm, gate and output projection."""
    B, S, D = x.shape
    yh = y.reshape(B, S, n_heads, head_dim)
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mean) * torch.rsqrt(var + 64e-5)
    y = (yh.reshape(B, S, D) * p["ln_w"] + p["ln_b"]).to(x.dtype)
    return (y * g).to(x.dtype) @ p["wo"]


def time_mix(x: torch.Tensor, x_prev: torch.Tensor, S0: torch.Tensor, p,
             n_heads: int, head_dim: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RWKV6 time-mix, token scan. x (B,S,D); S0 (B,H,hd,hd). Returns
    (y, S_out, x_last)."""
    B, S, D = x.shape
    r, k, v, w, g = _rkvwg(x, x_prev, p)
    hs = (B, S, n_heads, head_dim)
    r, k, v, w = (t.reshape(hs) for t in (r, k, v, w))
    u = p["u"].reshape(n_heads, head_dim).float()
    Sc = S0.float()
    ys = []
    for t in range(S):
        Sc, yt = time_mix_step(Sc, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(yt)
    y = torch.stack(ys, dim=1).reshape(B, S, D)
    return _out(y, g, x, p, n_heads, head_dim), Sc, x[:, -1:]


def time_mix_chunked(x: torch.Tensor, x_prev: torch.Tensor,
                     S0: Optional[torch.Tensor], p, n_heads: int,
                     head_dim: int, chunk: int = 128,
                     return_state: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                torch.Tensor]:
    """The same time-mix with the WKV in chunks (K7), when ``S > chunk``
    and ``chunk`` divides S; the token scan otherwise, as the reference.
    ``S0`` None is the zero state. On a CUDA tensor the chunked WKV runs
    K7, which starts from zero (a state tensor raises) and, with
    ``return_state``, writes the final state it holds as ``S_out``;
    without it the chunked branch returns ``S_out`` None (the prefill
    discards the state). From the zero state the chunked WKV is
    differentiable (``RwkvChunk``)."""
    B, S, D = x.shape
    H, hd = n_heads, head_dim
    if S % chunk or S <= chunk:
        if S0 is None:
            S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=x.device)
        return time_mix(x, x_prev, S0, p, H, hd)
    r, k, v, w, g = _rkvwg(x, x_prev, p)
    hs = (B, S, H, hd)
    rkvw = (r.reshape(hs), k.reshape(hs), v.reshape(hs), w.reshape(hs))
    u = p["u"].reshape(H, hd).float()
    if S0 is None:
        y, S_out = RC.RwkvChunk.apply(*rkvw, u, chunk)
    else:
        y, S_out = RC.rwkv_chunked_bthd(*rkvw, u, chunk=chunk, S0=S0,
                                        return_state=True)
    if not return_state:
        S_out = None
    return _out(y.reshape(B, S, D), g, x, p, H, hd), S_out, x[:, -1:]


def channel_mix(x: torch.Tensor, x_prev: torch.Tensor, p
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    xs = token_shift(x, x_prev)
    xk = _mix(x, xs, p["mu_ck"])
    xr = _mix(x, xs, p["mu_cr"])
    k = torch.square(torch.relu(xk @ p["ck"]))
    r = torch.sigmoid(xr @ p["cr"])
    return r * (k @ p["cv"]), x[:, -1:]
