"""The chunked RWKV6 WKV, K7 (``csrc/rwkv_chunk.cu``).

Replaces ``repro/kernels/rwkv_chunk.py``'s ``rwkv_chunked``
(``_rwkv_kernel``). For a chunk of C tokens with per-token decays w, in
log space (``cum`` the inclusive prefix of ``log(max(w, 1e-38))``)::

    rP = r exp(cum - logw),   kD = k exp(-cum)
    A[t, s] = rP_t . kD_s (s < t),   diag_t = sum (r u) k
    y = A v + diag v + rP S
    S <- exp(total) S + (k exp(total - cum))^T v

with the (hd, hd) state S carried over the chunks in order from zero.

:func:`rwkv_chunked_ref` is the plain PyTorch version of that math on any
device (batched over heads, a Python loop over chunks; it also takes a
start state). On a CUDA tensor :func:`rwkv_chunked_bthd` launches K7 on the
current stream (one memset and one kernel, counted once in
``rwkv_chunked_bthd.launches``), reading the (B,T,H,hd) layout the model
holds: persistent CTAs walk the (batch, head, chunk) tiles, each tile
chained to the next chunk through the state it publishes. It starts from
the zero state (passing a state raises) and, when asked, returns the
final state of that chain. On a CPU tensor it runs the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import check, library, require, stream_ptr

_F32 = torch.float32
# the C entry point's codes for a chunk one CTA cannot hold and for a head
# dim it has no kernel for (nothing is launched for either)
_TOO_LARGE, _BAD_HEAD_DIM = -1, -2


def _chunk(T: int, chunk: int) -> int:
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"length {T} is not a multiple of the chunk {C}")
    return C


def rwkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, *, chunk: int = 128,
                     S0: Optional[torch.Tensor] = None,
                     return_state: bool = False):
    """Plain version of K7. r/k/v/w (BH,T,hd); u (BH,hd); S0 (BH,hd,hd) or
    None for zero. Returns y (BH,T,hd) f32, and the final state when
    ``return_state``."""
    BH, T, hd = r.shape
    C = _chunk(T, chunk)
    S = (torch.zeros((BH, hd, hd), dtype=_F32, device=r.device)
         if S0 is None else S0.float())
    u = u.float()
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     -1)
    ys = []
    for c0 in range(0, T, C):
        rc, kc, vc, wc = (t[:, c0:c0 + C].float() for t in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=1e-38))
        cum = torch.cumsum(logw, dim=1)
        rP = rc * torch.exp(cum - logw)
        kD = kc * torch.exp(-cum)
        A = torch.where(tri, torch.matmul(rP, kD.transpose(1, 2)), 0.0)
        diag = (rc * u[:, None, :] * kc).sum(-1)
        y = torch.matmul(A, vc) + diag[..., None] * vc
        ys.append(y + torch.matmul(rP, S))
        total = cum[:, -1]
        kT = kc * torch.exp(total[:, None, :] - cum)
        S = torch.exp(total)[..., None] * S + torch.matmul(
            kT.transpose(1, 2), vc)
    y = torch.cat(ys, dim=1)
    return (y, S) if return_state else y


def rwkv_chunked_bthd_ref(r: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                          *, chunk: int = 128,
                          S0: Optional[torch.Tensor] = None,
                          return_state: bool = False):
    """Plain version of K7 on the (B,T,H,hd) layout, on any device (the
    arguments and results of :func:`rwkv_chunked_bthd`)."""
    B, T, H, hd = r.shape

    def bh(t):
        return t.transpose(1, 2).reshape(B * H, T, hd)
    out = rwkv_chunked_ref(
        bh(r), bh(k), bh(v), bh(w), u.expand(B, H, hd).reshape(B * H, hd),
        chunk=chunk, S0=None if S0 is None else S0.reshape(B * H, hd, hd),
        return_state=return_state)
    y, S = out if return_state else (out, None)
    y = y.reshape(B, H, T, hd).transpose(1, 2)
    return (y, S.reshape(B, H, hd, hd)) if return_state else y


def rwkv_chunked_bthd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, *, chunk: int = 128,
                      S0: Optional[torch.Tensor] = None,
                      return_state: bool = False):
    """r/k/v/w (B,T,H,hd); u (H,hd) or (B,H,hd); S0 (B,H,hd,hd) or None.
    Returns y (B,T,H,hd) f32, and the final state (B,H,hd,hd) when
    ``return_state``. On CUDA: f32, r/k/v/w contiguous, S0 None."""
    B, T, H, hd = r.shape
    C = _chunk(T, chunk)
    u = u.expand(B, H, hd)
    if not r.is_cuda:
        return rwkv_chunked_bthd_ref(r, k, v, w, u, chunk=chunk, S0=S0,
                                     return_state=return_state)
    if S0 is not None:
        raise ValueError("K7 starts from the zero state: pass S0=None")
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        require(t, name, _F32, (B, T, H, hd), dev)
    if u.dtype != _F32 or u.device != dev or tuple(u.shape) != (B, H, hd) \
            or u.stride(2) != 1:
        raise ValueError(f"u: {tuple(u.shape)} {u.dtype} on {u.device}, "
                         f"expected f32 ({H}, {hd}) or ({B}, {H}, {hd}) "
                         f"with unit stride on the head dim")
    y = torch.empty_like(r)
    # the state carried from chunk to chunk, the final state at the end;
    # work: the tiles' ticket and each (batch, head)'s count of published
    # state tiles (reset by the launch)
    S = torch.empty((B, H, hd, hd), dtype=_F32, device=dev)
    work = torch.empty(1 + B * H, dtype=torch.int32, device=dev)
    code = library().rwkv_chunk_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), y.data_ptr(), S.data_ptr(), work.data_ptr(),
        B, T, H, hd, C, u.stride(0), u.stride(1), stream_ptr(r))
    if code == _TOO_LARGE:
        raise ValueError(f"a chunk of {C} tokens x head dim {hd} needs more "
                         "shared memory than one CTA has (K7 holds 128 "
                         "tokens, 64 at head dim 128): use a smaller chunk")
    if code == _BAD_HEAD_DIM:
        raise ValueError(f"K7 has kernels for head dims 16, 32, 64 and 128, "
                         f"not {hd}")
    check(code, "rwkv_chunked")
    rwkv_chunked_bthd.launches += 1
    return (y, S) if return_state else y


rwkv_chunked_bthd.launches = 0


def rwkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """The reference's layout: r/k/v/w (BH,T,hd), u (BH,hd). Returns y
    (BH,T,hd) f32. K7 on a CUDA tensor, the plain version on a CPU
    tensor."""
    if not r.is_cuda:
        return rwkv_chunked_ref(r, k, v, w, u, chunk=chunk)
    return rwkv_chunked_bthd(r[:, :, None], k[:, :, None], v[:, :, None],
                             w[:, :, None], u[:, None], chunk=chunk)[:, :, 0]
