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

The gradient: :class:`RwkvChunk` is K7 as an autograd Function (from the
zero state; y and the final state), its backward
:func:`rwkv_chunked_bthd_bwd`: on a CUDA tensor the K7 backward kernel
(``csrc/rwkv_chunk_bwd.cu``: the chunks' state increments, the two chains
over the chunks, then the gradients of each chunk, a persistent CTA per
SM walking the chunks with dr, dk and dv finished in registers and
nothing staged in device memory; counted once per call in
``rwkv_chunked_bthd_bwd.launches``), on a CPU tensor its plain version
:func:`rwkv_chunked_bthd_bwd_ref`, PyTorch operations in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch import no_tf32
from repro_torch.kernels import check, library, require, stream_ptr
from repro_torch.roofline import work as W

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
    ``return_state``. On CUDA: f32, r/k/v/w contiguous, S0 None. On the
    ``meta`` device the same checks, then empty outputs, and K7's work
    (``roofline.work.rwkv_flops``) goes to the open work counter in
    place of a launch (not counted in ``launches``)."""
    B, T, H, hd = r.shape
    C = _chunk(T, chunk)
    u_in, u = u, u.expand(B, H, hd)
    if not r.is_cuda and not r.is_meta:
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
    if r.is_meta:
        W.record("rwkv_chunked", W.rwkv_flops(B * H, T, hd), W.nbytes(
            r, k, v, w, u_in, y, S if return_state else None))
        return (y, S) if return_state else y
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
    if not r.is_cuda and not r.is_meta:
        return rwkv_chunked_ref(r, k, v, w, u, chunk=chunk)
    return rwkv_chunked_bthd(r[:, :, None], k[:, :, None], v[:, :, None],
                             w[:, :, None], u[:, None], chunk=chunk)[:, :, 0]


def rwkv_chunked_bthd_bwd_ref(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, w: torch.Tensor,
                              u: torch.Tensor, gy: torch.Tensor,
                              gS: Optional[torch.Tensor] = None, *,
                              chunk: int = 128):
    """Plain version of K7's backward: dr, dk, dv, dw and du of ``(y,
    S_T) = rwkv_chunked_bthd(r, k, v, w, u, return_state=True)`` (from the
    zero state) for the output gradients
    gy (B,T,H,hd) and gS (B,H,hd,hd) or None, in PyTorch operations in f32
    (TF32 off) on any device; du in ``u``'s shape ((H,hd): summed over the
    batch), the others (B,T,H,hd).

    K7 keeps only the final state, so the chunk-start states are
    recomputed from the inputs (the chunk's state increments at once, then
    the chain in chunk order). The state's gradient is chained back chunk
    by chunk (``G_c = rP_c^T gy_c + exp(total_c) G_{c+1}``); every other
    term is batched over the chunks::

        dA = mask(gy v^T),   dv = A^T gy + diag gy + kT G
        d(rP) = gy S^T + dA kD,   d(kD) = dA^T rP,   d(kT) = v G^T

    then through ``rP = r exp(cum - logw)``, ``kD = k exp(-cum)``, ``kT =
    k exp(total - cum)``, ``total = cum[-1]`` and ``cum = cumsum(logw)``
    (the exponentials are the forward's own, formed from the same
    differences; the last token's ``exp(-cum)``, which no pair uses, is
    taken as 0, so that where it overflows the forward stays finite and
    the backward makes no NaN). dw is the gradient of ``log(max(w, 1e-38))``: ``dlogw /
    w`` where ``w > 1e-38`` and 0 elsewhere, where the clamp stops it."""
    no_tf32()
    B, T, H, hd = r.shape
    C = _chunk(T, chunk)
    nc = T // C
    dev = r.device
    with record_function("rwkv_chunk.bwd"):
        def chunks(t):      # (B,T,H,hd) -> (B,H,nc,C,hd) f32
            return t.float().permute(0, 2, 1, 3).reshape(B, H, nc, C, hd)
        r_, k_, v_, w_, gy_ = (chunks(t) for t in (r, k, v, w, gy))
        uf = u.float().expand(B, H, hd)[:, :, None, None, :]
        logw = torch.log(torch.clamp(w_, min=1e-38))
        cum = torch.cumsum(logw, dim=3)
        P = torch.exp(cum - logw)
        # the last token's k exp(-cum) pairs with no later token (its
        # column of A is masked): zero, so that an exp(-cum) that
        # overflows there (a w under the clamp) makes no 0 x inf
        E = torch.exp(-cum)
        E[..., -1, :] = 0.0
        rP, kD = r_ * P, k_ * E
        tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev),
                         -1)
        A = torch.where(tri, torch.matmul(rP, kD.transpose(-1, -2)), 0.0)
        total = cum[..., -1, :]                             # (B,H,nc,hd)
        F = torch.exp(total[..., None, :] - cum)
        kT = k_ * F
        decay = torch.exp(total)[..., None]                 # (B,H,nc,hd,1)
        # the state entering each chunk, and the gradient of the state
        # leaving it
        dS = torch.matmul(kT.transpose(-1, -2), v_)         # (B,H,nc,hd,hd)
        S = torch.empty_like(dS)
        s = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
        for c in range(nc):
            S[:, :, c] = s
            s = decay[:, :, c] * s + dS[:, :, c]
        Ry = torch.matmul(rP.transpose(-1, -2), gy_)
        G = dS
        g = s.zero_() if gS is None else gS.float()
        for c in reversed(range(nc)):
            G[:, :, c] = g
            g = Ry[:, :, c] + decay[:, :, c] * g
        del Ry, s, g
        dA = torch.where(tri, torch.matmul(gy_, v_.transpose(-1, -2)), 0.0)
        ddiag = (gy_ * v_).sum(-1, keepdim=True)            # (B,H,nc,C,1)
        diag = (r_ * uf * k_).sum(-1, keepdim=True)
        dv = torch.matmul(A.transpose(-1, -2), gy_) + diag * gy_ \
            + torch.matmul(kT, G)
        del A
        d_rP = torch.matmul(gy_, S.transpose(-1, -2)) + torch.matmul(dA, kD)
        d_kD = torch.matmul(dA.transpose(-1, -2), rP)
        d_kT = torch.matmul(v_, G.transpose(-1, -2))
        d_total = (decay[..., 0] * (S * G).sum(-1))         # (B,H,nc,hd)
        del dA, S, G
        dr = d_rP * P + ddiag * uf * k_
        dk = d_kD * E + d_kT * F + ddiag * uf * r_
        du = (ddiag * r_ * k_).sum((2, 3))                   # (B,H,hd)
        gP = d_rP * r_ * P
        gE = d_kD * k_ * E
        gF = d_kT * k_ * F
        d_total = d_total + gF.sum(3)
        dcum = gP - gE - gF
        dcum[..., -1, :] += d_total
        dlogw = torch.flip(torch.cumsum(torch.flip(dcum, (3,)), 3), (3,)) \
            - gP
        dw = torch.where(w_ > 1e-38, dlogw / w_, 0.0)

        def back(t):        # (B,H,nc,C,hd) -> (B,T,H,hd)
            return t.reshape(B, H, T, hd).permute(0, 2, 1, 3).contiguous()
        if u.dim() == 2:
            du = du.sum(0)
        return back(dr), back(dk), back(dv), back(dw), du


def _bwd_operands(r, k, v, w, u, gy, gS):
    """The checks of the backward's operands on the card (and on ``meta``):
    r, k, v, w, gy f32 contiguous (B,T,H,hd), u f32 (H,hd) or (B,H,hd)
    with unit stride on the head dim, gS None or f32 contiguous
    (B,H,hd,hd)."""
    B, T, H, hd = r.shape
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("gy", gy)):
        require(t, name, _F32, (B, T, H, hd), dev)
    if u.dtype != _F32 or u.device != dev or u.dim() not in (2, 3) \
            or tuple(u.shape[-2:]) != (H, hd) \
            or (u.dim() == 3 and u.shape[0] != B) or u.stride(-1) != 1:
        raise ValueError(f"u: {tuple(u.shape)} {u.dtype} on {u.device}, "
                         f"expected f32 ({H}, {hd}) or ({B}, {H}, {hd}) "
                         f"with unit stride on the head dim")
    if gS is not None:
        require(gS, "gS", _F32, (B, H, hd, hd), dev)


def _bwd_launch(r, k, v, w, u, gy, gS, C):
    """One call of the K7 backward kernel (three launches on the current
    stream) on checked operands; u is (H,hd) or (B,H,hd). Returns dr, dk,
    dv, dw (B,T,H,hd) and du in u's shape (each chunk's part summed by
    torch in a fixed order)."""
    B, T, H, hd = r.shape
    nc = T // C
    ue = u.expand(B, H, hd)
    dev = r.device
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((B, H, nc, hd), dtype=_F32, device=dev)
    # S_{c-1} over the chunks' increments and G_c over rP^T gy; exp(total)
    # and d_total's state term of every chunk
    states = torch.empty((2, B * H * nc, hd, hd), dtype=_F32, device=dev)
    vecs = torch.empty((2, B * H * nc, hd), dtype=_F32, device=dev)
    code = library().rwkv_chunk_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        ue.data_ptr(), gy.data_ptr(),
        None if gS is None else gS.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        states[0].data_ptr(), states[1].data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), B, T, H, hd, C, ue.stride(0), ue.stride(1),
        stream_ptr(r))
    if code == _TOO_LARGE:
        raise ValueError(f"a chunk of {C} tokens x head dim {hd} needs more "
                         "shared memory than one CTA has (K7 and its "
                         "backward hold 128 tokens, 64 at head dim 128): use "
                         "a smaller chunk")
    if code == _BAD_HEAD_DIM:
        raise ValueError(f"K7's backward has kernels for head dims 16, 32, "
                         f"64 and 128, not {hd}")
    check(code, "rwkv_chunked_bwd")
    rwkv_chunked_bthd_bwd.launches += 1
    du = du.sum(2)
    return dr, dk, dv, dw, du.sum(0) if u.dim() == 2 else du


def rwkv_chunked_bthd_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor,
                          gS: Optional[torch.Tensor] = None, *,
                          chunk: int = 128):
    """dr, dk, dv, dw and du of ``(y, S_T) = rwkv_chunked_bthd(r, k, v, w,
    u, return_state=True)`` (from the zero state) for the output gradients
    gy (B,T,H,hd) and gS (B,H,hd,hd) or None (zero); du in ``u``'s shape,
    the others (B,T,H,hd), f32. On a CUDA tensor the K7 backward kernel
    (``csrc/rwkv_chunk_bwd.cu``; r, k, v, w, gy f32 contiguous, gS None or
    f32 contiguous), the same layouts as K7's forward (head dims 16, 32, 64
    and 128; chunks up to 128 tokens, 64 at head dim 128; any other
    raises before a launch). On a CPU tensor
    :func:`rwkv_chunked_bthd_bwd_ref`. On the ``meta`` device the same
    checks, then empty gradients, and the backward's work
    (``roofline.work.rwkv_bwd_flops``) goes to the open work counter in
    place of a launch (not counted in ``launches``)."""
    if not r.is_cuda and not r.is_meta:
        return rwkv_chunked_bthd_bwd_ref(r, k, v, w, u, gy, gS, chunk=chunk)
    B, T, H, hd = r.shape
    C = _chunk(T, chunk)
    _bwd_operands(r, k, v, w, u, gy, gS)
    if r.is_meta:
        grads = (*(torch.empty_like(r) for _ in range(4)),
                 torch.empty_like(u))
        W.record("rwkv_chunked_bwd", W.rwkv_bwd_flops(B * H, T, hd),
                 W.nbytes(r, k, v, w, u, gy, gS, *grads))
        return grads
    with record_function("rwkv_chunk.bwd"):
        return _bwd_launch(r, k, v, w, u, gy, gS, C)


rwkv_chunked_bthd_bwd.launches = 0


class RwkvChunk(torch.autograd.Function):
    """K7 with a gradient, from the zero state: the forward is
    :func:`rwkv_chunked_bthd` with ``return_state`` (the kernel on a CUDA
    tensor, its plain version on a CPU tensor), returning (y, S_T); the
    backward :func:`rwkv_chunked_bthd_bwd`. r, k, v, w and u are saved
    only where an input needs a gradient, so a forward over frozen
    weights (serving) saves nothing. Under a non-reentrant checkpoint the
    recompute launches K7 again and saves its own tensors."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        y, S = rwkv_chunked_bthd(r, k, v, w, u, chunk=chunk,
                                 return_state=True)
        ctx.chunk = chunk
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(r, k, v, w, u)
        return y, S

    @staticmethod
    def backward(ctx, gy, gS):
        grads = rwkv_chunked_bthd_bwd(
            *ctx.saved_tensors, gy.contiguous(),
            None if gS is None else gS.contiguous(), chunk=ctx.chunk)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)
