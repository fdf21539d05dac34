"""Flash attention, K6 (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py``'s ``flash_attention_bhsd``
(``_flash_kernel``) and, through :func:`flash_attention_bshd`, the GQA
expansion of ``repro/kernels/ops.py``'s ``flash_attention``: online
softmax over key blocks of ``blk_k`` with f32 running max, sum and
accumulator, causal and sliding-window masks, the fully-masked-row guard
and the final ``acc / max(l, 1e-20)`` in the query's dtype. It also takes
``prefix_len`` (prefix-LM: every row sees the first ``prefix_len`` keys,
the vision frontend's patch embeddings), which the reference computes in
jnp (``repro/models/layers.py:attention``) and not in its Pallas kernel;
the mask is the reference's ``(causal & window) | (col < prefix_len)``.

:func:`flash_attention_ref` is the plain PyTorch version, step for step
the Pallas kernel's (scale, mask to -1e30, ``m_new``, ``p`` zeroed where
masked, ``alpha = exp(max(m_prev - m_new, -80))``), over all query rows
at once: a row's result does not depend on ``blk_q``. ``blk_q`` stays in
every signature for the reference's, and neither version reads it: K6
tiles its own query rows per CTA (64 in f32, 128 in bf16). ``blk_k`` sets
the key blocks the online softmax walks, and S must be a multiple of
``min(blk_k, S)``.

On a CUDA tensor :func:`flash_attention_bshd` launches K6 on the current
stream (counted in ``flash_attention_bshd.launches``): it reads q as
(B,S,H,hd) and K/V by KV head ``h // (H // Hkv)``, so the GQA expansion
is never materialised. bf16 (the served dtype) runs on the tensor cores
(``wgmma``, K/V staged by TMA); both products take bf16 operands with f32
sums, and p is split into two bf16 terms, ``p_hi + p_lo``, so the p V
product keeps p to 2^-17 where one bf16 rounding would keep 2^-9 (the
reference's Pallas kernel and the plain version keep p in f32). f32 runs
on the CUDA cores in f32 (the tensor cores would take it only as TF32).
Head dims 16, 32, 64, 96, 128 and 256; at 256 the bf16 kernel's K ring
holds two 64-key sub-tiles, so a key block is at most 128 keys there.
On a CPU tensor it runs the plain version on the reference's expanded
(B*H,S,hd) layout.

With ``return_lse`` both versions also return each row's log-sum-exp
``m + log(l)`` of its scaled scores, (B,H,S) f32 (+inf for a row that
keeps no key): the backward's ``p = exp(s - lse)``.

:class:`FlashAttention` makes K6 differentiable. The reference has no
backward kernel (no ``custom_vjp``): its training differentiates the jnp
attention with XLA. The port's backward is its own kernel,
:func:`flash_attention_bshd_bwd` (``csrc/flash_attention_bwd.cu``): dq,
dk and dv from the log-sum-exp the forward saved, bf16 on the tensor
cores (``wgmma`` with TMA-fed rings up to head dim 128, ``mma.sync`` at
256), f32 on the CUDA cores, no atomics (bit for bit from run to run). Its plain version, :func:`flash_attention_bshd_bwd_ref`,
computes the same key block by key block in f32 PyTorch operations, as
XLA's transpose does.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.kernels import check, library, require, stream_ptr
from repro_torch.roofline import work as W

NEG_INF = -1e30
# head dims the kernel is instantiated for, and the largest key block
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
MAX_BLK_K = 256
# the largest key block of the bf16 kernel at a head dim where its K ring
# holds fewer than MAX_BLK_K keys (two 64-key sub-tiles at 256)
RING_BLK_K = {256: 128}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's key block: it holds one (B, H, rows, BWD_BLK_K) f32 tile
# of scores at a time (two with dp), never (S x S). At musicgen-medium's
# training layout (B 4, 24 heads, S 4096) a tile is 403 MB; under a
# causal mask the rows above a block are skipped, and the diagonal
# blocks' masked halves cost 1/(S/BWD_BLK_K + 1) of the work: 6% at 256,
# 11% at 512 (805 MB a tile)
BWD_BLK_K = 256


def _key_block(S: int, blk_k: int) -> int:
    blk_k = min(blk_k, S)
    if S % blk_k:
        raise ValueError(f"sequence {S} is not a multiple of the key block "
                         f"{blk_k}")
    return blk_k


def _check_prefix(S: int, prefix_len: int) -> None:
    if not 0 <= prefix_len <= S:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {S}]")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        prefix_len: int = 0, blk_q: int = 128,
                        blk_k: int = 128, return_lse: bool = False):
    """Plain version of K6 on any device. q/k/v (BH,S,hd), k/v already
    expanded to q's heads. Returns (BH,S,hd) in q's dtype; with
    ``return_lse`` also each row's ``m + log(max(l, 1e-20))``, (BH,S)
    f32, +inf where the row keeps no key (l = 0), as K6 writes it."""
    BH, S, hd = q.shape
    blk_k = _key_block(S, blk_k)
    _check_prefix(S, prefix_len)
    scale = 1.0 / (hd ** 0.5)
    qf = q.float()
    m = torch.full((BH, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, S, hd), dtype=torch.float32, device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for j in range(S // blk_k):
        kj = k[:, j * blk_k:(j + 1) * blk_k].float()
        vj = v[:, j * blk_k:(j + 1) * blk_k].float()
        s = torch.matmul(qf, kj.transpose(1, 2)) * scale   # (BH,S,blk_k)
        cols = j * blk_k + torch.arange(blk_k, device=q.device)[None, :]
        mask = torch.ones((S, blk_k), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (cols <= rows)
        if window > 0:
            mask = mask & (cols > rows - window)
        if prefix_len:
            mask = mask | (cols < prefix_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vj)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-20)),
                            math.inf)


def flash_attention_bshd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, prefix_len: int = 0,
                             blk_q: int = 128, blk_k: int = 128,
                             return_lse: bool = False):
    """Plain version of K6 on the (B,S,H,hd) layout, on any device: the
    reference's GQA expansion to (B*H,S,hd), then
    :func:`flash_attention_ref`; with ``return_lse`` also the rows'
    log-sum-exp, (B,H,S) f32."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]

    def bh(t):
        return t.transpose(1, 2).repeat_interleave(rep, 1).reshape(
            B * H, S, hd)
    out = flash_attention_ref(q.transpose(1, 2).reshape(B * H, S, hd),
                              bh(k), bh(v), causal=causal, window=window,
                              prefix_len=prefix_len, blk_q=blk_q,
                              blk_k=blk_k, return_lse=return_lse)
    if not return_lse:
        return out.reshape(B, H, S, hd).transpose(1, 2)
    out, lse = out
    return out.reshape(B, H, S, hd).transpose(1, 2), lse.reshape(B, H, S)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, blk_q: int = 128,
                         blk_k: int = 128, return_lse: bool = False):
    """q (B,S,H,hd), k/v (B,S,Hkv,hd) with H % Hkv == 0, one float dtype.
    Returns (B,S,H,hd) in q's dtype; every row also sees the first
    ``prefix_len`` keys (0 <= prefix_len <= S). With ``return_lse``,
    ``(out, lse)``: lse (B,H,S) f32, each row's log-sum-exp (K6 writes it
    in its epilogue; without it K6 is given a null pointer and writes
    none). On CUDA: f32 or bf16,
    contiguous, hd in ``HEAD_DIMS``, ``min(blk_k, S) <= MAX_BLK_K`` (in
    bf16 at most ``RING_BLK_K[hd]`` where it names the head dim). On the
    ``meta`` device the same checks, then an empty output, and K6's work
    (``roofline.work.attention_flops``) goes to the open work counter
    in place of a launch (not counted in ``launches``)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    bk = _key_block(S, blk_k)
    _check_prefix(S, prefix_len)
    if not q.is_cuda and not q.is_meta:
        return flash_attention_bshd_ref(q, k, v, causal=causal,
                                        window=window, prefix_len=prefix_len,
                                        blk_q=blk_q, blk_k=blk_k,
                                        return_lse=return_lse)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention takes f32 or bf16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if bk > MAX_BLK_K:
        raise ValueError(f"key block {bk} > {MAX_BLK_K}")
    if q.dtype == torch.bfloat16 and bk > RING_BLK_K.get(hd, MAX_BLK_K):
        raise ValueError(f"key block {bk} > {RING_BLK_K[hd]}, what the bf16 "
                         f"kernel's K ring holds at head dim {hd}")
    dev = q.device
    require(q, "q", q.dtype, (B, S, H, hd), dev)
    require(k, "k", q.dtype, (B, S, Hkv, hd), dev)
    require(v, "v", q.dtype, (B, S, Hkv, hd), dev)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev) \
        if return_lse else None
    if q.is_meta:
        W.record("flash_attention", W.attention_flops(
            B, S, H, hd, window, prefix_len, causal),
            W.nbytes(q, k, v, out, lse))
        return (out, lse) if return_lse else out
    code = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, S, H, Hkv, hd, bk,
        int(causal), int(window), int(prefix_len), _DTYPES[q.dtype],
        stream_ptr(q))
    check(code, "flash_attention")
    flash_attention_bshd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_bshd.launches = 0


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, blk_q: int = 128,
                         blk_k: int = 128) -> torch.Tensor:
    """The reference's layout: q/k/v (BH,S,hd), k/v already expanded to
    q's heads. Returns (BH,S,hd). K6 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if not q.is_cuda and not q.is_meta:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, blk_q=blk_q,
                                   blk_k=blk_k)
    return flash_attention_bshd(
        q[:, :, None], k[:, :, None], v[:, :, None], causal=causal,
        window=window, prefix_len=prefix_len, blk_q=blk_q,
        blk_k=blk_k)[:, :, 0]


def _bwd_rows(c0: int, c1: int, S: int, causal: bool, window: int,
              prefix_len: int):
    """The query rows [r0, r1) that see a key of [c0, c1) under K6's mask
    ``(causal & window) | (key < prefix_len)``."""
    if c0 < prefix_len:
        return 0, S
    r0 = c0 if causal else 0
    r1 = min(S, c1 - 1 + window) if window > 0 else S
    return r0, r1


def flash_attention_bshd_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 dout: torch.Tensor,
                                 lse: torch.Tensor | None = None, *,
                                 causal: bool = True, window: int = 0,
                                 prefix_len: int = 0,
                                 blk_k: int = BWD_BLK_K):
    """Plain version of K6's backward, in PyTorch operations on any
    device: dq, dk, dv of ``out = flash_attention_bshd(q, k, v, ...)`` for
    the output gradient ``dout``, each in its input's dtype. q/out/dout
    (B,S,H,hd), k/v (B,S,Hkv,hd), lse (B,H,S) f32 as the forward returns
    it; where ``lse`` is None each row's is recomputed from q and k first.

    Key block by key block in f32 (``min(blk_k, S)``, the largest common
    divisor where that does not divide S): ``p = exp(s - lse)`` under K6's
    mask, ``D = rowsum(dout * out)``, ``dv = p^T dout``, ``ds = p (dout
    v^T - D) scale``, ``dq += ds k``, ``dk = ds^T q``. Query heads stay
    grouped by KV head (row ``s * rep + r`` of a KV head's group), so each
    product over rows sums dk and dv over the group, and a block only
    visits the rows that see one of its keys."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    _check_prefix(S, prefix_len)
    rep = H // Hkv
    bk = min(blk_k, S)
    if S % bk:
        bk = math.gcd(S, bk)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    def grouped(t):     # (B,S,H,hd) -> (B,Hkv,S*rep,hd) f32
        return t.float().reshape(B, S, Hkv, rep, hd).permute(
            0, 2, 1, 3, 4).reshape(B, Hkv, S * rep, hd)

    def by_head(t):     # (B,S,Hkv,hd) -> (B,Hkv,S,hd) f32
        return t.float().permute(0, 2, 1, 3).contiguous()

    def scores(qr, kj, r0, r1, c0, c1):
        """The block's scores, masked to -inf: (B,Hkv,(r1-r0)*rep,bk)."""
        s = torch.matmul(qr, kj.transpose(-1, -2)).mul_(scale)
        rows = torch.arange(r0, r1, device=dev)[:, None]
        cols = torch.arange(c0, c1, device=dev)[None, :]
        mask = torch.ones((r1 - r0, c1 - c0), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (cols <= rows)
        if window > 0:
            mask = mask & (cols > rows - window)
        if prefix_len:
            mask = mask | (cols < prefix_len)
        s.view(B, Hkv, r1 - r0, rep, c1 - c0).masked_fill_(
            ~mask[:, None, :], -math.inf)
        return s

    with record_function("flash_attention.bwd"):
        qf, of, dof = grouped(q), grouped(out), grouped(dout)
        kf, vf = by_head(k), by_head(v)
        blocks = []
        for c0 in range(0, S, bk):
            r0, r1 = _bwd_rows(c0, c0 + bk, S, causal, window, prefix_len)
            if r0 < r1:
                blocks.append((c0, c0 + bk, r0, r1))
        if lse is not None:    # (B,H,S) -> (B,Hkv,S*rep), grouped
            lse = lse.float().reshape(B, Hkv, rep, S).transpose(
                2, 3).reshape(B, Hkv, S * rep)[..., None]
        else:
            lse = torch.full((B, Hkv, S * rep), -math.inf,
                             dtype=torch.float32, device=dev)
            for c0, c1, r0, r1 in blocks:
                rs = slice(r0 * rep, r1 * rep)
                s = scores(qf[:, :, rs], kf[:, :, c0:c1], r0, r1, c0, c1)
                lse[:, :, rs] = torch.logaddexp(lse[:, :, rs],
                                                torch.logsumexp(s, -1))
            # a row that sees no key: p = exp(s - inf) = 0
            lse = torch.where(torch.isinf(lse), math.inf, lse)[..., None]
        D = (dof * of).sum(-1, keepdim=True)
        dq = torch.zeros_like(qf)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        for c0, c1, r0, r1 in blocks:
            rs = slice(r0 * rep, r1 * rep)
            qr, dor = qf[:, :, rs], dof[:, :, rs]
            kj, vj = kf[:, :, c0:c1], vf[:, :, c0:c1]
            p = scores(qr, kj, r0, r1, c0, c1).sub_(lse[:, :, rs]).exp_()
            dv[:, :, c0:c1] = torch.matmul(p.transpose(-1, -2), dor)
            ds = torch.matmul(dor, vj.transpose(-1, -2)).sub_(
                D[:, :, rs]).mul_(p).mul_(scale)
            del p
            dq[:, :, rs] += torch.matmul(ds, kj)
            dk[:, :, c0:c1] = torch.matmul(ds.transpose(-1, -2), qr)
        dq = dq.reshape(B, Hkv, S, rep, hd).permute(0, 2, 1, 3, 4).reshape(
            B, S, H, hd)
        return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
                dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bshd_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor,
                             lse: torch.Tensor | None = None, *,
                             causal: bool = True, window: int = 0,
                             prefix_len: int = 0, blk_k: int = BWD_BLK_K):
    """dq, dk, dv of ``out = flash_attention_bshd(q, k, v, ...)`` for the
    output gradient ``dout``, each in its input's dtype. q/out/dout
    (B,S,H,hd), k/v (B,S,Hkv,hd), lse (B,H,S) f32 as
    ``flash_attention_bshd(..., return_lse=True)`` returns it.

    On a CUDA tensor one call of K6's backward kernels
    (``csrc/flash_attention_bwd.cu``: D = rowsum(dout * out), then the
    dk/dv and the dq kernels; counted once in ``launches``) under the
    ``flash_attention.bwd`` profiler range: q, k, v, out and dout of one
    dtype (f32 or bf16), contiguous and 16-byte aligned, hd in
    ``HEAD_DIMS``, and ``lse`` given (on ``meta`` it may be None);
    anything else raises before a launch. ``blk_k`` is the plain
    version's and has no effect there. On a CPU tensor the plain version,
    :func:`flash_attention_bshd_bwd_ref`.
    On the ``meta`` device the same checks, then empty gradients, and the
    function's work (``roofline.work.attention_bwd_flops``, its operands
    and gradients moved once) goes to the open work counter in place of a
    launch (not counted in ``launches``)."""
    if not q.is_cuda and not q.is_meta:
        return flash_attention_bshd_bwd_ref(
            q, k, v, out, dout, lse, causal=causal, window=window,
            prefix_len=prefix_len, blk_k=blk_k)
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    _check_prefix(S, prefix_len)
    if q.dtype not in _DTYPES:
        raise ValueError(f"K6's backward takes f32 or bf16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    dev = q.device
    for name, t, shape in (("q", q, (B, S, H, hd)), ("k", k, (B, S, Hkv, hd)),
                           ("v", v, (B, S, Hkv, hd)),
                           ("out", out, (B, S, H, hd)),
                           ("dout", dout, (B, S, H, hd))):
        require(t, name, q.dtype, shape, dev)
    if lse is not None:
        require(lse, "lse", torch.float32, (B, H, S), dev)
    elif not q.is_meta:
        raise ValueError("K6's backward kernel reads the log-sum-exp the "
                         "forward saved: pass flash_attention_bshd(..., "
                         "return_lse=True)'s lse")
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    if q.is_meta:
        W.record("flash_attention_bwd", W.attention_bwd_flops(
            B, S, H, hd, window, prefix_len, causal),
            W.nbytes(q, k, v, out, dout, lse, *grads))
        return grads
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K6's backward reads it in 16-byte "
                             f"vectors; its storage must start 16-byte "
                             f"aligned")
    D = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    dq, dk, dv = grads
    with record_function("flash_attention.bwd"):
        code = library().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, Hkv, hd, int(causal),
            int(window), int(prefix_len), _DTYPES[q.dtype], stream_ptr(q))
    check(code, "flash_attention_bwd")
    flash_attention_bshd_bwd.launches += 1
    return grads


flash_attention_bshd_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K6 with a gradient: the forward is :func:`flash_attention_bshd`
    (the kernel on a CUDA tensor, its plain version on a CPU tensor), the
    backward :func:`flash_attention_bshd_bwd` (the backward kernel on a
    CUDA tensor, its plain version on a CPU tensor). Where an input needs
    a gradient the forward asks K6 for each row's log-sum-exp and saves it
    beside q, k, v and the output; a forward over frozen weights (serving)
    asks for none and saves nothing. Under a non-reentrant checkpoint the
    recompute launches K6 again and saves its own tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, blk_k):
        kw = dict(causal=causal, window=window, prefix_len=prefix_len)
        ctx.opts = kw
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_bshd(q, k, v, blk_k=blk_k, **kw)
        out, lse = flash_attention_bshd(q, k, v, blk_k=blk_k,
                                        return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bshd_bwd(q, k, v, out,
                                              dout.contiguous(), lse,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None
