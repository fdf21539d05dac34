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

:class:`FlashAttention` makes K6 differentiable. The reference has no
backward kernel (no ``custom_vjp``): its training differentiates the jnp
attention with XLA, and so :func:`flash_attention_bshd_bwd` computes dq,
dk and dv in PyTorch operations, key block by key block in f32, as that
transpose does. A Hopper backward kernel would be the port's own (ROADMAP
queue B).
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.kernels import check, library, require, stream_ptr

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
                        blk_k: int = 128) -> torch.Tensor:
    """Plain version of K6 on any device. q/k/v (BH,S,hd), k/v already
    expanded to q's heads. Returns (BH,S,hd) in q's dtype."""
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
    return (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)


def flash_attention_bshd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, prefix_len: int = 0,
                             blk_q: int = 128,
                             blk_k: int = 128) -> torch.Tensor:
    """Plain version of K6 on the (B,S,H,hd) layout, on any device: the
    reference's GQA expansion to (B*H,S,hd), then
    :func:`flash_attention_ref`."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]

    def bh(t):
        return t.transpose(1, 2).repeat_interleave(rep, 1).reshape(
            B * H, S, hd)
    out = flash_attention_ref(q.transpose(1, 2).reshape(B * H, S, hd),
                              bh(k), bh(v), causal=causal, window=window,
                              prefix_len=prefix_len, blk_q=blk_q,
                              blk_k=blk_k)
    return out.reshape(B, H, S, hd).transpose(1, 2)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, blk_q: int = 128,
                         blk_k: int = 128) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,Hkv,hd) with H % Hkv == 0, one float dtype.
    Returns (B,S,H,hd) in q's dtype; every row also sees the first
    ``prefix_len`` keys (0 <= prefix_len <= S). On CUDA: f32 or bf16,
    contiguous, hd in ``HEAD_DIMS``, ``min(blk_k, S) <= MAX_BLK_K`` (in
    bf16 at most ``RING_BLK_K[hd]`` where it names the head dim)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    bk = _key_block(S, blk_k)
    _check_prefix(S, prefix_len)
    if not q.is_cuda:
        return flash_attention_bshd_ref(q, k, v, causal=causal,
                                        window=window, prefix_len=prefix_len,
                                        blk_q=blk_q, blk_k=blk_k)
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
    code = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        Hkv, hd, bk, int(causal), int(window), int(prefix_len),
        _DTYPES[q.dtype], stream_ptr(q))
    check(code, "flash_attention")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, blk_q: int = 128,
                         blk_k: int = 128) -> torch.Tensor:
    """The reference's layout: q/k/v (BH,S,hd), k/v already expanded to
    q's heads. Returns (BH,S,hd). K6 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if not q.is_cuda:
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


def flash_attention_bshd_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0, prefix_len: int = 0,
                             blk_k: int = BWD_BLK_K):
    """dq, dk, dv of ``out = flash_attention_bshd(q, k, v, ...)`` for the
    output gradient ``dout``, each in its input's dtype, in PyTorch
    operations on any device. q/out/dout (B,S,H,hd), k/v (B,S,Hkv,hd).

    K6 returns no log-sum-exp, so each row's is recomputed from q and k
    first. Then, key block by key block in f32 (``min(blk_k, S)``, the
    largest common divisor where that does not divide S): ``p = exp(s -
    lse)`` under K6's mask, ``D = rowsum(dout * out)``, ``dv = p^T
    dout``, ``ds = p (dout v^T - D) scale``, ``dq += ds k``, ``dk = ds^T
    q``. Query heads stay grouped by KV head (row ``s * rep + r`` of a KV
    head's group), so each product over rows sums dk and dv over the
    group, and a block only visits the rows that see one of its keys."""
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
        lse = torch.full((B, Hkv, S * rep), -math.inf, dtype=torch.float32,
                         device=dev)
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


class FlashAttention(torch.autograd.Function):
    """K6 with a gradient: the forward is :func:`flash_attention_bshd`
    (the kernel on a CUDA tensor, its plain version on a CPU tensor), the
    backward :func:`flash_attention_bshd_bwd`. q, k, v and the output are
    saved only where an input needs a gradient, so a forward over frozen
    weights (serving) saves nothing. Under a non-reentrant checkpoint the
    recompute launches K6 again and saves its own tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, blk_k):
        out = flash_attention_bshd(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, blk_k=blk_k)
        ctx.opts = dict(causal=causal, window=window, prefix_len=prefix_len)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bshd_bwd(q, k, v, out, dout,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None
