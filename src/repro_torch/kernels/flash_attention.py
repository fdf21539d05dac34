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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check, library, require, stream_ptr

NEG_INF = -1e30
# head dims the kernel is instantiated for, and the largest key block
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
MAX_BLK_K = 256
# the largest key block of the bf16 kernel at a head dim where its K ring
# holds fewer than MAX_BLK_K keys (two 64-key sub-tiles at 256)
RING_BLK_K = {256: 128}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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

