"""The plain versions of K6 (flash attention) and K7 (chunked RWKV6 WKV)
against the live JAX package on the CPU: the reference's Pallas kernels in
interpret mode (``repro.kernels.ops``) and its oracles
(``repro.kernels.ref``), on the shapes of ``tests/test_kernels.py``, from
the same numpy inputs. K6's prefix-LM mask (``prefix_len``, which the
reference's Pallas kernel lacks) is held against the reference's jnp
``repro.models.layers.attention``.

Tolerances are the reference's own for its kernels: K6 2e-5 in f32 and
2e-2 in bf16, K7 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import rwkv_chunk as RC

torch.set_num_threads(1)

K6_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
K7_TOL = 1e-4


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` with
    the same bits (bf16 rounded once, by JAX)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy())
    return j, t.to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(B, S, H, Hkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),
    (1, 256, 4, 1, 128),   # MQA
    (2, 512, 2, 2, 32),
    (1, 128, 4, 4, 96),    # head dim 96 (phi3-mini), MHA
    (2, 256, 4, 2, 96),    # head dim 96, GQA
    (1, 256, 2, 1, 256),   # head dim 256 (paligemma), MQA
])
def test_flash_attention_plain_vs_reference(B, S, H, Hkv, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Hkv, hd, dtype)
    got = TOPS.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = K6_TOL[dtype]
    for want in (JOPS.flash_attention(jq, jk, jv, causal=True),
                 JREF.attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(TREF.attention_ref(tq, tk, tv, causal=True)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_plain_sliding_window(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 256, 2, 2, 64, "float32", seed=1)
    got = TOPS.flash_attention(tq, tk, tv, causal=True, window=window)
    for want in (JOPS.flash_attention(jq, jk, jv, causal=True,
                                      window=window),
                 JREF.attention_ref(jq, jk, jv, causal=True, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Hkv,window", [(4, 32), (2, 100)])
def test_flash_attention_plain_head_dim_96_windowed(Hkv, window):
    """Head dim 96, causal with a sliding window, MHA and GQA, against the
    reference's Pallas kernel in interpret mode and its oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 256, 4, Hkv, 96, "float32",
                                        seed=2)
    got = TOPS.flash_attention(tq, tk, tv, causal=True, window=window)
    for want in (JOPS.flash_attention(jq, jk, jv, causal=True,
                                      window=window),
                 JREF.attention_ref(jq, jk, jv, causal=True, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_plain_bhsd_matches_reference_kernel():
    """The reference's own layout and entry, with a short sequence
    (``S < blk``) and a non-causal window."""
    from repro.kernels import flash_attention as JFA
    rng = np.random.default_rng(2)
    q, k, v = (_pair(rng.standard_normal((3, 64, 32)).astype(np.float32),
                     "float32") for _ in range(3))
    for causal, window in ((True, 0), (False, 16)):
        want = JFA.flash_attention_bhsd(q[0], k[0], v[0], causal=causal,
                                        window=window, interpret=True)
        got = FA.flash_attention_bhsd(q[1], k[1], v[1], causal=causal,
                                      window=window)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,prefix,window,q_block,blk_k", [
    (2, 64, 4, 2, 16, 0, 0, 1024, 16),    # no prefix, S <= q_block, GQA
    (2, 64, 4, 2, 16, 5, 0, 1024, 16),    # inside the first key block
    (2, 64, 4, 1, 16, 40, 0, 1024, 16),   # across block edges, MQA
    (1, 64, 4, 2, 16, 24, 0, 16, 16),     # S > q_block, GQA
    (1, 64, 4, 4, 16, 16, 0, 16, 32),     # S > q_block, at a q-block edge
    (1, 64, 2, 1, 256, 20, 0, 16, 32),    # head dim 256, S > q_block, MQA
    (1, 64, 2, 1, 256, 10, 0, 1024, 64),  # head dim 256, S <= q_block
    (1, 64, 4, 2, 16, 12, 24, 1024, 16),  # a window, S <= q_block
    (1, 64, 4, 2, 16, 64, 0, 16, 16),     # prefix_len = S: bidirectional
], ids=["p0", "p5-block0", "p40-edges-mqa", "p24-qblock16", "p16-qedge",
        "hd256-qblock16", "hd256", "window24", "pS"])
def test_flash_attention_plain_prefix_lm_vs_reference(
        B, S, H, Hkv, hd, prefix, window, q_block, blk_k, dtype):
    """The prefix-LM mask, (causal & window) | (key < prefix_len), against
    the reference's jnp ``layers.attention(..., prefix_len)`` through its
    single-block (S <= q_block) and per-q-block (S > q_block) paths. The
    reference's sliding-window path with a prefix at S > q_block hides
    prefix keys older than its key slice (ROADMAP, "Stated differences"),
    so a window is held only at S <= q_block."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Hkv, hd, dtype, seed=11)
    got = TOPS.flash_attention(tq, tk, tv, causal=True, window=window,
                               prefix_len=prefix, blk_k=blk_k)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = JL.attention(jq, jk, jv, causal=True, window=window,
                        prefix_len=prefix, q_block=q_block)
    tol = K6_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    if prefix:
        # the prefix changes the result where it reaches past the diagonal
        plain = TOPS.flash_attention(tq, tk, tv, causal=True, window=window,
                                     blk_k=blk_k)
        assert float((plain.float() - got.float()).abs().max()) > 10 * tol


def test_flash_attention_plain_refuses_a_bad_prefix():
    q = torch.zeros((1, 32, 2, 16))
    for prefix in (-1, 33):
        with pytest.raises(ValueError, match="prefix_len"):
            TOPS.flash_attention(q, q, q, prefix_len=prefix)


def test_flash_attention_plain_rejects_ragged_blocks():
    q = torch.zeros((1, 200, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        TOPS.flash_attention(q, q, q)


def test_flash_attention_plain_ignores_blk_q():
    """``blk_q`` is kept for the reference's signature and changes
    nothing: a query block that does not divide S is accepted and gives
    the result of the reference's dividing one."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 96, 2, 1, 32, "float32", seed=2)
    got = TOPS.flash_attention(tq, tk, tv, blk_q=64, blk_k=32)
    np.testing.assert_array_equal(
        _np(got), _np(TOPS.flash_attention(tq, tk, tv, blk_q=32, blk_k=32)))
    want = JOPS.flash_attention(jq, jk, jv, blk_q=32, blk_k=32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def _rwkv(BH, Tn, hd, lo=0.8, hi=0.999, scale=0.5, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((BH, Tn, hd)).astype(np.float32) * scale
            for _ in range(3)]
    arrs.append(rng.uniform(lo, hi, (BH, Tn, hd)).astype(np.float32))
    arrs.append(rng.standard_normal((BH, hd)).astype(np.float32) * 0.1)
    return arrs


def _bf16_kernel_numerics(q, k, v, *, split, blk_k=128):
    """The bf16 card kernel's arithmetic, causal, on the CPU: bf16 operands
    with f32 products and sums, the reference's softmax step in f32, and p
    V from p split into two bf16 terms (``split``) or rounded to bf16
    once, as the reference's jnp ``_mha_block`` rounds it."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(rep, 2).transpose(1, 2)
              for t in (k, v))
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for j in range(S // blk_k):
        kj, vj = (t[:, :, j * blk_k:(j + 1) * blk_k] for t in (kf, vf))
        mask = j * blk_k + torch.arange(blk_k)[None, :] <= rows
        s = torch.where(mask, qf @ kj.transpose(-1, -2) * (1.0 / hd ** 0.5),
                        -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        hi = p.bfloat16().float()
        pv = hi @ vj
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vj
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("hd,q_scale", [(64, 1.0), (128, 8.0), (256, 8.0)])
def test_flash_attention_bf16_split_p_keeps_one_ulp(hd, q_scale):
    """Why the card's bf16 kernel splits p: with p_hi + p_lo its result
    lands within one bf16 ulp (rtol 2^-7, atol 1e-5, the card tests'
    limit) of the reference's Pallas kernel, which keeps p in f32; p
    rounded to bf16 once does not (scores x 8 make p span many
    binades)."""
    rng = np.random.default_rng(7)
    a = [rng.standard_normal(sh).astype(np.float32)
         for sh in ((1, 256, 4, hd), (1, 256, 2, hd), (1, 256, 2, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "bfloat16")
                                    for x in (a[0] * q_scale, a[1], a[2]))
    want = _np(JOPS.flash_attention(jq, jk, jv, causal=True))
    lim = 1e-5 + 2.0 ** -7 * np.abs(want)
    split = _np(_bf16_kernel_numerics(tq, tk, tv, split=True))
    once = _np(_bf16_kernel_numerics(tq, tk, tv, split=False))
    assert (np.abs(split - want) <= lim).all()
    assert (np.abs(once - want) > lim).any()


@pytest.mark.parametrize("BH,Tn,hd,chunk", [
    (2, 128, 64, 64), (1, 256, 64, 128), (3, 128, 32, 32),
])
def test_rwkv_chunked_plain_vs_reference(BH, Tn, hd, chunk):
    arrs = _rwkv(BH, Tn, hd)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    got = TOPS.rwkv_chunked(*t, chunk=chunk)
    want_kernel = JOPS.rwkv_chunked(*j, chunk=chunk)
    want_scan = jax.vmap(lambda a, b, c, d, e: JREF.rwkv_chunk_ref(
        a, b, c, d, e, jnp.zeros((hd, hd)))[0])(*j)
    for want in (want_kernel, want_scan):
        np.testing.assert_allclose(_np(got), _np(want), rtol=K7_TOL,
                                   atol=K7_TOL)
    scan = torch.stack([TREF.rwkv_chunk_ref(*(x[b] for x in t),
                                            torch.zeros((hd, hd)))[0]
                        for b in range(BH)])
    np.testing.assert_allclose(_np(got), _np(scan), rtol=K7_TOL, atol=K7_TOL)


def test_rwkv_chunked_plain_chunk_invariance():
    """The chunk size does not change the result (the state carry)."""
    t = [torch.from_numpy(a) for a in _rwkv(1, 128, 32, 0.9, 0.999, 1.0, 3)]
    a = TOPS.rwkv_chunked(*t, chunk=32)
    b = TOPS.rwkv_chunked(*t, chunk=128)
    np.testing.assert_allclose(_np(a), _np(b), rtol=K7_TOL, atol=K7_TOL)


def test_rwkv_chunked_plain_state_matches_exact_scan():
    """The final state, from a non-zero start state, on the (B,T,H,hd)
    layout the model uses, against the reference's exact scan per head."""
    B, T, H, hd = 2, 256, 2, 32
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.6, 0.999, (B, T, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.1
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    y, S = RC.rwkv_chunked_bthd(
        *(torch.from_numpy(a) for a in (r, k, v, w, u)),
        S0=torch.from_numpy(S0), return_state=True)
    for b in range(B):
        for h in range(H):
            yw, Sw = JREF.rwkv_chunk_ref(
                *(jnp.asarray(a[b, :, h]) for a in (r, k, v, w)),
                jnp.asarray(u[h]), jnp.asarray(S0[b, h]))
            np.testing.assert_allclose(_np(y[b, :, h]), _np(yw),
                                       rtol=K7_TOL, atol=K7_TOL)
            np.testing.assert_allclose(_np(S[b, h]), _np(Sw), rtol=K7_TOL,
                                       atol=K7_TOL)


def _tf32_split(x):
    """The card kernel's split of an f32 operand: hi rounded to TF32
    (nearest, ties away), lo the exact rest cut to TF32."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _mm(a, b, terms=3):
    """a @ b as the card's K7 forms it on the tensor cores: three TF32
    products (a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 sums), or TF32 once."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _k7_kernel_numerics(r, k, v, w, u, chunk, terms=3):
    """K7's decomposition on the CPU, r/k/v/w (BH,T,hd), u (BH,hd): every
    chunk (padded to 32 tokens, w = 1) on its own — the prefix of logw as
    512 / hd segment sums and their offsets, rP, kD, kT, A = rP kD^T below
    the diagonal, the intra-chunk y = A v + diag v, the state increment
    dS_c = kT^T v and the decay exp(total_c) — then the chunks in order:
    S_c = exp(total_c) S_{c-1} + dS_c and y_c = intra_c + rP_c S_{c-1}.
    Returns y and the final state."""
    BH, T, hd = r.shape
    C = min(chunk, T)
    n, Cp, NS = T // C, -(-C // 32) * 32, 512 // hd

    def chunks(x, pad):
        x = x.reshape(BH, n, C, hd)
        return torch.cat([x, torch.full((BH, n, Cp - C, hd), pad)], 2)
    r, k, v, w = (chunks(x, p) for x, p in ((r, 0.), (k, 0.), (v, 0.),
                                            (w, 1.)))
    logw = torch.log(torch.clamp(w, min=1e-38))
    seg = logw.reshape(BH, n, NS, Cp // NS, hd)
    local = torch.cumsum(seg, 3)
    sums = local[:, :, :, -1]
    offs = torch.cumsum(sums, 2) - sums
    cum = (offs[:, :, :, None] + local).reshape(BH, n, Cp, hd)
    total = torch.cumsum(sums, 2)[:, :, -1]                 # (BH, n, hd)
    rP = r * torch.exp(cum - logw)
    kD = k * torch.exp(-cum)
    kT = k * torch.exp(total[:, :, None] - cum)
    tri = torch.tril(torch.ones((Cp, Cp), dtype=torch.bool), -1)
    A = torch.where(tri, _mm(rP, kD.transpose(-1, -2), terms), 0.0)
    diag = (r * u[:, None, None] * k).sum(-1)
    intra = _mm(A, v, terms) + diag[..., None] * v
    dS = _mm(kT.transpose(-1, -2), v, terms)                # (BH, n, hd, hd)
    decay = torch.exp(total)
    S = torch.zeros((BH, hd, hd))
    ys = []
    for c in range(n):
        ys.append(intra[:, c] + _mm(rP[:, c], S, terms))
        S = decay[:, c, :, None] * S + dS[:, c]
    y = torch.stack(ys, 1)[:, :, :C].reshape(BH, T, hd)
    return y, S


@pytest.mark.parametrize("BH,Tn,hd,chunk", [
    (2, 256, 64, 128), (2, 256, 32, 64), (3, 128, 16, 32),
    (2, 128, 64, 128),    # T equal to one chunk
    (1, 96, 64, 128),     # T below the chunk: one chunk of 96, padded
])
def test_rwkv_chunked_kernel_decomposition_vs_reference(BH, Tn, hd, chunk):
    """K7's decomposition (chunks apart, then the chain of states), in the
    card's three-term TF32 products, against the reference's Pallas
    kernel in interpret mode and its exact scan (y and the final state)."""
    arrs = _rwkv(BH, Tn, hd, lo=0.6, seed=5)
    j = [jnp.asarray(a) for a in arrs]
    y, S = _k7_kernel_numerics(*(torch.from_numpy(a) for a in arrs), chunk)
    want = JOPS.rwkv_chunked(*j, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want), rtol=K7_TOL, atol=K7_TOL)
    yw, Sw = jax.vmap(JREF.rwkv_chunk_ref)(*j, jnp.zeros((BH, hd, hd)))
    np.testing.assert_allclose(_np(y), _np(yw), rtol=K7_TOL, atol=K7_TOL)
    np.testing.assert_allclose(_np(S), _np(Sw), rtol=K7_TOL, atol=K7_TOL)


def test_rwkv_chunked_kernel_needs_the_three_term_split():
    """Why the card's K7 splits its operands: with TF32 once (~11 bits) its
    y leaves the 1e-4 bound of the reference's kernel; in three terms it
    keeps it."""
    arrs = _rwkv(2, 256, 64, lo=0.6, seed=6)
    want = _np(JOPS.rwkv_chunked(*(jnp.asarray(a) for a in arrs)))
    lim = K7_TOL + K7_TOL * np.abs(want)
    t = [torch.from_numpy(a) for a in arrs]
    three = _np(_k7_kernel_numerics(*t, 128)[0])
    once = _np(_k7_kernel_numerics(*t, 128, terms=1)[0])
    assert (np.abs(three - want) <= lim).all()
    assert (np.abs(once - want) > lim).any()
