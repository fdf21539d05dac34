"""K6's log-sum-exp and the plain version of its backward, on the CPU.

* The plain forward's ``lse`` (``flash_attention_bshd_ref(...,
  return_lse=True)``) against the log-sum-exp of the masked, scaled
  scores computed with ``jax.numpy`` from the same q and k (the reference
  has no such output, so the test builds it from K6's mask, the
  reference's ``(causal & window) | (key < prefix)``): 1e-6 of the largest
  magnitude (both in f32 over at most a few hundred keys).
* The plain backward given that ``lse`` against the same backward
  recomputing it: 1e-6 of each gradient's largest magnitude (the two
  differ only in how each row's log-sum-exp was summed).
* ``FlashAttention`` saves the forward's ``lse`` where an input needs a
  gradient, and its backward uses it.
* On the ``meta`` device the forward returns an empty ``lse`` and the
  backward counts its operands, ``lse`` included, and refuses what the
  card refuses.

The gradients against ``jax.vjp`` of the reference's attention are
``tests/test_torch_train.py::test_attention_grad_matches_reference``; the
kernel is held against these plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.roofline import work as W

torch.set_num_threads(1)

# (B, S, H, Hkv, hd, causal, window, prefix)
LAYOUTS = [
    (2, 128, 4, 4, 16, True, 0, 0),      # causal
    (1, 192, 4, 2, 32, True, 48, 0),     # a window, GQA 2
    (2, 160, 2, 1, 16, True, 0, 24),     # a prefix, MQA
    (1, 256, 6, 2, 64, True, 64, 16),    # window and prefix, GQA 3
    (1, 96, 2, 2, 16, False, 0, 0),      # no mask
    (1, 128, 2, 1, 16, False, 40, 0),    # a window without causal
]
IDS = ["causal", "window-gqa", "prefix-mqa", "window-prefix-gqa", "full",
       "window-noncausal"]


def _inputs(B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                      (B, S, H, hd))]


def _jnp_lse(q, k, causal, window, prefix):
    """(B,H,S): logsumexp over kept keys of q k^T / sqrt(hd), in jnp."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kx = jnp.repeat(jnp.asarray(k), rep, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kx) / math.sqrt(hd)
    rows = jnp.arange(S)[:, None]
    cols = jnp.arange(S)[None, :]
    keep = jnp.ones((S, S), bool)
    if causal:
        keep = keep & (cols <= rows)
    if window > 0:
        keep = keep & (cols > rows - window)
    keep = keep | (cols < prefix)
    return jax.nn.logsumexp(jnp.where(keep, s, -jnp.inf), axis=-1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,prefix", LAYOUTS,
                         ids=IDS)
def test_plain_lse_matches_jnp_logsumexp(B, S, H, Hkv, hd, causal, window,
                                         prefix):
    q, k, v, _ = _inputs(B, S, H, Hkv, hd, S + H)
    out, lse = FA.flash_attention_bshd_ref(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        prefix_len=prefix, blk_k=32, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert torch.equal(out, FA.flash_attention_bshd_ref(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        prefix_len=prefix, blk_k=32))
    assert _rel(lse.numpy(), _jnp_lse(q, k, causal, window, prefix)) < 1e-6


def test_plain_backward_takes_an_infinite_lse_as_no_key():
    """An lse of +inf, what K6 writes for a row that keeps no key, gives
    that row p = 0: the plain backward returns a zero dq for it (every
    row of K6's masks keeps at least its own key, so the row is set by
    hand)."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 32, 2, 2, 16, 5))
    out, lse = FA.flash_attention_bshd_ref(q, k, v, return_lse=True)
    lse = lse.clone()
    lse[:, :, 3] = math.inf
    dq, _, _ = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse)
    assert torch.all(dq[:, 3] == 0) and torch.any(dq[:, 4] != 0)


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,prefix", LAYOUTS,
                         ids=IDS)
def test_plain_backward_with_lse_matches_recompute(B, S, H, Hkv, hd, causal,
                                                   window, prefix):
    q, k, v, do = map(torch.from_numpy, _inputs(B, S, H, Hkv, hd, S + hd))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = FA.flash_attention_bshd_ref(q, k, v, blk_k=32,
                                           return_lse=True, **kw)
    n = FA.flash_attention_bshd_bwd.launches
    given = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse, blk_k=64,
                                        **kw)
    recomputed = FA.flash_attention_bshd_bwd(q, k, v, out, do, blk_k=64,
                                             **kw)
    assert FA.flash_attention_bshd_bwd.launches == n
    for a, b in zip(given, recomputed):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a.numpy(), b.numpy()) < 1e-6


@pytest.mark.parametrize("need", [True, False], ids=["grad", "frozen"])
def test_function_saves_the_forwards_lse(need):
    """Where an input needs a gradient the Function saves q, k, v, the
    output and the forward's lse (the plain version's, here), and its
    gradient equals the plain backward given that lse; over frozen inputs
    it saves nothing."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 64, 4, 2, 16, 9))
    qs, ks, vs = (t.clone().requires_grad_(need) for t in (q, k, v))
    out = FA.FlashAttention.apply(qs, ks, vs, True, 16, 0, 32)
    if not need:
        assert out.grad_fn is None
        return
    saved = out.grad_fn.saved_tensors
    _, lse = FA.flash_attention_bshd_ref(q, k, v, window=16, blk_k=32,
                                         return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[4], lse)
    got = torch.autograd.grad(out, (qs, ks, vs), do)
    want = FA.flash_attention_bshd_bwd(q, k, v, out.detach(), do, lse,
                                       window=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_forward_returns_lse_and_backward_counts_it():
    q, do = _meta(2, 256, 4, 64), _meta(2, 256, 4, 64)
    k = v = _meta(2, 256, 2, 64)
    with W.WorkCounter() as c:
        out, lse = FA.flash_attention_bshd(q, k, v, return_lse=True)
        grads = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse)
    assert lse.is_meta and lse.shape == (2, 4, 256) \
        and lse.dtype == torch.float32
    assert all(g.is_meta and g.shape == t.shape
               for g, t in zip(grads, (q, k, v)))
    assert c.kernels["flash_attention"]["bytes"] == W.nbytes(q, k, v, out,
                                                             lse)
    assert c.kernels["flash_attention_bwd"]["bytes"] == W.nbytes(
        q, k, v, out, do, lse, *grads)


def test_meta_backward_refuses_what_the_card_refuses():
    q, do = _meta(1, 128, 2, 48), _meta(1, 128, 2, 48)
    k = v = _meta(1, 128, 1, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention_bshd_bwd(q, k, v, q, do)
    q, do = _meta(1, 128, 2, 64), _meta(1, 128, 2, 64)
    k = v = _meta(1, 128, 1, 64)
    with pytest.raises(ValueError, match="lse: shape"):
        FA.flash_attention_bshd_bwd(q, k, v, q, do,
                                    _meta(1, 128, 2, dtype=torch.float32))
    with pytest.raises(ValueError, match="lse: dtype"):
        FA.flash_attention_bshd_bwd(q, k, v, q, do, _meta(1, 2, 128))
    with pytest.raises(ValueError, match="f32 or bf16"):
        FA.flash_attention_bshd_bwd(*(t.half() for t in (q, k, v, q, do)))
