"""The port's MoE layer (``repro_torch.models.moe``) against the live JAX
package on the CPU, from the same numpy-seeded inputs and weights.

Bounds: the plan's discrete outputs (``slot``, ``src_token``, the keep
mask ``weight > 0``) exactly; ``weight`` and the GShard ``aux`` to 1e-6
(both packages compute them in f32 from the same probabilities, summed in
other orders); the layer's output in f32 to 1e-5 (the same products,
summed in other orders: the reference adds a token's k terms in expert
order, the port in top-k order) and in bf16 to two bf16 ulps of its
largest magnitude, 2^-6 max|y| (the port sums the k terms in f32 and
rounds once where the reference rounds each product and each add to
bf16; the two frameworks also round the SwiGLU's elementwise chain at
other places). The models' bf16 logits are held to 1e-2 in
``tests/test_torch_models.py``.

The reference drops every pair past an expert's capacity C and, because
its dispatch writes those pairs' zeros over slot C-1, also the pair at
C-1 of an expert that overflowed. ``test_overflow_zeroes_the_pair_at_
capacity_minus_one`` pins that down on a case small enough to read.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JMOE
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ULPS = 2.0 ** -6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(E, k, n_shared, f):
    kw = dict(num_experts=E, top_k=k, num_shared=n_shared, expert_d_ff=f,
              shared_d_ff=f)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _weights(D, E, f, n_shared, seed, router_scale=0.5):
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    p = dict(router=w(D, E, s=router_scale), w1=w(E, D, f), w3=w(E, D, f),
             w2=w(E, f, D))
    if n_shared:
        fs = n_shared * f
        p.update(sw1=w(D, fs), sw3=w(D, fs), sw2=w(fs, D))
    return p


def _both(x, p, dtype):
    """The inputs and weights in each package, in ``dtype`` but for the
    f32 router (as ``init_params`` makes it)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    pt = {k: torch.tensor(_np(v)).to(torch.float32 if k == "router"
                                     else tdt)
          for k, v in pj.items()}
    xj = jnp.asarray(x, jdt)
    return xj, pj, torch.tensor(_np(xj)).to(tdt), pt


def _layer(B, S, D, E, k, n_shared, f, *, seed=0, dtype="float32", **kw):
    """Both layers on the same inputs: (y_ref, aux_ref, y, aux, dropped)."""
    x = np.random.default_rng(seed + 100).standard_normal(
        (B, S, D)).astype(np.float32)
    xj, pj, xt, pt = _both(x, _weights(D, E, f, n_shared, seed), dtype)
    cj, ct = _cfgs(E, k, n_shared, f)
    yj, aj = JMOE.moe_layer(xj, pj, cj, **kw)
    TMOE.moe_layer.dropped = 0
    yt, at = TMOE.moe_layer(xt, pt, ct, **kw)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    return yj, aj, yt, at, int(TMOE.moe_layer.dropped)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def test_router_probs_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 32)).astype(np.float32)
    w = rng.standard_normal((32, 6)).astype(np.float32) * 0.3
    got = TMOE.router_probs(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w))
    assert got.dtype == torch.float32
    want = JMOE.router_probs(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,E,k,capacity", [
    (16, 4, 2, 12),      # no drops
    (32, 4, 2, 5),       # most experts overflow
    (40, 8, 3, 4),       # the floor of 4
    (7, 6, 6, 4),        # every expert, every token
    (1, 8, 2, 4),        # the decode step's single token
])
def test_topk_dispatch_matches_reference(T, E, k, capacity):
    rng = np.random.default_rng(T * 100 + E)
    logits = np.exp(rng.standard_normal((T, E))).astype(np.float32)
    probs = logits / logits.sum(-1, keepdims=True)
    sj, wj, srcj, auxj = JMOE.topk_dispatch(jnp.asarray(probs), k, capacity)
    st, wt, srct, auxt = TMOE.topk_dispatch(torch.from_numpy(probs), k,
                                            capacity)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(srct.numpy(), np.asarray(srcj))
    np.testing.assert_array_equal((wt > 0).numpy(), np.asarray(wj) > 0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6,
                               atol=1e-6)


def test_dispatch_plan_rows_are_each_the_plan_alone():
    """Leading dims are rows of their own: a batched plan is each row's
    plan, and a pair is live unless its expert overflowed past it."""
    rng = np.random.default_rng(2)
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((3, 20, 4)).astype(np.float32)), -1)
    plan = TMOE.dispatch_plan(probs, 2, 6)
    for r in range(3):
        one = TMOE.dispatch_plan(probs[r], 2, 6)
        for got, want in zip(plan, one):
            assert torch.equal(got[r], want)
        count = torch.bincount(one.slot // 6, minlength=4)
        e = one.slot // 6
        expect = (one.pos < 5) | ((one.pos == 5) & (count[e] <= 6))
        assert torch.equal(one.live, expect)
        assert bool((one.weight[~(one.pos < 6)] == 0).all())


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,E,k,n_shared,kw,drops", [
    (2, 16, 4, 2, 0, dict(capacity_factor=4.0), False),     # no drops
    (2, 16, 4, 2, 1, dict(capacity_factor=4.0), False),     # shared on
    (2, 48, 4, 2, 0, dict(capacity_factor=0.6), True),      # overflow
    (2, 48, 8, 3, 1, dict(capacity_factor=0.5), True),      # overflow, shared
    (2, 32, 4, 2, 1, dict(seq_chunk=8), None),              # four chunks
    (2, 30, 4, 2, 0, dict(seq_chunk=8), None),              # 30 % 8: one
    (3, 1, 8, 3, 1, {}, False),                             # a decode step
])
def test_moe_layer_matches_reference(B, S, E, k, n_shared, kw, drops):
    yj, aj, yt, at, dropped = _layer(B, S, 16, E, k, n_shared, 8, **kw)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=1e-6)
    if drops is not None:
        assert (dropped > 0) == drops, dropped


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_layer_bf16_matches_reference(n_shared):
    yj, aj, yt, at, dropped = _layer(2, 64, 32, 4, 2, n_shared, 16,
                                     dtype="bfloat16", capacity_factor=0.8)
    assert dropped > 0
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0,
                               atol=BF16_ULPS * np.abs(_np(yj)).max())
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=1e-6)


def test_overflow_zeroes_the_pair_at_capacity_minus_one():
    """Two experts, top-1, six tokens all routed to expert 0 with
    ``capacity_factor=1`` (capacity max(6 / 2, 4) = 4): tokens 0-2 get the
    expert's output, token 3 gets 0 although it is within capacity (the
    reference's dropped pairs write their zeros over its slot), 4-5 are
    dropped. The port counts the three as dropped."""
    D, f = 4, 3
    x = np.ones((1, 6, D), np.float32) * np.arange(1, 7)[None, :, None]
    p = _weights(D, 2, f, 0, 5)
    p["router"] = np.zeros((D, 2), np.float32)
    p["router"][:, 0] = 1.0
    xj, pj, xt, pt = _both(x, p, "float32")
    cj, ct = _cfgs(2, 1, 0, f)
    yj, _ = JMOE.moe_layer(xj, pj, cj, capacity_factor=1.0)
    TMOE.moe_layer.dropped = 0
    yt, _ = TMOE.moe_layer(xt, pt, ct, capacity_factor=1.0)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)
    assert int(TMOE.moe_layer.dropped) == 3
    w1, w3, w2 = (pt[n][0] for n in ("w1", "w3", "w2"))
    alone = (torch.nn.functional.silu(xt[0] @ w1) * (xt[0] @ w3)) @ w2
    torch.testing.assert_close(yt[0, :3], alone[:3], rtol=1e-6, atol=1e-6)
    assert float(alone[3].abs().min()) > 0
    assert bool((yt[0, 3:] == 0).all()) and bool((_np(yj)[0, 3:] == 0).all())


def test_decode_step_never_drops():
    """One token a row: capacity 4 and k distinct experts, so every pair
    is live whatever the routing."""
    yj, aj, yt, at, dropped = _layer(4, 1, 8, 6, 6, 0, 8, seed=3)
    assert dropped == 0
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)


def test_dropped_count_accumulates_without_a_sync():
    """The counter is a 0-dim tensor on the layer's device, summed over
    calls until reset."""
    args = dict(seed=4, capacity_factor=0.5)
    *_, first = _layer(2, 32, 16, 4, 2, 0, 8, **args)
    assert first > 0
    x = np.random.default_rng(104).standard_normal(
        (2, 32, 16)).astype(np.float32)
    _, _, xt, pt = _both(x, _weights(16, 4, 8, 0, 4), "float32")
    _, ct = _cfgs(4, 2, 0, 8)
    TMOE.moe_layer.dropped = 0
    TMOE.moe_layer(xt, pt, ct, capacity_factor=0.5)
    TMOE.moe_layer(xt, pt, ct, capacity_factor=0.5)
    assert isinstance(TMOE.moe_layer.dropped, torch.Tensor)
    assert TMOE.moe_layer.dropped.device == xt.device
    assert int(TMOE.moe_layer.dropped) == 2 * first
