"""The port's training path against the live JAX package on the CPU, at
smoke sizes: K6's gradient (``kernels.flash_attention.FlashAttention``,
its plain forward here), ``layers.chunked_ce_loss``, ``model.loss_fn``
and its gradient leaf by leaf for every family (the MoE aux loss, the
vision prefix, K7's and K8's Functions included; the ssm and hybrid
families' other training tests are ``tests/test_torch_train_scan.py``),
one ``make_train_step`` step under each gradient compression
and microbatch count, remat, the token pipeline and checkpoints both
ways. Inputs and weights are the reference's (numpy-seeded data,
``interop.params_from_numpy`` / ``state_from_numpy``).

Bounds, each stated where it is used:

* f32 gradients: K6's dq/dk/dv to 1e-5 of each one's largest magnitude;
  every parameter's gradient to 1e-4 of its largest magnitude (both
  packages run the same f32 function, summed in other orders; measured
  <= 1.1e-6); losses to 1e-5.
* bf16 (one case): the loss to 1e-2; each gradient leaf to 2e-2 of its
  largest magnitude (the gradients are bf16, 2^-8 = 3.9e-3 at the
  largest element, and the two frameworks round the forward's
  elementwise chains at other places: measured <= 1.2e-2).
* A train step: m and v to 1e-5 of their largest magnitude, the update
  (new minus old parameter) to 1e-4 of the learning rate (measured <=
  1.5e-5). The update is ``lr * m^/(sqrt(v^) + 1e-8)``; at step one
  ``m^ = g`` and ``v^ = g^2``, so where ``|g| < 1e-6`` (100 x the 1e-8)
  a gradient error ``d`` moves it by up to ``lr * d * 1e-8 / (|g| +
  1e-8)^2``: those elements are exempt from the 1e-4 and held to the
  step's own bound, ``lr (1 + wd |p|)``.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTC
from repro.data import pipeline as JP
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import checkpoint as JCK
from repro.train import train_step as JT
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data import pipeline as TP
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as TCK
from repro_torch.train import train_step as TT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("smoke", 32, 4, "train")
J_SHAPE = JShape("smoke", 32, 4, "train")
LOSS_ARCHS = ["glm4-9b", "musicgen-medium", "granite-moe-1b-a400m",
              "paligemma-3b", "rwkv6-3b", "hymba-1.5b"]
# the loss's sequence length: 32, and 256 for rwkv6-3b, whose time-mix
# takes the chunked branch (K7's Function, chunks of 128) only past 128
LOSS_S = {"rwkv6-3b": 256}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tree(cfg, tree):
    """A reference tree (params-shaped, stacked layers) as the port's flat
    ``{name: tensor}`` dict, in f32."""
    return {k: v.float() for k, v in interop.params_from_numpy(
        cfg, jax.tree.map(_np, tree)).items()}


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype),
            dataclasses.replace(t_smoke(arch), dtype=dtype))


def _pair(arch, dtype="float32", seed=3):
    cj, ct = _configs(arch, dtype)
    pj = JM.init_params(cj, jax.random.key(seed))
    pt = TM.init_params(ct, 0, "cpu", trainable=True)
    pt.load_state_dict(interop.params_from_numpy(
        ct, jax.tree.map(np.asarray, pj)))
    return cj, ct, pj, pt


def _batch(cfg, B, S, seed):
    """Numpy tokens, labels and a ragged mask (zero over the vision
    frontend's patches, which come with bf16 patch embeddings): the
    reference's batch and the port's."""
    rng = np.random.default_rng(seed)
    vision = cfg.frontend == "vision"
    St = S - cfg.n_patches if vision else S
    b = {"tokens": rng.integers(0, cfg.vocab, (B, St)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) < 0.8).astype(np.int32)}
    if vision:
        b["labels"][:, :cfg.n_patches] = 0
        b["mask"][:, :cfg.n_patches] = 0
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    if vision:
        pe = rng.standard_normal((B, cfg.n_patches, cfg.d_model))
        bj["patch_embeds"] = jnp.asarray(pe, jnp.bfloat16)
        bt["patch_embeds"] = torch.from_numpy(
            _np(bj["patch_embeds"])).to(torch.bfloat16)
    return bj, bt


# ---------------------------------------------------------------------------
# K6's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,H,Hkv,window,prefix,q_block", [
    (256, 4, 2, 0, 0, 1024),     # causal, S <= q_block (_mha_block)
    (512, 4, 2, 0, 0, 128),      # causal, S > q_block (the pair scan)
    (256, 4, 1, 64, 0, 1024),    # a window
    (512, 4, 2, 64, 0, 128),     # a window, the reference's window scan
    (256, 4, 1, 0, 40, 1024),    # a prefix (the vision frontend's)
    (96, 6, 3, 0, 0, 1024),      # GQA 2, S not a multiple of 128
])
def test_attention_grad_matches_reference(S, H, Hkv, window, prefix,
                                          q_block):
    """dq, dk, dv of the port's ``attention`` (K6's Function: the plain
    forward, ``flash_attention_bshd_bwd``) against ``jax.vjp`` of the
    reference's jnp ``layers.attention`` in f32, to 1e-5 of each one's
    largest magnitude, where the reference's paths agree (no window with
    a prefix past ``q_block``)."""
    rng = np.random.default_rng(S + H + window + prefix)
    q = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, Hkv, 16)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q, k, v: JL.attention(
        q, k, v, causal=True, window=window, prefix_len=prefix,
        q_block=q_block), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TL.attention(qt, kt, vt, causal=True, window=window,
                       prefix_len=prefix)
    assert _rel(out, out_j) < 1e-5
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) < 1e-5, (name, _rel(g, w))


def test_attention_saves_nothing_without_grad():
    """Over frozen inputs (serving) the Function saves no tensor and
    builds no graph; the K6 launch counter is the kernel wrapper's and
    does not move on the CPU."""
    q = torch.randn(1, 32, 2, 16)
    before = FA.flash_attention_bshd.launches
    out = TL.attention(q, q[:, :, :1], q[:, :, :1])
    assert out.grad_fn is None and not out.requires_grad
    assert FA.flash_attention_bshd.launches == before


# ---------------------------------------------------------------------------
# chunked cross-entropy and the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [600, 1024])
def test_chunked_ce_loss_matches_reference(S):
    """The loss with a ragged mask, S = 600 (not a multiple of 512: one
    chunk) and 1024 (two chunks), to 1e-6; its gradients to x and the
    output embedding to 1e-5 of their largest magnitude."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    emb = (rng.standard_normal((96, 32)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 96, (2, S)).astype(np.int32)
    mask = (rng.random((2, S)) < 0.7).astype(np.float32)
    want, vjp = jax.vjp(lambda x, e: JL.chunked_ce_loss(
        x, e, jnp.asarray(labels), jnp.asarray(mask)),
        jnp.asarray(x), jnp.asarray(emb))
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, emb))
    got = TL.chunked_ce_loss(xt, et, torch.from_numpy(labels),
                             torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < 1e-6
    gx, ge = torch.autograd.grad(got, (xt, et))
    wx, we = vjp(jnp.float32(1.0))
    assert _rel(gx, wx) < 1e-5 and _rel(ge, we) < 1e-5


def _loss_and_grads(arch, dtype):
    cj, ct, pj, pt = _pair(arch, dtype)
    bj, bt = _batch(ct, 2, LOSS_S.get(arch, 32), 7)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cj, bj), has_aux=True)(pj)
    lt, mt = TM.loss_fn(pt, ct, bt)
    named = list(pt.named_parameters())
    gt = torch.autograd.grad(lt, [p for _, p in named])
    return (lj, mj, _tree(ct, gj)), (lt, mt, dict(zip(
        [n for n, _ in named], gt)))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """f32: the loss, ce and aux (granite-moe's MoE aux loss) to 1e-5 and
    each gradient leaf to 1e-4 of its largest magnitude; paligemma's
    batch holds patch embeddings, its prefix and labels masked over the
    patches; rwkv6-3b's runs 256 tokens through K7's Function (two
    chunks), hymba-1.5b's through K6's and K8's."""
    (lj, mj, gj), (lt, mt, gt) = _loss_and_grads(arch, "float32")
    assert abs(float(lt) - float(lj)) < 1e-5
    for k in ("ce", "aux"):
        assert abs(float(mt[k]) - float(mj[k])) < 1e-5, k
    if arch == "granite-moe-1b-a400m":
        assert float(mt["aux"]) > 0.5
    assert set(gt) == set(gj)
    for name in gj:
        assert gt[name].dtype == torch.float32
        assert _rel(gt[name], gj[name]) < 1e-4, name


def test_loss_fn_and_grads_bf16_match_reference():
    """The served dtype, glm4-9b: the loss to 1e-2, each gradient leaf (in
    bf16) to 2e-2 of its largest magnitude (module docstring)."""
    (lj, _, gj), (lt, _, gt) = _loss_and_grads("glm4-9b", "bfloat16")
    assert abs(float(lt) - float(lj)) < 1e-2
    for name in gj:
        assert _rel(gt[name], gj[name]) < 2e-2, name


def test_remat_policies_are_bitwise_equal():
    """``remat`` "full", "dots" and "none" give the same loss and
    gradients bit for bit (a recompute runs the same operations), for a
    dense and a moe smoke config."""
    for arch in ("glm4-9b", "granite-moe-1b-a400m"):
        _, ct, _, pt = _pair(arch)
        _, bt = _batch(ct, 2, 32, 9)
        out = {}
        for remat in ("full", "dots", "none"):
            cfg = dataclasses.replace(ct, remat=remat)
            loss, _ = TM.loss_fn(pt, cfg, bt)
            grads = torch.autograd.grad(loss, list(pt.parameters()))
            out[remat] = (loss, grads)
        for remat in ("dots", "none"):
            assert torch.equal(out[remat][0], out["full"][0]), remat
            for a, b in zip(out[remat][1], out["full"][1]):
                assert torch.equal(a, b), remat


def test_prefill_builds_no_graph():
    """Serving runs without grad and without remat, also over trainable
    parameters."""
    _, ct, _, pt = _pair("glm4-9b")
    _, bt = _batch(ct, 2, 32, 1)
    assert not TM.prefill(pt, ct, bt).requires_grad


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(mb, comp):
    """One step of glm4-9b's smoke config in f32 from the reference's
    state (``interop.state_from_numpy``) on the reference's batch, against
    its jitted step: loss and grad_norm to 1e-5 relative (1e-4 under
    int8_ef, whose flips below move the norm), lr exactly, m, v, ef and
    the update as the module docstring states.

    Compression: under bf16 a gradient element may round to the other
    neighbour where it sits on a bf16 tie, so m also allows one bf16 ulp
    of the element (2^-7 of it) and v two. Under int8_ef (one scale per
    reference leaf, its layers stacked) the quantised value of an element
    may differ (a flip, by one step of the scale) only where its ``x /
    scale`` lies within 1.3e-3 of a rounding tie (the gradients agree to
    1e-5 of their largest magnitude, x 127); every flip must be one, they
    are at most 0.5% of the elements, and flipped elements are exempt
    from the m, v, ef and update bounds. The reference's ``x`` is its
    residual plus its quantised gradient, read back from m through the
    step's clip factor."""
    cj, ct = _configs("glm4-9b")
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2, microbatches=mb,
              grad_compression=comp)
    tj, tt = JTC(**kw), TrainConfig(**kw)
    sj = JT.init_state(cj, tj, jax.random.key(1))
    st = interop.state_from_numpy(ct, jax.tree.map(np.asarray, sj))
    old = {k: v.clone() for k, v in _tree(ct, sj["params"]).items()}
    batch = JP.make_batch(cj, J_SHAPE, 0, microbatches=mb)
    sj2, mj = jax.jit(JT.make_train_step(cj, tj))(sj, batch)
    st2, mt = TT.make_train_step(ct, tt)(
        st, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    gtol = 1e-4 if comp == "int8_ef" else 1e-5
    assert abs(float(mt["loss"]) - float(mj["loss"])) < 1e-5
    assert abs(float(mt["grad_norm"]) / float(mj["grad_norm"]) - 1) < gtol
    assert float(mt["lr"]) == float(mj["lr"])
    assert int(st2["step"]) == int(sj2["step"]) == 1
    assert int(st2["opt"].count) == 1
    lr, wd = float(mj["lr"]), tt.weight_decay
    mj_, vj_ = _tree(ct, sj2["opt"].m), _tree(ct, sj2["opt"].v)
    pj_ = _tree(ct, sj2["params"])
    if comp == "int8_ef":
        efj = _tree(ct, sj2["ef"])
        clip = min(1.0, tt.grad_clip / max(float(mj["grad_norm"]), 1e-9))
        x_ref = {k: mj_[k] / ((1 - tt.beta1) * clip) + efj[k] for k in mj_}
        scale = {}
        for k, x in x_ref.items():
            top = TT._stacked(k)
            scale[top] = max(scale.get(top, 0.0), float(x.abs().max()) / 127)
    flips = n_all = 0
    for name, p in st2["params"].named_parameters():
        m, v = st2["opt"].m[name], st2["opt"].v[name]
        g = mj_[name] / (1 - tt.beta1)          # the step's gradient
        keep = torch.ones_like(g, dtype=torch.bool)
        if comp == "int8_ef":
            sc = scale[TT._stacked(name)]
            ef, ef_ref = st2["ef"][name], efj[name]
            flip = (ef - ef_ref).abs() > sc / 2
            frac = (x_ref[name] / sc).abs() % 1.0
            tie = (frac - 0.5).abs() < 1.3e-3
            assert not (flip & ~tie).any(), name
            flips += int(flip.sum())
            keep = ~flip
            assert float((ef - ef_ref).abs()[keep].max()) <= 1e-5 * 127 * sc
        n_all += g.numel()
        # one bf16 ulp of g: 2^-7 of it, twice that in v ~ g^2
        ulp = 2.0 ** -7 if comp == "bf16" else 0.0
        for got, want, n in ((m, mj_[name], 1), (v, vj_[name], 2)):
            err = (got - want).abs()[keep]
            lim = 1e-5 * want.abs().max() + n * ulp * want.abs()[keep]
            assert (err <= lim).all(), name
        upd = (p.detach() - old[name]) - (pj_[name] - old[name])
        big = (g.abs() >= 1e-6) & keep
        assert (upd.abs()[big] <= 1e-4 * lr).all(), name
        assert (upd.abs() <= 2 * lr * (1 + wd * old[name].abs())).all()
    assert flips <= 0.005 * n_all


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,B,S", [(2048, 4, 33), (512, 3, 100),
                                       (49155, 2, 64)])
def test_token_formula_on_reference_draws(vocab, B, S):
    """``affine_tokens`` fed the reference's own draws (recomputed here
    with ``jax.random`` from its keys) equals ``_batch_tokens`` exactly,
    the int32 wrap of ``x0 * 31^6`` included."""
    dc = JP.DataConfig()
    key = jax.random.fold_in(jax.random.key(dc.seed), vocab)
    want = np.asarray(JP._batch_tokens(key, B, S, vocab, dc))
    k1, k2, k3 = jax.random.split(key, 3)
    band = max(vocab // dc.n_phases, 16)
    draws = (jax.random.randint(k1, (B, 1), 0, dc.n_phases),
             jax.random.randint(k2, (B, 1), 0, band),
             jax.random.bernoulli(k3, 0.05, (B, S)),
             jax.random.randint(k3, (B, S), 0, band))
    got = TP.affine_tokens(*(torch.from_numpy(np.array(a)) for a in draws),
                           vocab, TP.DataConfig())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_batch_layouts_and_determinism():
    """Deterministic per step, other steps and host shards differ; labels
    are the next tokens; the microbatch axis (M, B/M, ...) also at M = 1;
    the vision batch's patch embeddings are bf16 and its labels and mask
    zero over the patches."""
    cfg = t_smoke("glm4-9b")
    a = TP.make_batch(cfg, SHAPE, 3, device="cpu")
    b = TP.make_batch(cfg, SHAPE, 3, device="cpu")
    assert set(a) == {"tokens", "labels", "mask"}
    for k in a:
        assert a[k].shape == (1, 4, 32) and a[k].dtype == torch.int32
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"],
                           TP.make_batch(cfg, SHAPE, 4, device="cpu")["tokens"])
    h0 = TP.make_batch(cfg, SHAPE, 3, host_id=0, n_hosts=2, device="cpu")
    h1 = TP.make_batch(cfg, SHAPE, 3, host_id=1, n_hosts=2, device="cpu")
    assert h0["tokens"].shape == (1, 2, 32)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    assert torch.equal(a["tokens"][0, :, 1:], a["labels"][0, :, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    m2 = TP.make_batch(cfg, SHAPE, 3, microbatches=2, device="cpu")
    assert m2["tokens"].shape == (2, 2, 32)
    assert torch.equal(m2["tokens"].reshape(4, 32), a["tokens"][0])
    vc = t_smoke("paligemma-3b")
    vb = TP.make_batch(vc, SHAPE, 0, microbatches=2, device="cpu")
    P = vc.n_patches
    assert vb["tokens"].shape == (2, 2, 32 - P)
    assert vb["labels"].shape == vb["mask"].shape == (2, 2, 32)
    assert vb["patch_embeds"].shape == (2, 2, P, vc.d_model)
    assert vb["patch_embeds"].dtype == torch.bfloat16
    assert not vb["labels"][..., :P].any() and not vb["mask"][..., :P].any()
    assert bool(vb["mask"][..., P:].all())
    assert torch.equal(vb["tokens"][..., 1:], vb["labels"][..., P:-1])
    it = TP.data_iterator(cfg, SHAPE, 3, device="cpu")
    assert torch.equal(next(it)["tokens"], a["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ref_state(comp="int8_ef", seed=1):
    cj, ct = _configs("glm4-9b")
    tc = JTC(lr=1e-3, total_steps=8, warmup_steps=2, grad_compression=comp)
    sj = JT.init_state(cj, tc, jax.random.key(seed))
    sj, _ = jax.jit(JT.make_train_step(cj, tc))(
        sj, JP.make_batch(cj, J_SHAPE, 0))
    return cj, ct, tc, sj


def _port_leaves(state):
    out = {"params/" + k: v for k, v in state["params"].named_parameters()}
    for k in state["opt"].m:
        out["m/" + k] = state["opt"].m[k]
        out["v/" + k] = state["opt"].v[k]
    for k in state.get("ef", {}):
        out["ef/" + k] = state["ef"][k]
    out["count"], out["step"] = state["opt"].count, state["step"]
    return out


def _assert_states_equal(a, b):
    la, lb = _port_leaves(a), _port_leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k].detach(), lb[k].detach()), k


def test_checkpoint_round_trip_of_the_whole_state():
    """Every leaf (bf16 params, f32 moments, int8_ef residuals, count and
    step) back bit for bit into a fresh state; the keys are the
    reference's; ``_gc`` keeps the last ``keep`` steps."""
    cfg = t_smoke("glm4-9b")
    tc = TrainConfig(grad_compression="int8_ef")
    state = TT.init_state(cfg, tc, 5, "cpu")
    for t in _port_leaves(state).values():
        with torch.no_grad():
            t.copy_(torch.randn(t.shape).to(t.dtype) if t.is_floating_point()
                    else torch.full(t.shape, 7, dtype=t.dtype))
    with tempfile.TemporaryDirectory() as d:
        for step in (1, 2, 3, 4):
            TCK.save(state, d, step, keep=3)
        assert sorted(p.name for p in Path(d).iterdir()) == [
            "step_00000002", "step_00000003", "step_00000004"]
        assert TCK.latest_step(d) == 4
        fresh = TT.init_state(cfg, tc, 6, "cpu")
        fresh, step = TCK.restore(fresh, d)
        assert step == 4
        _assert_states_equal(fresh, state)
        with np.load(Path(d) / "step_00000004" / "shard_00000.npz") as z:
            keys = set(z.files)
            assert z["params/layers/attn/wq"].shape == (2, 64, 4, 16)
            assert z["params/embed"].dtype == np.float32
    _, _, _, sj = _ref_state()
    assert keys == set(JCK._flatten(sj))


def test_checkpoints_restore_across_packages():
    """A checkpoint the reference saved restores in the port bit for bit
    (against ``state_from_numpy`` of the same state), and one the port
    saved restores in the reference."""
    cj, ct, tc, sj = _ref_state()
    want = interop.state_from_numpy(ct, jax.tree.map(np.asarray, sj))
    ttc = TrainConfig(grad_compression="int8_ef")
    with tempfile.TemporaryDirectory() as d:
        JCK.save(sj, d, step=1)
        got, step = TCK.restore(TT.init_state(ct, ttc, 9, "cpu"), d)
        assert step == 1
        _assert_states_equal(got, want)
    with tempfile.TemporaryDirectory() as d:
        TCK.save(want, d, step=2)
        template = JT.init_state(cj, tc, jax.random.key(4))
        back, step = JCK.restore(template, d)
        assert step == 2
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sj)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_np(a), _np(b))


def test_incomplete_checkpoint_ignored():
    cfg = t_smoke("glm4-9b")
    state = TT.init_state(cfg, TrainConfig(), 0, "cpu")
    with tempfile.TemporaryDirectory() as d:
        TCK.save(state, d, step=1)
        # a crash mid-save at step 5: a shard written, no manifest
        p = Path(d) / "step_00000005"
        p.mkdir()
        (p / "shard_00000.npz").write_bytes(b"garbage")
        assert TCK.latest_step(d) == 1
        assert TCK.restore(state, d)[1] == 1


def test_checkpoint_refuses_a_full_disk(monkeypatch):
    """``save`` checks the free space first and names what it needs."""
    cfg = t_smoke("glm4-9b")
    state = TT.init_state(cfg, TrainConfig(), 0, "cpu")
    monkeypatch.setattr(TCK.shutil, "disk_usage",
                        lambda p: type("U", (), {"free": 10})())
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(OSError, match="GB are free"):
            TCK.save(state, d, step=1)
        assert TCK.latest_step(d) is None


def test_checkpoint_resume_is_bit_exact_training():
    """Crash and restart mid-run reproduce the uninterrupted trajectory:
    6 steps straight equal 3 steps, a save, a restore into a fresh state
    and 3 more, bit for bit."""
    cfg = t_smoke("glm4-9b")
    tc = TrainConfig(lr=1e-3, total_steps=8, warmup_steps=2)
    step = TT.make_train_step(cfg, tc)

    def batch(i):
        return TP.make_batch(cfg, SHAPE, i, device="cpu")

    s = TT.init_state(cfg, tc, 1, "cpu")
    for i in range(6):
        s, _ = step(s, batch(i))
    with tempfile.TemporaryDirectory() as d:
        s2 = TT.init_state(cfg, tc, 1, "cpu")
        for i in range(3):
            s2, _ = step(s2, batch(i))
        TCK.save(s2, d, step=2)
        s2, last = TCK.restore(TT.init_state(cfg, tc, 1, "cpu"), d)
        for i in range(last + 1, 6):
            s2, _ = step(s2, batch(i))
    _assert_states_equal(s2, s)


def test_train_cli_runs_and_resumes():
    """``python -m repro_torch.launch.train --smoke --device cpu --dvfs``
    trains 3 steps, saves, prints the DVFS report; run again to 5 steps
    it resumes from step 2."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        def run(steps):
            return subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 "glm4-9b", "--smoke", "--device", "cpu", "--steps",
                 str(steps), "--dvfs", "--ckpt-dir", d], env=env, cwd=d,
                capture_output=True, text=True, timeout=300)
        first = run(3)
        assert first.returncode == 0, first.stderr
        assert "[dvfs] simulated energy" in first.stdout
        assert "final loss" in first.stdout
        assert TCK.latest_step(d) == 2
        second = run(5)
        assert second.returncode == 0, second.stderr
        assert "resumed from step 2" in second.stdout
        assert "step     4" in second.stdout
        assert TCK.latest_step(d) == 4


def test_loss_decreases_quick_train():
    """The reference's ``test_loss_decreases_quick_train`` on its own draws:
    granite-moe-1b-a400m's smoke config from its ``init_state`` (key 5) and
    its batches (``make_batch``, the default ``DataConfig``), carried over
    bit for bit, 40 port steps at lr 1e-2: the last loss sits 0.3 below
    the first (measured 0.36; the reference's own step 0.46). The bar
    compares two batches of 64 tokens, so it holds for a given draw, not
    for every one: at data seeds 1235-1239 the reference's own step drops
    -0.04 to 0.49 (``tests/test_torch_cuda.py`` holds the card's run on
    the port's own draws to a held-out loss instead)."""
    cj = j_smoke("granite-moe-1b-a400m")
    ct = t_smoke("granite-moe-1b-a400m")
    shape = JShape("smoke", seq_len=32, global_batch=2, kind="train")
    kw = dict(lr=1e-2, total_steps=40, warmup_steps=3)
    sj = JT.init_state(cj, JTC(**kw), jax.random.key(5))
    state = interop.state_from_numpy(ct, jax.tree.map(np.asarray, sj))
    step = TT.make_train_step(ct, TrainConfig(**kw))
    losses = []
    for i in range(40):
        batch = JP.make_batch(cj, shape, i)
        state, m = step(state, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]
