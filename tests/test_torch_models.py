"""The port's LM serving path against the live JAX package on the CPU:
``models.layers``, ``models.rwkv``, ``prefill`` and ``decode_step`` of
smoke configs of glm4-9b (dense, K6's plain version), rwkv6-3b (ssm,
K7's plain version), granite-moe-1b-a400m and qwen2-moe-a2.7b (moe: 4
experts top-2, without and with a shared expert), musicgen-medium
(audio), hymba-1.5b (hybrid: 2 layers, d 64, 4 query heads over 1 KV
head of 16, window 1024, SSM state 8; K6's and K8's plain versions) and
paligemma-3b (vlm: 2 layers, d 64, 4 query heads over 1 KV head of 16,
4 patch embeddings in front of the text, prefix-LM attention through K6's
plain version; also at head dim 256, paligemma's own),
both packages starting from the reference's weights
(``interop.params_from_numpy``) and the same numpy tokens. The moe smoke
prefills drop pairs past their experts' capacity; the port drops the
same ones (``tests/test_torch_moe.py`` holds the layer itself,
``tests/test_torch_ssm.py`` the mamba head).

Bounds on the logits (of magnitude ~0.5 here):

* ``dtype="float32"``: 1e-5. Both run the same f32 function; they differ
  in summation order only (measured <= 3e-7).
* the config's bf16: 1e-2. The two frameworks round bf16 at different
  places (XLA's CPU code fuses elementwise chains in f32, torch rounds
  each op), and the reference's jnp attention rounds the softmax
  probabilities to bf16 before the second product where K6 keeps them in
  f32 (measured <= 3e-3).

``S`` in {32, 256} takes the reference's token-scan (S <= 128) and chunked
(S > 128) branches of ``time_mix_chunked``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rwkv as JR
from repro_torch import interop
from repro_torch.configs import all_configs
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rwkv as TR

torch.set_num_threads(1)

LOGIT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ARCHS = ["glm4-9b", "rwkv6-3b"]
# smoke configs keep head dim 16; phi3-mini's is 96, a K6 instance of its
# own: a phi3-shaped smoke model keeps it (2 layers, d 192, 2 MHA heads)
SHAPES = {"phi3-mini-3.8b": dict(d_model=192, n_heads=2, n_kv_heads=2,
                                 head_dim=96)}
# the moe and audio families: attention as the dense family's
ZOO = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "musicgen-medium"]
# the hybrid family: attention (sliding window) and a mamba head per block
HYBRID = ["hymba-1.5b"]
LM_ARCHS = ARCHS + list(SHAPES) + ZOO + HYBRID
# the vlm family: patch embeddings before the text, prefix-LM attention.
# Its prefill takes ``patch_embeds`` beside the tokens, so it has tests of
# its own; the smoke config keeps head dim 16, paligemma's 256 is a K6
# instance of its own
VLM = ["paligemma-3b"]
VLM_SHAPES = {"hd16": {}, "hd256": dict(head_dim=256)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _pair(arch, dtype, seed=3, **over):
    """Both packages' configs (``over`` replaces fields of the smoke
    config) and the reference's weights in both."""
    over = dict(SHAPES.get(arch, {}), dtype=dtype, **over)
    cj = dataclasses.replace(j_smoke(arch), **over)
    ct = dataclasses.replace(t_smoke(arch), **over)
    pj = JM.init_params(cj, jax.random.key(seed))
    pt = TM.init_params(ct, 0, "cpu")
    pt.load_state_dict(interop.params_from_numpy(
        ct, jax.tree.map(np.asarray, pj)))
    return cj, ct, pj, pt


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    sc = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        _np(TL.rms_norm(_t(x), _t(sc))),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(sc))), rtol=1e-6,
        atol=1e-6)
    pos = np.arange(8)[None, :] + 5
    np.testing.assert_allclose(
        _np(TL.apply_rope(_t(x), torch.from_numpy(pos), 500_000.0)),
        _np(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w1, w3 = (rng.standard_normal((16, 32)).astype(np.float32) * 0.2
              for _ in range(2))
    w2 = rng.standard_normal((32, 16)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        _np(TL.swiglu(*map(_t, (h, w1, w3, w2)))),
        _np(JL.swiglu(*map(jnp.asarray, (h, w1, w3, w2)))), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("S,window,dtype", [
    (32, 0, "float32"), (256, 0, "float32"), (256, 64, "float32"),
    (2048, 0, "float32"), (256, 0, "bfloat16")])
def test_attention_matches_reference(S, window, dtype):
    """The port's ``attention`` (K6's plain version) against the
    reference's block-wise jnp attention; S = 2048 takes its block-pair
    path. bf16 to 2e-2 (the reference rounds probabilities to bf16)."""
    rng = np.random.default_rng(1)
    shapes = ((1, S, 4, 16), (1, S, 2, 16), (1, S, 2, 16))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [_t(_np(a), getattr(torch, dtype)) for a in j]
    got = TL.attention(*t, causal=True, window=window)
    want = JL.attention(*j, causal=True, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,prefix,window,dtype", [
    (32, 8, 0, "float32"), (256, 100, 0, "float32"),
    (256, 128, 0, "bfloat16"), (256, 40, 64, "float32"),
    (2048, 256, 0, "float32")])
def test_attention_prefix_lm_matches_reference(S, prefix, window, dtype):
    """The port's ``attention`` with ``prefix_len`` (K6's plain version,
    key blocks of 128) against the reference's block-wise jnp attention;
    S = 2048 takes its per-q-block path (a window there is a stated
    difference, ROADMAP)."""
    rng = np.random.default_rng(12)
    shapes = ((1, S, 4, 16), (1, S, 1, 16), (1, S, 1, 16))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [_t(_np(a), getattr(torch, dtype)) for a in j]
    got = TL.attention(*t, causal=True, window=window, prefix_len=prefix)
    want = JL.attention(*j, causal=True, window=window, prefix_len=prefix)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
              for _ in range(2))
    valid = np.arange(12)[None, :] <= np.array([[5], [11]])
    np.testing.assert_allclose(
        _np(TL.decode_attention(_t(q), _t(kc), _t(vc),
                                torch.from_numpy(valid))),
        _np(JL.decode_attention(*map(jnp.asarray, (q, kc, vc, valid)))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# rwkv
# ---------------------------------------------------------------------------


def _rwkv_layer(dtype="float32"):
    cj, ct, pj, pt = _pair("rwkv6-3b", dtype, seed=4)
    lj = jax.tree.map(lambda a: a[0], pj["layers"])
    return cj, lj, pt["layers"][0]


@pytest.mark.parametrize("S,fn", [(8, "time_mix"), (32, "time_mix_chunked"),
                                  (256, "time_mix_chunked")])
def test_time_mix_matches_reference(S, fn):
    """Output, state and carry-out from a non-zero state and carry-in."""
    cfg, lj, lt = _rwkv_layer()
    hd = cfg.resolved_head_dim
    H = cfg.d_model // hd
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    S0 = rng.standard_normal((2, H, hd, hd)).astype(np.float32) * 0.1
    yj, Sj, lastj = getattr(JR, fn)(jnp.asarray(x), jnp.asarray(xp),
                                    jnp.asarray(S0), lj["tm"], H, hd)
    yt, St, lastt = getattr(TR, fn)(_t(x), _t(xp), _t(S0), lt["tm"], H, hd)
    for got, want in ((yt, yj), (St, Sj), (lastt, lastj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-5)


def test_time_mix_chunked_from_zero_state():
    """``S0=None`` (what the prefill passes) is the reference's zero
    state, through the chunked branch."""
    cfg, lj, lt = _rwkv_layer()
    hd = cfg.resolved_head_dim
    H = cfg.d_model // hd
    x = np.random.default_rng(6).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32)
    xp = np.zeros((1, 1, cfg.d_model), np.float32)
    yj, Sj, _ = JR.time_mix_chunked(jnp.asarray(x), jnp.asarray(xp),
                                    jnp.zeros((1, H, hd, hd)), lj["tm"], H,
                                    hd)
    yt, St, _ = TR.time_mix_chunked(_t(x), _t(xp), None, lt["tm"], H, hd)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(St), _np(Sj), rtol=1e-4, atol=1e-5)


def test_time_mix_chunked_without_state():
    """``return_state=False`` (the prefill's call) leaves the chunked
    branch's ``S_out`` None and ``y`` unchanged; the token-scan branch
    still returns its state."""
    cfg, _, lt = _rwkv_layer()
    hd = cfg.resolved_head_dim
    H = cfg.d_model // hd
    x = _t(np.random.default_rng(9).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32))
    xp = torch.zeros((1, 1, cfg.d_model))
    y, S_out, last = TR.time_mix_chunked(x, xp, None, lt["tm"], H, hd,
                                         return_state=False)
    y2, S2, _ = TR.time_mix_chunked(x, xp, None, lt["tm"], H, hd)
    assert S_out is None and S2.shape == (1, H, hd, hd)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(last, x[:, -1:], rtol=0, atol=0)
    _, S_scan, _ = TR.time_mix_chunked(x[:, :32], xp, None, lt["tm"], H, hd,
                                       return_state=False)
    assert S_scan.shape == (1, H, hd, hd)


def test_channel_mix_matches_reference():
    cfg, lj, lt = _rwkv_layer()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    yj, lastj = JR.channel_mix(jnp.asarray(x), jnp.asarray(xp), lj["cm"])
    yt, lastt = TR.channel_mix(_t(x), _t(xp), lt["cm"])
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(lastt), _np(lastj))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_carry_over_bit_for_bit():
    for arch in ARCHS:
        cj, ct, pj, pt = _pair(arch, "bfloat16")
        flat = dict(pt.named_parameters())
        assert flat["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(flat["embed"]), _np(pj["embed"]))
        key = "layers.1.attn.wo" if arch == "glm4-9b" else "layers.1.tm.wa"
        leaf = pj["layers"]["attn"]["wo"] if arch == "glm4-9b" \
            else pj["layers"]["tm"]["wa"]
        np.testing.assert_array_equal(_np(flat[key]), _np(leaf[1]))
        n_ref = sum(a.size for a in jax.tree.leaves(pj))
        assert sum(p.numel() for p in pt.parameters()) == n_ref


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen2-moe-a2.7b"])
def test_moe_params_carry_over_bit_for_bit(arch):
    """The moe subtree under the reference's keys: the router stays f32
    in a bf16 model, the experts (E, d, f) / (E, f, d), the shared
    experts (qwen2-moe's smoke config keeps one) at ``num_shared * f``."""
    cj, ct, pj, pt = _pair(arch, "bfloat16")
    flat = dict(pt.named_parameters())
    e = ct.moe
    assert flat["layers.1.moe.router"].dtype == torch.float32
    np.testing.assert_array_equal(_np(flat["layers.1.moe.router"]),
                                  _np(pj["layers"]["moe"]["router"][1]))
    assert flat["layers.0.moe.w1"].dtype == torch.bfloat16
    assert flat["layers.0.moe.w1"].shape == (e.num_experts, ct.d_model,
                                             e.expert_d_ff)
    assert flat["layers.0.moe.w2"].shape == (e.num_experts, e.expert_d_ff,
                                             ct.d_model)
    np.testing.assert_array_equal(_np(flat["layers.1.moe.w2"]),
                                  _np(pj["layers"]["moe"]["w2"][1]))
    assert ("layers.0.moe.sw1" in flat) == bool(e.num_shared)
    if e.num_shared:
        assert flat["layers.0.moe.sw2"].shape == (
            e.num_shared * e.shared_d_ff, ct.d_model)
    assert not any(".mlp." in key for key in flat)
    n_ref = sum(a.size for a in jax.tree.leaves(pj))
    assert sum(p.numel() for p in pt.parameters()) == n_ref
    # the port's own init: the same tree, the router f32
    own = TM.init_params(ct, 0, "cpu")
    assert {k: v.shape for k, v in own.named_parameters()} == \
        {k: v.shape for k, v in flat.items()}
    assert own["layers"][0]["moe"]["router"].dtype == torch.float32


def test_init_params_uses_the_reference_constants():
    cfg = t_smoke("rwkv6-3b")
    p = TM.init_params(cfg, 0, "cpu")
    tm = p["layers"][0]["tm"]
    assert float(tm["mu_r"][0]) == 0.5 and float(tm["w0"][0]) == -1.0
    assert float(tm["u"].abs().max()) == 0.0
    assert abs(float(p["embed"].float().std()) - 0.02) < 2e-3
    wo_std = float(tm["wo"].float().std())
    assert abs(wo_std - 0.02 / np.sqrt(2 * cfg.n_layers)) < 2e-3
    again = TM.init_params(cfg, 0, "cpu")
    assert torch.equal(p["embed"], again["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 256])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_matches_reference(arch, S, dtype):
    cj, ct, pj, pt = _pair(arch, dtype)
    toks = _tokens(cj, 2, S, 1)
    want = JM.prefill(pj, cj, {"tokens": jnp.asarray(toks)})
    got = TM.prefill(pt, ct, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, ct.vocab) and got.dtype == torch.float32
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_teacher_forced_matches_reference(arch, dtype):
    """Eight decode steps on the same tokens from an empty cache: every
    step's logits."""
    cj, ct, pj, pt = _pair(arch, dtype)
    toks = _tokens(cj, 2, 8, 2)
    cache_j = JM.init_cache(cj, 2, 16)
    cache_t = TM.init_cache(ct, 2, 16, device="cpu")
    tol = LOGIT_TOL[dtype]
    for i in range(toks.shape[1]):
        lj, cache_j = JM.decode_step(pj, cj, cache_j, jnp.asarray(toks[:, i]))
        lt, cache_t = TM.decode_step(pt, ct, cache_t,
                                     torch.from_numpy(toks[:, i]).long())
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol,
                                   err_msg=f"step {i}")
    assert int(cache_t["pos"]) == int(cache_j["pos"]) == toks.shape[1]


@pytest.mark.parametrize("arch", ARCHS + ZOO)
def test_decode_after_prefill_starts_from_zero_cache(arch):
    """The serve loop's cache: zero at ``pos = prompt_len`` (the prefill
    writes nothing into it), one step on, as the reference."""
    cj, ct, pj, pt = _pair(arch, "float32")
    tok = _tokens(cj, 2, 1, 3)[:, 0]
    lj, cj2 = JM.decode_step(pj, cj, JM.init_cache(cj, 2, 40, fill=32),
                             jnp.asarray(tok))
    lt, ct2 = TM.decode_step(pt, ct, TM.init_cache(ct, 2, 40, fill=32,
                                                   device="cpu"),
                             torch.from_numpy(tok).long())
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-5)
    assert int(ct2["pos"]) == int(cj2["pos"]) == 33
    for key in ct2:
        if key != "pos":
            np.testing.assert_allclose(_np(ct2[key]), _np(cj2[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b", "paligemma-3b"])
def test_unported_families_raise_naming_roadmap(arch):
    cfg = t_smoke(arch)
    if cfg.family in TM.SERVED_FAMILIES:
        TM.init_params(cfg, 0, "cpu")        # every family is ported
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.init_params(cfg, 0, "cpu")


@pytest.mark.parametrize("over", [dict(family="encoder"),
                                  dict(frontend="video")],
                         ids=["family", "frontend"])
def test_unknown_family_or_frontend_raises_naming_roadmap(over):
    cfg = dataclasses.replace(t_smoke("paligemma-3b"), **over)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.embed_inputs(None, cfg, {})


def test_serve_on_the_cpu():
    """``serve`` end to end at a smoke size: the greedy tokens follow the
    prefill's argmax, the DVFS stream reports, and the card is the
    default device (which raises here)."""
    cfg = t_smoke("rwkv6-3b")
    rep = TS.serve(cfg, batch=2, prompt_len=256, gen=3, dvfs=True,
                   dvfs_stride=2, device="cpu")
    toks = rep["tokens"]
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks[:, 0], rep["prefill_logits"].argmax(-1).int())
    assert torch.isfinite(rep["prefill_logits"]).all()
    assert rep["dvfs_requests"] == 2
    assert np.isfinite(rep["dvfs"]["ed2p_norm"])
    assert rep["dvfs"]["step_time"]["n_steps"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TS.serve(cfg, batch=1, prompt_len=8, gen=1)


def test_serve_moe_on_the_cpu():
    """``serve`` of the qwen2-moe smoke config (routed and shared
    experts): greedy tokens from the prefill's argmax, the DVFS stream
    (``telemetry`` reads ``cfg.moe``), the dropped pairs counted."""
    from repro_torch.models import moe as TMOE
    cfg = t_smoke("qwen2-moe-a2.7b")
    TMOE.moe_layer.dropped = 0
    rep = TS.serve(cfg, batch=2, prompt_len=64, gen=3, dvfs=True,
                   dvfs_stride=2, device="cpu")
    toks = rep["tokens"]
    assert toks.shape == (2, 4)
    assert torch.equal(toks[:, 0], rep["prefill_logits"].argmax(-1).int())
    assert torch.isfinite(rep["last_logits"]).all()
    assert rep["dvfs_requests"] == 2 and np.isfinite(rep["dvfs"]["ed2p_norm"])
    assert int(TMOE.moe_layer.dropped) >= 0


def test_serve_cli_smoke(capsys):
    TS.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
             "--prompt-len", "32", "--gen", "2", "--batch", "2"])
    assert "out shape (2, 3)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cli_takes_the_moe_and_audio_archs(arch, capsys):
    TS.main(["--arch", arch, "--smoke", "--device", "cpu",
             "--prompt-len", "16", "--gen", "2", "--batch", "2"])
    assert "out shape (2, 3)" in capsys.readouterr().out


def test_full_configs_are_the_published_widths():
    glm, rwkv = t_config("glm4-9b"), t_config("rwkv6-3b")
    assert (glm.n_layers, glm.d_model, glm.n_heads, glm.n_kv_heads,
            glm.resolved_head_dim, glm.d_ff, glm.vocab) == \
        (40, 4096, 32, 2, 128, 13696, 151552)
    assert (rwkv.n_layers, rwkv.d_model, rwkv.resolved_head_dim,
            rwkv.d_ff, rwkv.vocab) == (32, 2560, 64, 8960, 65536)


def test_moe_and_audio_configs_are_the_published_widths():
    gm, qm, mg = (t_config(n) for n in ZOO)
    assert (gm.n_layers, gm.d_model, gm.n_heads, gm.n_kv_heads,
            gm.resolved_head_dim, gm.vocab) == (24, 1024, 16, 8, 64, 49155)
    assert (gm.moe.num_experts, gm.moe.top_k, gm.moe.num_shared,
            gm.moe.expert_d_ff) == (32, 8, 0, 512)
    assert (qm.n_layers, qm.d_model, qm.n_heads, qm.n_kv_heads,
            qm.resolved_head_dim, qm.vocab) == (24, 2048, 16, 16, 128,
                                                151936)
    assert (qm.moe.num_experts, qm.moe.top_k, qm.moe.num_shared,
            qm.moe.expert_d_ff, qm.moe.shared_d_ff) == (60, 4, 4, 1408, 1408)
    assert (mg.family, mg.n_layers, mg.d_model, mg.n_heads, mg.n_kv_heads,
            mg.resolved_head_dim, mg.d_ff, mg.vocab) == \
        ("audio", 48, 1536, 24, 24, 64, 6144, 2048)


def _served(cfg):
    return cfg.family in TM.SERVED_FAMILIES


@pytest.mark.parametrize("arch", [n for n, c in all_configs().items()
                                  if _served(c) and c.family != "ssm"])
def test_served_attention_configs_have_a_k6_head_dim(arch):
    """Every config of an attention family the port serves prefills on
    K6 at its own head dim: the head dim is one K6 is instantiated for."""
    from repro_torch.kernels import flash_attention as FA
    cfg = t_config(arch)
    TM.init_params(dataclasses.replace(t_smoke(arch), n_layers=1), 0, "cpu")
    assert cfg.resolved_head_dim in FA.HEAD_DIMS, (arch,
                                                   cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# the hybrid family (hymba-1.5b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_prefill_with_a_window_matches_reference(dtype):
    """The smoke window of 1024 masks nothing at S = 256; a window of 64
    does, through K6's sliding-window mask."""
    cj, ct, pj, pt = _pair("hymba-1.5b", dtype, window=64)
    toks = _tokens(cj, 2, 256, 4)
    want = JM.prefill(pj, cj, {"tokens": jnp.asarray(toks)})
    got = TM.prefill(pt, ct, {"tokens": torch.from_numpy(toks).long()})
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    full = TM.prefill(pt, dataclasses.replace(ct, window=1024),
                      {"tokens": torch.from_numpy(toks).long()})
    assert float((full - got).abs().max()) > 10 * tol


@pytest.mark.parametrize("window,steps", [(1024, 8), (16, 40)],
                         ids=["window1024-8", "ring16-40"])
def test_hybrid_decode_matches_reference_cache_and_all(window, steps):
    """Teacher-forced decode in f32 from an empty cache: every step's
    logits and, after the last, every cache key (the SWA ring, the SSM
    state ``ssm_h`` and the conv carry) to 1e-5. At window 16 the ring
    wraps twice in 40 steps."""
    cj, ct, pj, pt = _pair("hymba-1.5b", "float32", window=window)
    toks = _tokens(cj, 2, steps, 5)
    cache_j = JM.init_cache(cj, 2, steps)
    cache_t = TM.init_cache(ct, 2, steps, device="cpu")
    assert cache_t["k"].shape[2] == min(window, steps)
    step_j = jax.jit(JM.decode_step, static_argnums=1)
    for i in range(steps):
        lj, cache_j = step_j(pj, cj, cache_j, jnp.asarray(toks[:, i]))
        lt, cache_t = TM.decode_step(pt, ct, cache_t,
                                     torch.from_numpy(toks[:, i]).long())
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i}")
    assert set(cache_t) == set(cache_j)
    for key in cache_t:
        np.testing.assert_allclose(_np(cache_t[key]), _np(cache_j[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert float(cache_t["ssm_h"].abs().max()) > 0


def test_hybrid_decode_after_prefill_starts_from_zero_cache():
    """The serve loop's cache for hymba: zero at ``pos = prompt_len``, one
    step on, every key as the reference's."""
    cj, ct, pj, pt = _pair("hymba-1.5b", "float32")
    tok = _tokens(cj, 2, 1, 3)[:, 0]
    lj, cj2 = JM.decode_step(pj, cj, JM.init_cache(cj, 2, 40, fill=32),
                             jnp.asarray(tok))
    lt, ct2 = TM.decode_step(pt, ct, TM.init_cache(ct, 2, 40, fill=32,
                                                   device="cpu"),
                             torch.from_numpy(tok).long())
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-5)
    assert int(ct2["pos"]) == int(cj2["pos"]) == 33
    for key in ct2:
        np.testing.assert_allclose(_np(ct2[key]), _np(cj2[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_init_cache_matches_reference(dtype):
    """Keys, shapes and dtypes: ``k``/``v`` the SWA ring in the activation
    dtype, ``ssm_h`` (L,B,H,hd,N) in f32, ``conv`` (L,B,K-1,Di) in the
    activation dtype."""
    cj = dataclasses.replace(j_smoke("hymba-1.5b"), dtype=dtype)
    ct = dataclasses.replace(t_smoke("hymba-1.5b"), dtype=dtype)
    want = JM.init_cache(cj, 3, 2000, fill=5)
    got = TM.init_cache(ct, 3, 2000, fill=5, device="cpu")
    assert set(got) == set(want) == {"pos", "k", "v", "ssm_h", "conv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), \
            key
    assert got["k"].shape[2] == ct.window and int(got["pos"]) == 5
    assert got["ssm_h"].dtype == torch.float32


def test_hybrid_params_carry_over_bit_for_bit():
    """The hybrid subtree under the reference's keys (``attn``, ``mamba``,
    ``norm_a``, ``norm_s``, ``mlp``): the mamba head's f32 leaves stay f32
    in a bf16 model, every leaf carries its bits, the counts are equal,
    and the port's own init builds the same tree."""
    cj, ct, pj, pt = _pair("hymba-1.5b", "bfloat16")
    flat = dict(pt.named_parameters())
    mj = pj["layers"]["mamba"]
    for key in ("w_dt", "dt_bias", "a_log", "d_skip"):
        assert flat[f"layers.1.mamba.{key}"].dtype == torch.float32, key
    for key in ("w_in", "conv_k", "w_b", "w_c", "w_out"):
        assert flat[f"layers.1.mamba.{key}"].dtype == torch.bfloat16, key
    for key in mj:
        np.testing.assert_array_equal(_np(flat[f"layers.1.mamba.{key}"]),
                                      _np(mj[key][1]), err_msg=key)
    for key in ("norm_a", "norm_s"):
        np.testing.assert_array_equal(_np(flat[f"layers.0.{key}"]),
                                      _np(pj["layers"][key][0]))
    np.testing.assert_array_equal(_np(flat["layers.0.attn.wq"]),
                                  _np(pj["layers"]["attn"]["wq"][0]))
    n_ref = sum(a.size for a in jax.tree.leaves(pj))
    assert sum(p.numel() for p in pt.parameters()) == n_ref
    own = TM.init_params(ct, 0, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in own.named_parameters()} == \
        {k: (v.shape, v.dtype) for k, v in flat.items()}
    m = own["layers"][0]["mamba"]
    assert float(m["dt_bias"][0]) == -2.0 and float(m["d_skip"][0]) == 1.0
    assert float(m["a_log"].abs().max()) == 0.0
    assert abs(float(m["conv_k"].float().std()) - 0.5) < 0.1


def test_serve_hybrid_on_the_cpu():
    """``serve`` of the hymba smoke config with the DVFS stream: greedy
    tokens from the prefill's argmax, finite logits, the stream reports
    (``telemetry`` reads the hybrid family)."""
    cfg = t_smoke("hymba-1.5b")
    rep = TS.serve(cfg, batch=2, prompt_len=64, gen=3, dvfs=True,
                   dvfs_stride=2, device="cpu")
    toks = rep["tokens"]
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks[:, 0], rep["prefill_logits"].argmax(-1).int())
    assert torch.isfinite(rep["prefill_logits"]).all()
    assert torch.isfinite(rep["last_logits"]).all()
    assert rep["dvfs_requests"] == 2 and np.isfinite(rep["dvfs"]["ed2p_norm"])


def test_serve_cli_takes_the_hybrid_arch(capsys):
    TS.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
             "--prompt-len", "16", "--gen", "2", "--batch", "2"])
    assert "out shape (2, 3)" in capsys.readouterr().out


def test_hybrid_config_is_the_published_widths():
    hy = t_config("hymba-1.5b")
    assert (hy.family, hy.n_layers, hy.d_model, hy.n_heads, hy.n_kv_heads,
            hy.resolved_head_dim, hy.d_ff, hy.vocab) == \
        ("hybrid", 32, 1600, 25, 5, 64, 5504, 32001)
    assert (hy.attn_kind, hy.window, hy.ssm.state_size, hy.ssm.conv_width,
            hy.ssm.expand) == ("swa", 1024, 16, 4, 1)


# ---------------------------------------------------------------------------
# the vlm family (paligemma-3b)
# ---------------------------------------------------------------------------


def _vlm_batch(cfg, B, S, seed):
    """A vlm prefill's inputs at total length S: ``n_patches`` patch
    embeddings (numpy, f32) and S - n_patches tokens."""
    rng = np.random.default_rng(seed)
    pe = rng.standard_normal((B, cfg.n_patches, cfg.d_model)) \
        .astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S - cfg.n_patches)) \
        .astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks).long(),
             "patch_embeds": torch.from_numpy(pe)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(VLM_SHAPES))
def test_vlm_embed_inputs_matches_reference(shape, dtype):
    """The patch embeddings, cast to the token embeddings' dtype, in front
    of the text's; ``prefix_len = n_patches``."""
    cj, ct, pj, pt = _pair("paligemma-3b", dtype, **VLM_SHAPES[shape])
    bj, bt = _vlm_batch(ct, 2, 16, 1)
    xj, pre_j = JM.embed_inputs(pj, cj, bj)
    xt, pre_t = TM.embed_inputs(pt, ct, bt)
    assert pre_t == pre_j == ct.n_patches == 4
    assert xt.shape == (2, 16, ct.d_model)
    assert xt.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(xt), _np(xj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 256])
@pytest.mark.parametrize("shape", list(VLM_SHAPES))
def test_vlm_prefill_matches_reference(shape, S, dtype):
    """The prefill with patch embeddings (prefix-LM attention over the 4
    patches) against the reference's: the logits at ``LOGIT_TOL`` and, in
    f32, the backbone's hidden states at every position, the patches' too.
    The prefix changes the first position's hidden state (it sees every
    patch) by more than ``LOGIT_TOL`` (at random init the attention is a
    small part of the residual stream: ~0.05 in bf16)."""
    cj, ct, pj, pt = _pair("paligemma-3b", dtype, **VLM_SHAPES[shape])
    bj, bt = _vlm_batch(ct, 2, S, 2)
    want = JM.prefill(pj, cj, bj)
    got = TM.prefill(pt, ct, bt)
    assert got.shape == (2, ct.vocab) and got.dtype == torch.float32
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    xj, pre = JM.embed_inputs(pj, cj, bj)
    xt, _ = TM.embed_inputs(pt, ct, bt)
    h = TM.backbone(pt, ct, xt, pre)[0]
    if dtype == "float32":
        np.testing.assert_allclose(
            _np(h), _np(JM.backbone(pj, cj, xj, pre)[0]), rtol=tol, atol=tol)
    causal = TM.backbone(pt, ct, xt, 0)[0]
    assert float((causal[:, 0] - h[:, 0]).float().abs().max()) > tol


@pytest.mark.parametrize("shape", list(VLM_SHAPES))
def test_vlm_decode_teacher_forced_matches_reference(shape):
    """Token decode in f32 from an empty cache (the vlm decodes on the
    dense branch, without a vision step, as the reference): every step's
    logits and, after the last, every cache key to 1e-5."""
    cj, ct, pj, pt = _pair("paligemma-3b", "float32", **VLM_SHAPES[shape])
    toks = _tokens(cj, 2, 8, 6)
    cache_j = JM.init_cache(cj, 2, 12)
    cache_t = TM.init_cache(ct, 2, 12, device="cpu")
    for i in range(toks.shape[1]):
        lj, cache_j = JM.decode_step(pj, cj, cache_j, jnp.asarray(toks[:, i]))
        lt, cache_t = TM.decode_step(pt, ct, cache_t,
                                     torch.from_numpy(toks[:, i]).long())
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i}")
    assert set(cache_t) == set(cache_j) == {"pos", "k", "v"}
    for key in cache_t:
        np.testing.assert_allclose(_np(cache_t[key]), _np(cache_j[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert cache_t["k"].shape[-1] == ct.resolved_head_dim


@pytest.mark.parametrize("shape", list(VLM_SHAPES))
def test_vlm_params_carry_over_bit_for_bit(shape):
    """``interop.params_from_numpy`` carries paligemma's tree unchanged:
    the untied ``lm_head``, every leaf's bits, the parameter counts; the
    port's own init builds the same tree."""
    cj, ct, pj, pt = _pair("paligemma-3b", "bfloat16", **VLM_SHAPES[shape])
    flat = dict(pt.named_parameters())
    assert not ct.tie_embeddings and "lm_head" in flat
    leaves = {"embed": pj["embed"], "lm_head": pj["lm_head"],
              "final_norm": pj["final_norm"]}
    for i in range(ct.n_layers):
        for grp in ("attn", "mlp"):
            for key, val in pj["layers"][grp].items():
                leaves[f"layers.{i}.{grp}.{key}"] = val[i]
        for key in ("norm1", "norm2"):
            leaves[f"layers.{i}.{key}"] = pj["layers"][key][i]
    assert set(flat) == set(leaves)
    for key, val in leaves.items():
        np.testing.assert_array_equal(_np(flat[key]), _np(val),
                                      err_msg=key)
    assert flat["layers.0.attn.wq"].shape == (
        ct.d_model, ct.n_heads, ct.resolved_head_dim)
    n_ref = sum(a.size for a in jax.tree.leaves(pj))
    assert sum(p.numel() for p in pt.parameters()) == n_ref
    own = TM.init_params(ct, 0, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in own.named_parameters()} == \
        {k: (v.shape, v.dtype) for k, v in flat.items()}


def test_serve_vlm_on_the_cpu():
    """``serve`` of the paligemma smoke config with the DVFS stream: the
    prompt is 4 patch embeddings and 28 tokens; greedy tokens from the
    prefill's argmax, finite logits, the stream reports."""
    cfg = t_smoke("paligemma-3b")
    rep = TS.serve(cfg, batch=2, prompt_len=32, gen=3, dvfs=True,
                   dvfs_stride=2, device="cpu")
    toks = rep["tokens"]
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks[:, 0], rep["prefill_logits"].argmax(-1).int())
    assert torch.isfinite(rep["prefill_logits"]).all()
    assert torch.isfinite(rep["last_logits"]).all()
    assert rep["dvfs_requests"] == 2 and np.isfinite(rep["dvfs"]["ed2p_norm"])


def test_serve_cli_takes_the_vlm_arch(capsys):
    TS.main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu",
             "--prompt-len", "16", "--gen", "2", "--batch", "2", "--dvfs"])
    out = capsys.readouterr().out
    assert "out shape (2, 3)" in out and "[dvfs]" in out


def test_vlm_config_is_the_published_widths():
    pg = t_config("paligemma-3b")
    assert (pg.family, pg.n_layers, pg.d_model, pg.n_heads, pg.n_kv_heads,
            pg.resolved_head_dim, pg.d_ff, pg.vocab) == \
        ("vlm", 18, 2048, 8, 1, 256, 16384, 257216)
    assert (pg.frontend, pg.n_patches, pg.attn_kind, pg.rope_theta,
            pg.tie_embeddings) == ("vision", 256, "full", 10_000.0, False)
    sm = t_smoke("paligemma-3b")
    assert (sm.n_layers, sm.d_model, sm.n_heads, sm.n_kv_heads,
            sm.resolved_head_dim, sm.n_patches) == (2, 64, 4, 1, 16, 4)
