"""The port's learned-predictor pipeline (``repro_torch.learn``,
``optim.adamw``, the npz half of ``data.pipeline``) against the
reference's (``repro.learn``), on the CPU.

* Exact: the npz bytes, the train/val split, ``fold_norm`` and the offline
  selection mirror ``select_fidx`` are the reference's bit for bit; the
  heads and the trust-region clamp agree to 1e-6; one AdamW update to
  1e-6, and the cosine schedule exactly through its warmup and within one
  f32 ulp of its cosine after it.
* Features: ``_run_features`` on the reference's own traces agrees to
  1e-6.
* Fit: on the reference's mini dataset both heads' folded weights sit
  within ``FIT_WTOL`` of the reference's and the probe/loss curves within
  ``FIT_CTOL`` (see there for the measured values).
* Hooks (tier 2): ``learned_predict``/``learned_update`` at a fixed carry
  and context agree to 1e-5, with the reference's frozen artifact loaded
  unchanged by the port.
* Closed loop (tier 3): a learned spec's epochs, the reference started from
  the port's carry each epoch on integer-keyed noise, agree to 1e-5.
* Contracts: ``ParamHook`` value equality, a weight swap rebuilds nothing
  of the fork family, a learned grid equals its per-point runs bit for
  bit, the mini dataset is bitwise deterministic, registration audits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import lockstep_noise, np_, port_program  # noqa: E402
from repro.analysis import deps as JDEPS  # noqa: E402
from repro.core import mechanisms as JMECH  # noqa: E402
from repro.core import predictors as JPRED  # noqa: E402
from repro.core import simulate as JSIM  # noqa: E402
from repro.core.workloads import get_workload as j_get_workload  # noqa: E402
from repro.data import pipeline as JPIPE  # noqa: E402
from repro.learn import dataset as JLDS  # noqa: E402
from repro.learn import mechanism as JLMECH  # noqa: E402
from repro.learn import models as JLM  # noqa: E402
from repro.learn import train as JLTR  # noqa: E402
from repro.optim import adamw as JADAMW  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.mechanisms import ParamHook  # noqa: E402
from repro_torch.core.workloads import get_workload  # noqa: E402
from repro_torch.data import pipeline as PIPE  # noqa: E402
from repro_torch.learn import __main__ as CLI  # noqa: E402
from repro_torch.learn import dataset as LDS  # noqa: E402
from repro_torch.learn import mechanism as LMECH  # noqa: E402
from repro_torch.learn import models as LM  # noqa: E402
from repro_torch.learn import train as LTR  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

WORKLOADS = ("comd", "xsbench")
MINI = dict(workloads=WORKLOADS, seeds=(0,), epoch_us=(1.0,), n_cu=8,
            n_epochs=64, warmup=8, val_frac=0.5)
GRID_SIM = dict(n_cu=8, n_wf=8, n_epochs=24, entries=16, offset_blocks=8)
FIT_STEPS = 50
# fit parity on the reference's mini dataset, per folded array:
# max |port - ref| <= FIT_WTOL * max |ref| (measured at most 1.1e-5 for
# the linear head's w and 2.3e-5 for the MLP's w1, relative to each
# element, over 50 and 200 steps); probe and step-loss curves within
# FIT_CTOL relative (measured 2.6e-7): the two differ only in f32
# summation order
FIT_WTOL = 1e-4
FIT_CTOL = 2e-6


@pytest.fixture(scope="module")
def j_mini():
    return JLDS.generate_dataset(JLDS.DatasetConfig(**MINI))


@pytest.fixture(scope="module")
def t_mini():
    return LDS.generate_dataset(LDS.DatasetConfig(**MINI, device="cpu"))


@pytest.fixture(scope="module")
def ref_weights(j_mini, tmp_path_factory):
    """The reference's frozen weights, saved by the reference and loaded by
    the port unchanged."""
    out = {}
    d = tmp_path_factory.mktemp("w")
    for kind in ("linear", "mlp"):
        params, _ = JLTR.fit(*j_mini, kind=kind, steps=FIT_STEPS)
        path = JLTR.save_weights(d / f"{kind}.npz", params)
        loaded, meta = LTR.load_weights(path)
        assert meta["kind"] == kind
        out[kind] = (params, loaded)
    return out


@pytest.fixture(scope="module")
def progs():
    return {w: get_workload(w, device="cpu") for w in WORKLOADS}


# ---------------------------------------------------------------------------
# exact: pipeline, models, optimizer
# ---------------------------------------------------------------------------


def test_export_npz_bytes_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"b": np.arange(6).reshape(2, 3),
              "a": rng.standard_normal(4).astype(np.float32),
              "c": rng.integers(0, 9, 5).astype(np.int8)}
    meta = {"k": [1, 2], "name": "x", "f": 0.25}
    a = PIPE.export_npz(tmp_path / "t" / "d.npz", arrays, meta)
    b = JPIPE.export_npz(tmp_path / "j" / "d.npz", arrays, meta)
    assert a.read_bytes() == b.read_bytes()
    got, got_meta = PIPE.load_npz(b)
    assert got_meta == meta
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("n,frac,seed", [(20, 0.25, 3), (2, 0.1, 0),
                                         (5, 0.0, 0), (32, 0.25, 0),
                                         (7, 0.5, 11)])
def test_train_val_split_equals_reference(n, frac, seed):
    tr, va = PIPE.train_val_split(n, val_frac=frac, seed=seed)
    jtr, jva = JPIPE.train_val_split(n, val_frac=frac, seed=seed)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    assert tr.dtype == jtr.dtype and va.dtype == jva.dtype
    with pytest.raises(ValueError):
        PIPE.train_val_split(5, val_frac=1.0)


def _norm_case(seed, n_out=2):
    rng = np.random.default_rng(seed)
    mu_x = rng.standard_normal(LM.N_FEATURES).astype(np.float32)
    sd_x = rng.uniform(0.5, 2.0, LM.N_FEATURES).astype(np.float32)
    mu_y = rng.standard_normal(n_out).astype(np.float32)
    sd_y = rng.uniform(0.5, 2.0, n_out).astype(np.float32)
    x = rng.standard_normal((32, LM.N_FEATURES)).astype(np.float32) * 50
    return rng, mu_x, sd_x, mu_y, sd_y, x


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_models_and_fold_norm_match_reference(kind):
    """init is the reference's, fold_norm bit for bit, the heads and the
    trust-clamped prediction to 1e-6; the fold identity holds in f64."""
    rng, mu_x, sd_x, mu_y, sd_y, x = _norm_case(1)
    p0, j0 = LM.INIT[kind](3), JLM.INIT[kind](3)
    for k in j0:
        np.testing.assert_array_equal(p0[k], j0[k])
    params = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()}
    folded = LM.fold_norm(params, mu_x, sd_x, mu_y, sd_y)
    jfolded = JLM.fold_norm(params, mu_x, sd_x, mu_y, sd_y)
    for k in jfolded:
        np.testing.assert_array_equal(folded[k], jfolded[k])
    for fn, jfn in ((LM.APPLY[kind], JLM.APPLY[kind]),
                    (LM.predict_targets, JLM.predict_targets)):
        got = np_(fn(folded, torch.as_tensor(x)))
        want = np_(jfn(jfolded, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    # the fold identity in f64: apply(folded, x) == apply(p, x_n)*sd+mu
    p64 = {k: torch.as_tensor(v, dtype=torch.float64)
           for k, v in params.items()}
    f64 = {k: torch.as_tensor(v, dtype=torch.float64)
           for k, v in folded.items()}

    def apply64(p, xx):
        if kind == "linear":
            return xx @ p["w"] + p["b"]
        return torch.tanh(xx @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    x64 = torch.as_tensor(x, dtype=torch.float64)
    want = apply64(p64, (x64 - torch.as_tensor(mu_x, dtype=torch.float64))
                   / torch.as_tensor(sd_x, dtype=torch.float64)) \
        * torch.as_tensor(sd_y, dtype=torch.float64) \
        + torch.as_tensor(mu_y, dtype=torch.float64)
    np.testing.assert_allclose(np_(apply64(f64, x64)), np_(want),
                               rtol=1e-5, atol=1e-5)


def test_predict_targets_trust_region():
    rng = np.random.default_rng(2)
    x = np.abs(rng.standard_normal((64, LM.N_FEATURES))
               ).astype(np.float32) * 100.0
    react = x[:, list(LM.REACT_COLS)]
    zero = {"w": np.zeros((LM.N_FEATURES, 2), np.float32),
            "b": np.zeros((2,), np.float32)}
    np.testing.assert_array_equal(np_(LM.predict_targets(zero, x)), react)
    huge = {"w": np.full((LM.N_FEATURES, 2), 1e6, np.float32),
            "b": np.full((2,), 1e6, np.float32)}
    out = np_(LM.predict_targets(huge, x))
    lim = LM.TRUST_RADIUS * np.abs(react)
    assert (out <= react + lim + 1e-4).all()
    assert (out >= react - lim - 1e-4).all()


def test_adamw_one_update_and_cosine_lr():
    tc = TrainConfig(lr=3e-2, warmup_steps=5, total_steps=50,
                     weight_decay=1e-3, grad_clip=1.0)
    # exact through the warmup (the cosine of 0); after it within one f32
    # ulp of the cosine term: XLA's f32 cos and torch's round apart by an
    # ulp at some arguments (3 of the 55 steps here)
    for s in range(56):
        got = np_(adamw.cosine_lr(tc, torch.tensor(s, dtype=torch.int32)))
        want = np_(JADAMW.cosine_lr(tc, jnp.int32(s)))
        if s <= tc.warmup_steps:
            assert got == want, (s, got, want)
        assert abs(float(got) - float(want)) <= tc.lr * 2.0 ** -24, \
            (s, got, want)
    rng = np.random.default_rng(5)
    p = {k: rng.standard_normal(sh).astype(np.float32)
         for k, sh in (("w1", (7, 24)), ("b1", (24,)), ("w2", (24, 2)))}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
         for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    opt = adamw.init(tp)
    jopt = JADAMW.init({k: jnp.asarray(v) for k, v in p.items()})
    for _ in range(3):   # three updates: the bias correction moves
        tp, opt, om = adamw.update({k: torch.as_tensor(v)
                                    for k, v in g.items()}, opt, tp, tc)
        jp, jopt, jom = JADAMW.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, jopt,
                                      {k: jnp.asarray(v) for k, v in
                                       (p if _ == 0 else jp).items()}, tc)
        for k in p:
            np.testing.assert_allclose(np_(tp[k]), np_(jp[k]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(np_(opt.m[k]), np_(jopt.m[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(np_(opt.v[k]), np_(jopt.v[k]),
                                       rtol=1e-6, atol=1e-7)
        assert int(opt.count) == int(jopt.count)
        np.testing.assert_allclose(np_(om["grad_norm"]),
                                   np_(jom["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(np_(om["lr"]), np_(jom["lr"]),
                                   rtol=0, atol=tc.lr * 2.0 ** -24)


# ---------------------------------------------------------------------------
# features, labels, fit
# ---------------------------------------------------------------------------


def test_run_features_on_reference_traces(j_mini):
    """The reconstruction on the reference's own mini-config traces."""
    _, meta = j_mini
    sim = JLDS.DatasetConfig(**MINI).sim()
    prog = j_get_workload("comd")
    otr = JSIM.run_sim(prog, sim, "oracle")
    hit = JSIM.run_sim(prog, sim, "pcstall")["hit_rate"]
    F = np.asarray(meta["freqs_ghz"], np.float64)
    hit = np.asarray(hit, np.float64)
    rest = (F, meta["e_acc0"], meta["t_acc0"])
    got = LDS._run_features(otr, hit, sim.epoch_us,
                            LDS.DatasetConfig(**MINI).sim(), *rest)
    want = JLDS._run_features(otr, hit, sim.epoch_us, sim, *rest)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_select_fidx_equals_reference(j_mini, t_mini):
    for data, meta in (j_mini, t_mini):
        pbar = data["x"][:, LM.FEATURE_NAMES.index("pbar")]
        got = LDS.select_fidx(data["y"][:, 0], data["y"][:, 1], pbar,
                              data["t_us"], meta)
        want = JLDS.select_fidx(data["y"][:, 0], data["y"][:, 1], pbar,
                                data["t_us"], meta)
        np.testing.assert_array_equal(got, want)
        # the pcstall-trajectory labels are the mirror by construction
        beh = data["policy"] == 1
        np.testing.assert_array_equal(got[beh], data["fidx"][beh])
        assert LDS.choice_accuracy(data["y"], data, meta, beh) == 1.0


def test_mini_dataset_schema_and_determinism(t_mini, tmp_path):
    data, meta = t_mini
    n = data["x"].shape[0]
    assert n == 2 * 2 * (MINI["n_epochs"] - MINI["warmup"]) * MINI["n_cu"]
    assert data["x"].shape == (n, LM.N_FEATURES)
    assert set(np.unique(data["policy"])) == {0, 1}
    for k in ("x", "y", "t_us"):
        assert np.isfinite(data[k]).all(), k
    tr_mask, va_mask = LDS.split_masks(data)
    assert (tr_mask ^ va_mask).all()
    data2, meta2 = LDS.generate_dataset(LDS.DatasetConfig(**MINI,
                                                          device="cpu"))
    a = LDS.save_dataset(tmp_path / "a.npz", data, meta).read_bytes()
    b = LDS.save_dataset(tmp_path / "b.npz", data2, meta2).read_bytes()
    assert a == b


def test_dataset_meta_matches_reference(j_mini, t_mini):
    """The meta carries the engine's ladder (the reference's records its
    eager ladder, one ulp apart at 1.8 GHz); everything else is equal."""
    (_, jm), (_, tm) = j_mini, t_mini
    assert jm.keys() == tm.keys()
    for k in jm:
        if k == "freqs_ghz":
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-7)
            assert tm[k] == [float(f) for f in np_(SIM.PWR.FREQS_GHZ)]
        else:
            assert tm[k] == jm[k], k


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_fit_matches_reference(j_mini, kind):
    data, meta = j_mini
    jp, jc = JLTR.fit(data, meta, kind=kind, steps=FIT_STEPS)
    tp, tc = LTR.fit(data, meta, kind=kind, steps=FIT_STEPS, device="cpu")
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tp[k].dtype == np.float32 and tp[k].shape == jp[k].shape
        err = np.abs(tp[k] - jp[k]).max()
        assert err <= FIT_WTOL * np.abs(jp[k]).max(), (k, err)
    for c in ("probe", "loss"):
        a, b = np.asarray(tc[c]), np.asarray(jc[c])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=FIT_CTOL, atol=0.0,
                                   err_msg=c)
    assert tc["probe"][-1] < tc["probe"][0]
    for k in ("train_mse", "val_mse"):
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-4)
    for k in ("mu_x", "sd_x", "mu_y", "sd_y"):
        np.testing.assert_array_equal(tc["norm"][k], jc["norm"][k])
    assert LTR.reactive_choice_baseline(data, meta, LDS.split_masks(
        data)[1]) == JLTR.reactive_choice_baseline(data, meta,
                                                   JLDS.split_masks(data)[1])


def test_fit_is_deterministic(t_mini):
    p1, c1 = LTR.fit(*t_mini, kind="linear", steps=20, device="cpu")
    p2, c2 = LTR.fit(*t_mini, kind="linear", steps=20, device="cpu")
    assert c1["loss"] == c2["loss"]
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k])


# ---------------------------------------------------------------------------
# hooks (tier 2) and the closed loop (tier 3)
# ---------------------------------------------------------------------------


def _hook_case(seed, CU=8, WF=8, E=16, P=64):
    """A fixed carry and context for both packages, from one numpy draw."""
    rng = np.random.default_rng(seed)
    jprog = j_get_workload("comd", P=P)
    prog = port_program(jprog)
    sim = SIM.SimConfig(n_cu=CU, n_wf=WF, entries=E, offset_blocks=8)
    jsim = JSIM.SimConfig(n_cu=CU, n_wf=WF, entries=E, offset_blocks=8)
    F = np_(SIM.PWR.FREQS_GHZ)
    arrs = dict(
        pos=rng.uniform(0, P * 4, (CU, WF)).astype(np.float32),
        react_i0=rng.uniform(20, 80, CU).astype(np.float32),
        react_sens=rng.uniform(5, 40, CU).astype(np.float32),
        wf_i0=rng.uniform(0, 3, (CU, WF)).astype(np.float32),
        wf_sens=rng.uniform(0, 2, (CU, WF)).astype(np.float32),
        f_prev=F[rng.integers(0, len(F), CU)],
        e_acc=rng.uniform(5, 15, CU).astype(np.float32),
        t_acc=np.float32(rng.uniform(10, 40)))
    tbl = (rng.uniform(0, 3, (CU, E)).astype(np.float32),
           rng.uniform(0, 2, (CU, E)).astype(np.float32),
           (rng.uniform(size=(CU, E)) > 0.4).astype(np.float32))
    carry = interop.carry_from_numpy(
        table=interop.table_from_numpy(*tbl, device="cpu"), device="cpu",
        **arrs)
    jcarry = JSIM.Carry(table=JPRED.PCTable(*map(jnp.asarray, tbl)),
                        **{k: jnp.asarray(v) for k, v in arrs.items()})
    ctx = SIM._epoch_context(prog, carry.pos, prog.n_blocks, 0)
    jctx = JSIM.EpochCtx(*(jnp.asarray(np_(v)).astype(
        jnp.int32 if k == "blk" else jnp.float32)
        for k, v in ctx._asdict().items()))
    I_f = np.sort(rng.uniform(100, 900, (CU, len(F))), -1).astype(
        np.float32)
    return ((carry, ctx, sim.static_part(), sim.axes("cpu")),
            (jcarry, jctx, jsim.static_part(), jsim.axes()), I_f)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_hooks_match_reference_at_fixed_inputs(ref_weights, kind, seed):
    """The port's spec built from the reference's frozen artifact computes
    what the reference's spec computes (tier 2)."""
    jparams, params = ref_weights[kind]
    spec = LMECH.make_learned_spec("learned_h", params)
    jspec = JLMECH.make_learned_spec("learned_h", jparams)
    (c, x, st, ax), (jc, jx, jst, jax_), I_f = _hook_case(seed)
    want = np_(jspec.predict(jc, jx, jst, jax_))
    got = np_(spec.predict(c, x, st, ax))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(
        np_(LMECH.epoch_features(c, x, st, ax)),
        np_(JLMECH.epoch_features(jc, jx, jst, jax_)), rtol=1e-6,
        atol=1e-6)
    got_u = spec.update({}, None, torch.as_tensor(I_f), c, x, st, ax)
    want_u = jspec.update({}, None, jnp.asarray(I_f), jc, jx, jst, jax_)
    for g, w in zip(got_u, want_u):
        np.testing.assert_allclose(np_(g), np_(w), rtol=1e-5, atol=1e-5)


_jit_scan = jax.jit(JSIM._scan_sim, static_argnames=("st", "mech"))


def _jax_carry(c):
    return JSIM.Carry(*(JPRED.PCTable(*(jnp.asarray(np_(t)) for t in v))
                        if f == "table" else jnp.asarray(np_(v))
                        for f, v in zip(c._fields, c)))


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_learned_closed_loop_lockstep(ref_weights, monkeypatch, kind):
    """Tier 3: at every epoch of the port's learned run the reference is
    started from the port's carry for one epoch, on integer-keyed noise;
    the epoch's outputs agree to 1e-5 and fidx is equal."""
    lockstep_noise(monkeypatch)
    jparams, params = ref_weights[kind]
    spec = LMECH.make_learned_spec(f"learned_ls_{kind}", params)
    jspec = JLMECH.make_learned_spec(f"learned_ls_{kind}", jparams)
    jprog = j_get_workload("comd")
    prog = port_program(jprog)
    CU, WF = 8, 10
    jsim = JSIM.SimConfig(n_cu=CU, n_wf=WF, n_epochs=1)
    sim = SIM.SimConfig(n_cu=CU, n_wf=WF, n_epochs=1)
    st = sim.static_part()
    step = SIM._make_step(prog, prog.n_blocks, 0, st, sim.axes("cpu"), spec)
    carry = SIM.init_carry(prog.n_blocks, st, "cpu")
    for ep in range(40):
        want = _jit_scan(jprog, jnp.int32(jprog.n_blocks), jnp.int32(0),
                         st=jsim.static_part(), ax=jsim.axes(), mech=jspec,
                         carry0=_jax_carry(carry))
        carry, ys = step(carry)
        assert ys.keys() == want.keys()
        for k, v in want.items():
            got, ref = np_(ys[k]), np_(v)[0]
            if k == "fidx":
                np.testing.assert_array_equal(got, ref, err_msg=f"ep {ep}")
            else:
                np.testing.assert_allclose(
                    got, ref, rtol=1e-5,
                    atol=1e-5 * float(np.abs(ref).max(initial=1.0)),
                    err_msg=f"ep {ep} {k}")


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------


def test_param_hook_value_equality():
    pa = LM.init_linear(0)
    h1 = ParamHook(LMECH.learned_predict, pa)
    h2 = ParamHook(LMECH.learned_predict,
                   {k: v.copy() for k, v in pa.items()})
    assert h1 == h2 and hash(h1) == hash(h2)
    pb = {k: v + 1.0 for k, v in pa.items()}
    assert h1 != ParamHook(LMECH.learned_predict, pb)
    assert h1 != ParamHook(LMECH.learned_update, pa)
    s1 = LMECH.make_learned_spec("learned_eq", pa)
    s2 = LMECH.make_learned_spec("learned_eq",
                                 {k: v.copy() for k, v in pa.items()})
    assert s1 == s2 and hash(s1) == hash(s2)
    assert s1 != LMECH.make_learned_spec("learned_eq", pb)
    # the device copies are made once per device and reused
    assert h1.tensors("cpu") is h1.tensors("cpu")


def test_weight_swap_rebuilds_nothing_of_the_fork_family(progs):
    sim = SIM.SimConfig(**GRID_SIM)
    pa = LM.init_linear(0)
    pb = {k: v + 0.25 for k, v in pa.items()}
    sa = LMECH.make_learned_spec("learned_swap", pa)
    SW.run_grid(progs, sim, [{}], ("crisp", sa))
    SW.reset_counters()
    SW.run_grid(progs, sim, [{}],
                ("crisp", LMECH.make_learned_spec("learned_swap", pb)))
    assert SW.TRACE_COUNTS.get("grid_forks", 0) == 0, dict(SW.TRACE_COUNTS)
    assert SW.TRACE_COUNTS.get("grid_learned_swap", 0) == 1
    SW.reset_counters()
    sa2 = LMECH.make_learned_spec("learned_swap",
                                  {k: v.copy() for k, v in pa.items()})
    got = SW.run_grid(progs, sim, [{}], ("crisp", sa2))
    assert sum(SW.TRACE_COUNTS.values()) == 0, dict(SW.TRACE_COUNTS)
    want = SW.run_grid(progs, sim, [{}], ("crisp", sa))
    for w in WORKLOADS:
        for ch in ("work", "energy", "fidx"):
            np.testing.assert_array_equal(got[()][w]["learned_swap"][ch],
                                          want[()][w]["learned_swap"][ch])


def test_learned_grid_equals_per_point_runs(progs):
    """Grid rows equal per-point dispatch and run_sim bit for bit; the pc
    spec runs one row per point (every axis live), a static collapses the
    objective, and the mixed sweep builds the fork family at most twice."""
    sim = SIM.SimConfig(**GRID_SIM)
    spec = LMECH.make_learned_spec("learned_t", LM.init_mlp(3))
    objs = ["ed2p", "deadline05"]
    SW.reset_counters()
    grid = SW.run_grid(progs, sim, {"objective": objs},
                       ("static17", "crisp", "pcstall", "oracle", spec))
    assert SW.TRACE_COUNTS.get("grid_forks", 0) <= 2
    W, G = len(progs), len(objs)
    assert SW.DISPATCH_ROWS["grid_learned_t"] == W * G
    assert SW.DISPATCH_ROWS["grid_static17"] == W
    assert SW.DISPATCH_ROWS["grid_forks"] == W * G * 2
    for obj in objs:
        one = dataclasses.replace(sim, objective=obj)
        suite = SW.run_suite(progs, one, (spec,))
        for w in WORKLOADS:
            alone = SIM.run_sim(progs[w], one, spec)
            for ch in ("work", "energy", "err", "fidx", "hit_rate"):
                got = grid[(obj,)][w]["learned_t"][ch]
                np.testing.assert_array_equal(got, suite[w]["learned_t"][ch])
                np.testing.assert_array_equal(got, alone[ch])


def test_learned_specs_register_audited():
    from repro_torch.analysis.deps import (axis_liveness,
                                           require_dedup_sound)
    for name, kind in (("learned_lin", "linear"), ("learned_mlp", "mlp")):
        spec = LMECH.register_learned(name, LM.INIT[kind](0))
        try:
            assert spec.exec_axes == MECH.SIM_AXES_FIELDS
            assert MECH.get(name) == spec
            res = axis_liveness(spec)
            assert res.exact, res
            require_dedup_sound(spec)
            # the reference derives the same channels for its own spec
            jres = JDEPS.axis_liveness(
                JLMECH.make_learned_spec(name, JLM.INIT[kind](0)))
            assert res.per_output == jres.per_output
        finally:
            MECH.unregister(name)
    assert "learned_lin" not in JMECH.names()


def test_cli_mini_runs_on_the_cpu(tmp_path, capsys):
    assert CLI.main(["--mini", "--device", "cpu", "--steps", "30",
                     "--kind", "both", "--out", str(tmp_path)]) == 0
    rep = (tmp_path / "report.json").read_text()
    for kind in ("linear", "mlp"):
        assert f'"{kind}"' in rep
        w, meta = LTR.load_weights(tmp_path / f"weights_{kind}.npz")
        assert meta["kind"] == kind and meta["steps"] == 30
    assert "learned_lin" not in MECH.names()
