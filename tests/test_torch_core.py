"""Tier 1 of the port's parity: open-loop functions, exact or to 1e-6
relative, against the live JAX reference on the same numpy inputs.

Elementwise functions run eagerly on both sides with the same op order, so
most agree bitwise; the stated 1e-6 covers last-ulp differences of a
different reduction order or math library."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import np_, port_power, t_  # noqa: E402
from repro.core import estimators as JEST  # noqa: E402
from repro.core import mechanisms as JMECH  # noqa: E402
from repro.core import power as JPWR  # noqa: E402
from repro.core import predictors as JPRED  # noqa: E402
from repro.core import simulate as JSIM  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro_torch import interop, resolve_device  # noqa: E402
from repro_torch.core import estimators as EST  # noqa: E402
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import power as PWR  # noqa: E402
from repro_torch.core import predictors as PRED  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core import workloads as W  # noqa: E402

RTOL = 1e-6
RNG_SEED = 1234

# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JW.WORKLOAD_TABLE))
def test_workload_rates_byte_equal(name):
    """Same numpy RNG streams: the rate arrays are byte-equal; the packed
    prefix sums (an f32 cumsum on each side) agree to 1e-6 relative."""
    ref = JW.get_workload(name)
    got = W.get_workload(name, device="cpu")
    assert got.n_blocks == ref.n_blocks and got.name == name
    for f in ("i0_rate", "sens_rate", "mem_frac"):
        a, b = np_(getattr(got, f)), np_(getattr(ref, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # relative to each column's scale (the prefix sums grow from 0)
    scale = np.abs(np_(ref.cum3)).max(axis=0)
    np.testing.assert_allclose(np_(got.cum3) / scale, np_(ref.cum3) / scale,
                               rtol=0, atol=RTOL)
    np.testing.assert_array_equal(np_(got.cum_sens), np_(got.cum3)[:, 1])


def test_workload_table_and_cpu_request():
    assert W.WORKLOAD_TABLE == JW.WORKLOAD_TABLE
    assert W.INSTR_PER_BLOCK == JW.INSTR_PER_BLOCK
    progs = W.all_workloads(P=64, device="cpu")
    assert list(progs) == list(JW.WORKLOAD_TABLE)
    assert all(p.device.type == "cpu" and p.n_blocks == 64
               for p in progs.values())


def test_cuda_request_without_card_raises(monkeypatch):
    """Asking for the card where there is none raises and says how to run
    on the CPU; nothing carries on quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.get_workload("comd")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_interop_program_is_bit_exact():
    ref = JW.get_workload("hacc", P=128)
    got = interop.program_from_numpy(
        "hacc", *(np_(getattr(ref, f)) for f in
                  ("i0_rate", "sens_rate", "mem_frac", "cum3")),
        device="cpu")
    for f in ("i0_rate", "sens_rate", "mem_frac", "cum3"):
        assert np_(getattr(got, f)).tobytes() == \
            np_(getattr(ref, f)).tobytes()


# ---------------------------------------------------------------------------
# power model
# ---------------------------------------------------------------------------


def test_default_ladder_bitwise():
    assert np_(PWR.FREQS_GHZ).tobytes() == np_(JPWR.FREQS_GHZ).tobytes()
    assert np_(PWR.freqs_ghz(PWR.DEFAULT.axes("cpu"), 10)).tobytes() \
        == np_(JPWR.FREQS_GHZ).tobytes()


@pytest.mark.parametrize("pw", [
    JPWR.DEFAULT,
    JPWR.PowerConfig(f_min=1.0, f_max=2.5, v_min=0.6, v_max=1.1,
                     lat_per_us=0.04, n_freqs=7)], ids=["default", "off"])
def test_power_model_matches_reference(pw):
    rng = np.random.default_rng(RNG_SEED)
    tpw = port_power(pw)
    for jp, tp in ((pw, tpw), (pw.axes(), tpw.axes("cpu"))):
        np.testing.assert_allclose(np_(PWR.freqs_ghz(tp, pw.n_freqs)),
                                   np_(JPWR.freqs_ghz(jp, pw.n_freqs)),
                                   rtol=RTOL)
        f = rng.uniform(pw.f_min, pw.f_max, 64).astype(np.float32)
        f2 = rng.uniform(pw.f_min, pw.f_max, 64).astype(np.float32)
        act = rng.uniform(-0.2, 1.3, 64).astype(np.float32)
        pairs = [
            (PWR.v_of_f(t_(f), tp), JPWR.v_of_f(jnp.asarray(f), jp)),
            (PWR.ivr_eta(t_(f), tp), JPWR.ivr_eta(jnp.asarray(f), jp)),
            (PWR.power(t_(f), t_(act), tp),
             JPWR.power(jnp.asarray(f), jnp.asarray(act), jp)),
            (PWR.transition_energy(t_(f), t_(f2), tp),
             JPWR.transition_energy(jnp.asarray(f), jnp.asarray(f2), jp))]
        for got, want in pairs:
            np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL)
        for epoch_us in (1.0, 10.0, 500.0):
            np.testing.assert_allclose(
                float(PWR.transition_latency_us(epoch_us, tp)),
                float(JPWR.transition_latency_us(epoch_us, jp)), rtol=RTOL)


# ---------------------------------------------------------------------------
# predictors and estimators
# ---------------------------------------------------------------------------


def _table(rng, T, E):
    return (rng.uniform(0, 60, (T, E)).astype(np.float32),
            rng.uniform(0, 40, (T, E)).astype(np.float32),
            (rng.integers(0, 3, (T, E))).astype(np.float32))


def test_table_index_and_lookup_exact():
    rng = np.random.default_rng(RNG_SEED)
    T, E, CU, WF = 4, 16, 8, 6
    blk = rng.integers(0, 1024, (CU, WF))
    got_idx = PRED.table_index(torch.as_tensor(blk), E, 8)
    want_idx = JPRED.table_index(jnp.asarray(blk), E, 8)
    np.testing.assert_array_equal(np_(got_idx), np_(want_idx))
    tbl = _table(rng, T, E)
    tid = np.arange(CU) % T
    fb = [rng.uniform(0, 9, (CU, WF)).astype(np.float32) for _ in range(2)]
    got = PRED.table_lookup(PRED.PCTable(*map(t_, tbl)),
                            torch.as_tensor(tid), got_idx, *map(t_, fb))
    want = JPRED.table_lookup(JPRED.PCTable(*map(jnp.asarray, tbl)),
                              jnp.asarray(tid), want_idx,
                              *map(jnp.asarray, fb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np_(w))


@pytest.mark.parametrize("ema", [0.5, 0.2])
def test_table_update_without_collisions_exact(ema):
    """Each WF hits its own slot: no collision sums, so the update is the
    same elementwise arithmetic on both sides, bit for bit."""
    rng = np.random.default_rng(RNG_SEED)
    T, E, CU, WF = 4, 32, 8, 4
    tbl = _table(rng, T, E)
    tid = np.arange(CU) % T                 # two CUs per table
    # CU c uses slots 4*(c // T) + w of table c % T: all distinct
    idx = (np.arange(CU)[:, None] // T) * WF + np.arange(WF)[None, :]
    i0 = rng.uniform(0, 60, (CU, WF)).astype(np.float32)
    se = rng.uniform(0, 40, (CU, WF)).astype(np.float32)
    got = PRED.table_update(PRED.PCTable(*map(t_, tbl)),
                            torch.as_tensor(tid), torch.as_tensor(idx),
                            t_(i0), t_(se), ema)
    want = JPRED.table_update(JPRED.PCTable(*map(jnp.asarray, tbl)),
                              jnp.asarray(tid), jnp.asarray(idx),
                              jnp.asarray(i0), jnp.asarray(se), ema)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np_(w))


def test_table_update_collisions_and_dropped_tables():
    """Collisions average; an out-of-range table id drops its updates."""
    rng = np.random.default_rng(RNG_SEED + 1)
    T, E, CU, WF = 3, 8, 5, 6
    tbl = _table(rng, T, E)
    tid = np.array([0, 1, 2, 3, 7])
    idx = rng.integers(0, E, (CU, WF))
    i0 = rng.uniform(0, 60, (CU, WF)).astype(np.float32)
    se = rng.uniform(0, 40, (CU, WF)).astype(np.float32)
    got = PRED.table_update(PRED.PCTable(*map(t_, tbl)),
                            torch.as_tensor(tid), torch.as_tensor(idx),
                            t_(i0), t_(se), 0.5)
    want = JPRED.table_update(JPRED.PCTable(*map(jnp.asarray, tbl)),
                              jnp.asarray(tid), jnp.asarray(idx),
                              jnp.asarray(i0), jnp.asarray(se), 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), rtol=RTOL)
    assert float(np_(got.count).sum() - tbl[2].sum()) == 3 * WF


def _counters(rng, CU, WF):
    return {"committed": rng.uniform(0, 120, (CU, WF)).astype(np.float32),
            "core_frac": rng.uniform(0, 1, (CU, WF)).astype(np.float32),
            "issue_q": rng.uniform(0, 1, (CU, WF)).astype(np.float32)}


def test_wf_stall_estimate_matches_reference():
    rng = np.random.default_rng(RNG_SEED)
    c = _counters(rng, 6, 9)
    # exact sixteenths put the quantiser on its half-way ties
    c["core_frac"][0] = (np.arange(9) + 0.5) / 16.0
    f = rng.uniform(1.3, 2.2, 6).astype(np.float32)
    got = EST.wf_stall_estimate({k: t_(v) for k, v in c.items()}, t_(f))
    want = JEST.wf_stall_estimate({k: jnp.asarray(v) for k, v in c.items()},
                                  jnp.asarray(f))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), rtol=RTOL)


@pytest.mark.parametrize("model", JEST.CU_MODELS)
def test_cu_estimate_matches_reference(model):
    assert EST.CU_MODELS == JEST.CU_MODELS
    rng = np.random.default_rng(RNG_SEED)
    c = _counters(rng, 6, 9)
    f = rng.uniform(1.3, 2.2, 6).astype(np.float32)
    got = EST.cu_estimate({k: t_(v) for k, v in c.items()}, t_(f), model)
    want = JEST.cu_estimate({k: jnp.asarray(v) for k, v in c.items()},
                            jnp.asarray(f), model)
    # i0 = I_cu - sens*f cancels: its error is relative to I_cu's scale
    scale = float(c["committed"].sum(-1).max())
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), rtol=RTOL,
                                   atol=RTOL * scale)
    with pytest.raises(ValueError):
        EST.cu_estimate({k: t_(v) for k, v in c.items()}, t_(f), "nope")


# ---------------------------------------------------------------------------
# objective lowering and frequency selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["edp", "ed2p", "perfcap05",
                                       "perfcap20", "deadline10",
                                       "deadline03"])
def test_objective_weights_exact(objective):
    np.testing.assert_array_equal(SIM.objective_weights(objective),
                                  JSIM.objective_weights(objective))


@pytest.mark.parametrize("bad", ["edq", "deadline", "deadline5x", ""])
def test_objective_weights_rejects(bad):
    with pytest.raises(ValueError):
        JSIM.objective_weights(bad)
    with pytest.raises(ValueError):
        SIM.objective_weights(bad)


@pytest.mark.parametrize("objective,cpd", [("ed2p", 1), ("edp", 2),
                                           ("perfcap10", 1),
                                           ("deadline05", 4)])
def test_select_freq_matches_reference(objective, cpd):
    rng = np.random.default_rng(RNG_SEED)
    CU, WF = 8, 10
    jsim = JSIM.SimConfig(n_cu=CU, n_wf=WF, cus_per_domain=cpd,
                          objective=objective)
    tsim = SIM.SimConfig(n_cu=CU, n_wf=WF, cus_per_domain=cpd,
                         objective=objective)
    F = np_(JPWR.FREQS_GHZ)
    i0 = rng.uniform(100, 3000, CU).astype(np.float32)
    se = rng.uniform(100, 2000, CU).astype(np.float32)
    I = np.clip((i0[:, None] + se[:, None] * F[None]),
                0, 5500 * F[None] * WF).astype(np.float32)
    pbar = rng.uniform(0.2, 3.0, CU // cpd).astype(np.float32)
    got = SIM._select_freq(t_(I), tsim.static_part(), tsim.axes("cpu"),
                           t_(pbar))
    want = JSIM._select_freq(jnp.asarray(I), jsim.static_part(), jsim.axes(),
                             jnp.asarray(pbar))
    np.testing.assert_array_equal(np_(got), np_(want))
    got_p = SIM._predict_instr(t_(i0), t_(se), tsim.static_part(),
                               tsim.axes("cpu"))
    want_p = JSIM._predict_instr(jnp.asarray(i0), jnp.asarray(se),
                                 jsim.static_part(), jsim.axes())
    np.testing.assert_allclose(np_(got_p), np_(want_p), rtol=RTOL)


def test_init_carry_and_seed_fold_match_reference():
    st_j = JSIM.SimConfig(n_cu=6, n_wf=7).static_part()
    st_t = SIM.SimConfig(n_cu=6, n_wf=7).static_part()
    a = JSIM.init_carry(100, st_j)
    b = SIM.init_carry(100, st_t, "cpu")
    for f in ("pos", "react_i0", "react_sens", "wf_i0", "wf_sens", "f_prev",
              "e_acc", "t_acc"):
        np.testing.assert_array_equal(np_(getattr(b, f)),
                                      np_(getattr(a, f)), err_msg=f)
    for ga, gb in zip(a.table, b.table):
        np.testing.assert_array_equal(np_(gb), np_(ga))
    seeds = [0, 7, 2**31, 2**40 + 5, -3]
    np.testing.assert_array_equal(SIM.seed_i32(seeds), JSIM.seed_i32(seeds))


# ---------------------------------------------------------------------------
# mechanism registry
# ---------------------------------------------------------------------------


def test_builtin_registry_matches_reference():
    assert MECH.BUILTIN_NAMES == JMECH.BUILTIN_NAMES
    assert MECH.SIM_AXES_FIELDS == JMECH.SIM_AXES_FIELDS
    assert MECH.FAMILIES == JMECH.FAMILIES
    assert SIM.SimAxes._fields == JSIM.SimAxes._fields
    for name in JMECH.BUILTIN_NAMES:
        a, b = JMECH.get(name), MECH.get(name)
        for f in ("family", "exec_axes", "label", "static_fidx",
                  "traced_id", "cu_model", "fork_estimator",
                  "hit_telemetry", "v2_capable", "is_traced",
                  "config_axes", "dedup_axes"):
            assert getattr(a, f) == getattr(b, f), (name, f)
    assert [s.name for s in MECH.fork_specs()] == \
        [s.name for s in JMECH.fork_specs()]
    assert MECH.traced_reactive_count() == JMECH.traced_reactive_count()


_BAD_SPECS = [
    dict(name="x", family="nope", exec_axes=MECH._CTRL),
    dict(name="x", family="static", exec_axes=MECH._EXEC + ("bogus",),
         static_fidx=1),
    dict(name="x", family="static", exec_axes=MECH._EXEC + ("sigma",),
         static_fidx=1),
    dict(name="x", family="static", exec_axes=MECH._EXEC),
    dict(name="x", family="reactive", exec_axes=MECH._CTRL, static_fidx=2,
         predict=len),
    dict(name="x", family="reactive", exec_axes=MECH._CTRL, update=len),
    dict(name="x", family="reactive", exec_axes=MECH._CTRL),
    dict(name="x", family="reactive", exec_axes=MECH._CTRL, predict=len,
         hit_telemetry=True),
    dict(name="x", family="pc", exec_axes=MECH._CTRL, predict=len),
]


@pytest.mark.parametrize("kw", _BAD_SPECS,
                         ids=[str(i) for i in range(len(_BAD_SPECS))])
def test_spec_validation_matches_reference(kw):
    with pytest.raises((AssertionError, ValueError)) as want:
        JMECH.MechanismSpec(**kw)
    with pytest.raises((AssertionError, ValueError)) as got:
        MECH.MechanismSpec(**kw)
    assert got.type is want.type


def _table_predict(carry, ctx, st, ax):
    """A pc predictor reading the live PC table (declares _TABLE
    soundly: the audit derives exactly those axes)."""
    tid = torch.div(torch.arange(st.n_cu), st.cus_per_table,
                    rounding_mode="floor")
    idx = PRED.table_index(ctx.blk, st.entries, st.offset_blocks)
    i0, s, _ = PRED.table_lookup(carry.table, tid, idx, carry.wf_i0,
                                 carry.wf_sens)
    return SIM.predict_instr(i0.sum(-1), s.sum(-1), st, ax)


def _sneaky_predict(carry, ctx, st, ax):
    i0 = carry.react_i0 * (1.0 + 0.1 * ax.table_ema)
    return SIM.predict_instr(i0, carry.react_sens, st, ax)


def test_register_resolve_unregister():
    from repro_torch.analysis.deps import AxisLivenessError, axis_liveness
    spec = MECH.MechanismSpec("my_pc", "pc", MECH._TABLE,
                              predict=_table_predict)
    assert not spec.v2_capable and not spec.is_traced
    try:
        # the default registration audits the custom spec
        assert MECH.register(spec) is spec
        assert axis_liveness(spec).exact
        assert MECH.resolve("my_pc") is spec
        assert "my_pc" in MECH.names()
        with pytest.raises(ValueError, match="already registered"):
            MECH.register(spec)
        with pytest.raises(ValueError):
            MECH.register(MECH.get("pcstall"), allow_override=True)
        with pytest.raises(ValueError, match="differs"):
            MECH.resolve(MECH.MechanismSpec("pcstall", "pc", MECH._TABLE,
                                            traced_id=5))
    finally:
        MECH.unregister("my_pc")
    assert "my_pc" not in MECH.names()
    with pytest.raises(KeyError, match="unknown mechanism"):
        MECH.get("my_pc")
    sneaky = MECH.MechanismSpec("my_sneaky", "reactive", MECH._CTRL,
                                predict=_sneaky_predict)
    with pytest.raises(AxisLivenessError, match="table_ema"):
        MECH.register(sneaky, verify_axes=True)
    assert "my_sneaky" not in MECH.names()
    with pytest.raises(AssertionError):
        MECH.register(MECH.MechanismSpec("t", "reactive", MECH._CTRL,
                                         traced_id=9))


def test_interop_carry_and_axes_from_reference():
    """The reference's initial carry and packed scalar operands carried
    over through ``interop`` equal the port's own construction."""
    from repro.kernels import epoch_fused as JKEF
    jsim = JSIM.SimConfig(n_cu=6, n_wf=7, objective="deadline05",
                          power=JPWR.PowerConfig(lat_per_us=0.02))
    sim = SIM.SimConfig(n_cu=6, n_wf=7, objective="deadline05",
                        power=port_power(jsim.power))
    jc = JSIM.init_carry(100, jsim.static_part())
    got = interop.carry_from_numpy(
        **{f: np_(getattr(jc, f)) for f in jc._fields if f != "table"},
        table=tuple(np_(x) for x in jc.table), device="cpu")
    want = SIM.init_carry(100, sim.static_part(), "cpu")
    for f in want._fields:
        for g, w in zip(np.atleast_1d(getattr(got, f)),
                        np.atleast_1d(getattr(want, f))):
            np.testing.assert_array_equal(np_(g), np_(w), err_msg=f)
    jax_ax = jsim.axes()
    scal = JKEF._pack_scal(jax_ax.epoch_us, jax_ax.sigma, jax_ax.cap_per_ghz,
                           jax_ax.membw, jax_ax.table_ema, jax_ax.obj,
                           JPWR.transition_latency_us(jax_ax.epoch_us,
                                                      jax_ax.power))
    pw_vec = np.stack([np_(getattr(jax_ax.power, f))
                       for f in JPWR.PowerAxes._fields])
    ax = interop.sim_axes_from_numpy(np_(scal), pw_vec, jsim.n_epochs, "cpu")
    own = sim.axes("cpu")
    for f in SIM.SimAxes._fields:
        a, b = getattr(ax, f), getattr(own, f)
        if f == "power":
            for x, y in zip(a, b):
                assert np_(x).tobytes() == np_(y).tobytes()
        else:
            assert np_(a).tobytes() == np_(b).tobytes(), f
