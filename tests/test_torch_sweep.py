"""The port's batched sweep layer (``repro_torch.core.sweep``) against the
JAX reference's (``repro.core.sweep``), and the port's own contracts.

Everything runs on the CPU at a small size (8 CUs x 10 WFs, programs of
96 and 64 blocks, at most 40 epochs): the kernel engine's wrappers take
their plain versions here, so ``use_pallas=True`` runs the fork family's
plain version (K4's) row by row.

Against the reference:

* programs: ``pad_program``/``_stack_programs`` give the same bits;
* tier 3: ``run_grid`` on a 2 x 2 ``epoch_us`` x ``objective`` grid for
  static17, crisp, pcstall, accpc and the oracle, with both packages fed
  the same integer-keyed noise (``_torch_parity.lockstep_noise``; the
  sin hash turns one ulp into O(1) noise, so the two hashes cannot be
  compared). Per epoch the traces agree to 1e-5 up to their first
  divergence, which must come no earlier than ``MIN_AGREE``: the two
  engines round differently in the last ulp (the reference's jitted CPU
  code contracts multiply-adds into FMAs), and a ulp of position that
  crosses a PC-block boundary re-keys a wavefront's noise, after which
  the runs part. Run-level work and energy stay within the whole-run
  bound ``AGG_TOL`` of ``tests/test_torch_simulate.py``;
* the dispatch accounting (``DISPATCH_ROWS``) of three grids, with the
  reference's executables stubbed out (the accounting runs before them);
* ``suite_metrics`` on identical traces, and the clean errors.

Inside the port, bit for bit: suite = one-point grid = per-point grid =
streamed ``GridExecutor`` rows, the ``max_mask_ratio`` buckets, the seed
axis, ``dedup=False``, and the batched step against the one-row step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import lockstep_noise, np_, port_program  # noqa: E402
from repro.core import power as JPWR  # noqa: E402
from repro.core import simulate as JSIM  # noqa: E402
from repro.core import sweep as JSW  # noqa: E402
from repro.core.workloads import get_workload as j_get_workload  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import power as PWR  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402

CU, WF = 8, 10
WORKLOADS = (("comd", 96), ("hacc", 64))
MECHS = ("static17", "crisp", "pcstall", "accpc", "oracle")
GRID = {"epoch_us": [1.0, 10.0], "objective": ["ed2p", "edp"]}
# per-epoch tier, as tests/test_torch_simulate.py
RTOL = ATOL = 1e-5
MIN_AGREE = 30
AGG_TOL = 2e-3
# tier 3's SimConfig: 64 table entries and 41 epochs make its SimStatic
# one no other test traces, so the reference's cached executables built
# under the swapped noise are never shared
TIER3 = dict(n_cu=CU, n_wf=WF, n_epochs=41, entries=64)


@pytest.fixture(scope="module")
def jprogs():
    return {n: j_get_workload(n, P=P) for n, P in WORKLOADS}


@pytest.fixture(scope="module")
def progs(jprogs):
    return {n: port_program(p) for n, p in jprogs.items()}


def _same(a, b, what=""):
    """Two ``{workload: {mechanism: trace}}`` results, bit for bit."""
    assert a.keys() == b.keys()
    for w in a:
        assert a[w].keys() == b[w].keys()
        for m in a[w]:
            assert a[w][m].keys() == b[w][m].keys(), (w, m)
            for k in a[w][m]:
                np.testing.assert_array_equal(a[w][m][k], b[w][m][k],
                                              err_msg=f"{what} {w}/{m}/{k}")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_pad_and_stack_programs_match_reference(jprogs, progs):
    for name, jp in jprogs.items():
        for p_max in (jp.n_blocks, 128):
            want = JSW.pad_program(jp, p_max)
            got = SW.pad_program(progs[name], p_max)
            for f in ("i0_rate", "sens_rate", "mem_frac", "cum3"):
                np.testing.assert_array_equal(np_(getattr(got, f)),
                                              np_(getattr(want, f)),
                                              err_msg=f"{name} {p_max} {f}")
    jst, jpl = JSW._stack_programs(list(jprogs.values()))
    tst, tpl = SW._stack_programs(list(progs.values()))
    np.testing.assert_array_equal(tpl, np_(jpl))
    fields = ("i0_rate", "sens_rate", "mem_frac", "cum3")
    via = interop.stacked_programs_from_numpy(
        *(np_(getattr(jst, f)) for f in fields), device="cpu")
    for f in fields:
        np.testing.assert_array_equal(np_(getattr(tst, f)),
                                      np_(getattr(jst, f)), err_msg=f)
        assert torch.equal(getattr(via, f), getattr(tst, f)), f


def test_row_carries_and_axes_match_reference():
    """The batched initial carry and a stacked grid point, carried over
    from the reference's numpy rows, equal the port's own."""
    pb = np.asarray([96, 64, 80], np.int32)
    cfg = SIM.SimConfig(n_cu=CU, n_wf=WF, n_epochs=9, epoch_us=2.0,
                        objective="edp")
    st = JSIM.SimConfig(n_cu=CU, n_wf=WF).static_part()
    jc = [JSIM.init_carry(jnp.int32(p), st) for p in pb]
    rows = {f: np.stack([np_(getattr(c, f)) for c in jc])
            for f in JSIM.Carry._fields if f != "table"}
    table = tuple(np.stack([np_(getattr(c.table, k)) for c in jc])
                  for k in ("i0", "sens", "count"))
    via = interop.carry_rows_from_numpy(**rows, table=table, device="cpu")
    own = SIM.init_carry(torch.as_tensor(pb), cfg.static_part(), "cpu")
    for f, a, b in zip(SIM.Carry._fields, via, own):
        if f == "table":
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b), f
    jax_ax = JSIM.SimConfig(n_cu=CU, n_wf=WF, n_epochs=9, epoch_us=2.0,
                            objective="edp").axes()
    scal = np.concatenate([[float(jax_ax.epoch_us), float(jax_ax.sigma),
                            float(jax_ax.cap_per_ghz), float(jax_ax.membw),
                            float(jax_ax.table_ema)], np_(jax_ax.obj), [0.0]])
    pw = np.stack([np_(getattr(jax_ax.power, f))
                   for f in JPWR.PowerAxes._fields])
    ax = interop.sim_axes_rows_from_numpy(np.stack([scal] * 3),
                                          np.stack([pw] * 3), [9] * 3,
                                          device="cpu")
    one = cfg.axes("cpu")
    for f in SIM.SimAxes._fields:
        a, b = getattr(ax, f), getattr(one, f)
        if f == "power":
            assert all(torch.equal(x, y.expand(3)) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b.expand((3,) + b.shape)), f


@pytest.mark.parametrize("use_pallas", [False, "v2"])
def test_run_grid_matches_reference(jprogs, progs, monkeypatch, use_pallas):
    JSW._grid_exec.cache_clear()
    lockstep_noise(monkeypatch)
    try:
        want = JSW.run_grid(jprogs, JSIM.SimConfig(**TIER3,
                                                   use_pallas=use_pallas),
                            GRID, MECHS)
    finally:
        JSW._grid_exec.cache_clear()
    got = SW.run_grid(progs, SIM.SimConfig(**TIER3, use_pallas=use_pallas),
                      GRID, MECHS)
    n_ep = TIER3["n_epochs"]
    assert got.keys() == want.keys()
    for key in want:
        for w in jprogs:
            for m in MECHS:
                a, b = got[key][w][m], want[key][w][m]
                assert a.keys() == b.keys(), (key, w, m)
                ok = np.ones(n_ep, bool)
                for k in b:
                    assert a[k].shape == b[k].shape, (key, w, m, k)
                    x, y = a[k].reshape(n_ep, -1), b[k].reshape(n_ep, -1)
                    if k == "fidx":
                        ok &= (x == y).all(1)
                    else:
                        tol = ATOL + RTOL * np.abs(y).max(1, keepdims=True)
                        ok &= (np.abs(x - y) <= tol + RTOL * np.abs(y)).all(1)
                first = int(np.argmin(ok)) if not ok.all() else n_ep
                assert first >= MIN_AGREE, \
                    f"{key} {w} {m}: runs part at epoch {first}"
                for k in ("work", "energy"):
                    s_a = a[k].sum(dtype=np.float64)
                    s_b = b[k].sum(dtype=np.float64)
                    assert abs(s_a - s_b) <= AGG_TOL * abs(s_b), \
                        (key, w, m, k, s_a, s_b)


def _stub_reference_executables(monkeypatch):
    """Replace the reference's grid executables (and its carry builder)
    with zero-filled outputs of the right shapes: ``DISPATCH_ROWS`` is
    counted before them, so its accounting runs as it is."""
    def grid_exec(st, n_dev, mechanism):
        def dispatch(carry0, progs, p_log, axes, seeds, mech_ids):
            lead = (p_log.shape[0], seeds.shape[0])
            if mechanism is None:
                lead += (mech_ids.shape[0],)

            def z(*shape, dtype=np.float32):
                return np.zeros(lead + (st.n_epochs,) + shape, dtype)
            return {"work": z(st.n_cu), "energy": z(st.n_cu),
                    "err": z(st.n_cu), "fidx": z(st.n_cu, dtype=np.int8),
                    "true_sens": z(st.n_cu), "hit_rate": z()}
        return dispatch
    monkeypatch.setattr(JSW, "_grid_exec", grid_exec)
    monkeypatch.setattr(JSW, "_carry_builder", lambda st: lambda pb: None)


@pytest.mark.parametrize("grid", [
    {"epoch_us": [1.0, 10.0], "sigma": [0.06, 0.1]},
    {"objective": ["ed2p", "edp", "perfcap10"], "epoch_us": [1.0, 2.0]},
    {"table_ema": [0.3, 0.5, 0.8]},
], ids=["no-dead-axis", "objective", "table_ema"])
def test_dispatch_rows_match_reference(jprogs, progs, monkeypatch, grid):
    """Rows per family as the reference counts them: a grid with no dead
    axis dispatches every row; an objective axis collapses the statics;
    a table_ema axis collapses the reactive mechanisms and the oracle."""
    mechs = ("static17", "static22", "crisp", "accreac", "pcstall", "accpc",
             "oracle")
    _stub_reference_executables(monkeypatch)
    JSW.reset_counters()
    JSW.run_grid(jprogs, JSIM.SimConfig(n_cu=4, n_wf=4, n_epochs=2), grid,
                 mechs)
    SW.reset_counters()
    SW.run_grid(progs, SIM.SimConfig(n_cu=4, n_wf=4, n_epochs=2), grid,
                mechs)
    assert dict(SW.DISPATCH_ROWS) == dict(JSW.DISPATCH_ROWS)
    assert SW.DISPATCH_ROWS["grid_forks"] > 0


def test_suite_metrics_matches_reference():
    """Both packages' metrics on the same numpy traces."""
    rng = np.random.default_rng(5)
    mechs = ("static17", "static22", "crisp", "pcstall", "oracle")
    traces = {w: {m: {"work": rng.uniform(50, 400, (120, 6)).astype(
        np.float32), "energy": rng.uniform(1, 3, (120, 6)).astype(
        np.float32), "err": rng.uniform(0, 1.5, (120, 6)).astype(np.float32)}
        for m in mechs} for w in ("a", "b")}
    traces["b"]["crisp"]["work"][:, :] *= 0.5    # extrapolated budget
    for n in (1, 2):
        want = JSW.suite_metrics(None, JSIM.SimConfig(), mechs, n=n,
                                 traces=traces)
        got = SW.suite_metrics(None, SIM.SimConfig(), mechs, n=n,
                               traces=traces)
        assert got.keys() == want.keys()
        for w in want:
            for m in mechs:
                assert got[w][m].keys() == want[w][m].keys()
                for k, v in want[w][m].items():
                    np.testing.assert_array_equal(got[w][m][k], v,
                                                  err_msg=f"{w}/{m}/{k}")


@pytest.mark.parametrize("grid", [
    {"n_cu": [4]}, {"objective": "edp"},
    [{"epoch_us": 1.0}, {"epoch_us": 1.0}],
    [{"epoch_us": 1.0}, {"sigma": 0.1}], {"power": [1.0]},
], ids=["static-axis", "bare-scalar", "duplicate", "mixed-axes",
        "power-value"])
def test_grid_errors_match_reference(jprogs, progs, grid):
    mechs = ("static17", "crisp")
    with pytest.raises(AssertionError):
        JSW.run_grid(jprogs, JSIM.SimConfig(n_cu=4, n_wf=4, n_epochs=2),
                     grid, mechs)
    with pytest.raises(AssertionError):
        SW.run_grid(progs, SIM.SimConfig(n_cu=4, n_wf=4, n_epochs=2), grid,
                    mechs)


def test_executor_errors_match_reference(jprogs, progs):
    for pkg, cfg_cls, pp in ((JSW, JSIM.SimConfig, jprogs),
                             (SW, SIM.SimConfig, progs)):
        cfg = cfg_cls(n_cu=4, n_wf=4, n_epochs=3)
        ex = pkg.GridExecutor(cfg, ("crisp",), p_max=96, buckets=(2,))
        job = (pp["comd"], {})
        for jobs in ([job] * 3, [(pp["comd"], {"n_epochs": 4})],
                     [(pp["comd"], {"n_cu": 8})]):
            with pytest.raises((AssertionError, TypeError)):
                ex.dispatch(jobs)
        with pytest.raises(AssertionError, match="p_max"):
            pkg.GridExecutor(cfg, ("crisp",), p_max=64).dispatch([job])


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

PORT_CFG = SIM.SimConfig(n_cu=CU, n_wf=WF, n_epochs=20)
PORT_MECHS = ("static17", "crisp", "pcstall", "oracle")


@pytest.fixture(scope="module")
def port_grids(progs):
    """The port's 2 x 2 grid on the kernel engine (plain versions here)
    and on the unfused engine."""
    return {up: SW.run_grid(progs, dataclasses.replace(PORT_CFG,
                                                       use_pallas=up),
                            GRID, PORT_MECHS)
            for up in (True, False)}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_suite_is_one_point_grid_bitwise(progs, port_grids, use_pallas):
    cfg = dataclasses.replace(PORT_CFG, use_pallas=use_pallas)
    suite = SW.run_suite(progs, cfg, PORT_MECHS)
    _same(suite, SW.run_grid(progs, cfg, [{}], PORT_MECHS)[()], "1pt")
    # the suite is the grid's default point, whatever shares its dispatch
    _same(suite, port_grids[use_pallas][(1.0, "ed2p")], "grid row")


@pytest.mark.parametrize("use_pallas", [True, False])
def test_grid_rows_equal_per_point_grids(progs, port_grids, use_pallas):
    cfg = dataclasses.replace(PORT_CFG, use_pallas=use_pallas)
    for key, res in port_grids[use_pallas].items():
        pt = dict(zip(GRID, key))
        _same(res, SW.run_grid(progs, cfg, [pt], PORT_MECHS)[key], str(key))


def test_streamed_rows_equal_one_shot(progs, port_grids):
    ex = SW.GridExecutor(PORT_CFG, PORT_MECHS, p_max=96, buckets=(2, 4, 8))
    jobs = [(progs[w], dict(zip(GRID, key)))
            for w in progs for key in port_grids[True]]
    streamed = []
    for lo, hi in ((0, 3), (3, 4), (4, 8)):
        streamed += ex.dispatch(jobs[lo:hi]).traces()
    for (prog, ov), tr in zip(jobs, streamed):
        want = port_grids[True][tuple(ov.values())][prog.name]
        _same({0: tr}, {0: want}, f"{prog.name} {ov}")
    with pytest.raises(ValueError, match="one card"):
        SW.GridExecutor(PORT_CFG, PORT_MECHS, n_dev=2)


def test_grid_engines_agree(port_grids):
    """The kernel engine's fork family against the unfused body, over the
    whole grid: run-level work and energy."""
    for k in ("work", "energy"):
        tot = [sum(float(tr[k].sum(dtype=np.float64))
                   for res in port_grids[up].values()
                   for trs in res.values() for tr in trs.values())
               for up in (True, False)]
        assert abs(tot[0] - tot[1]) <= 1e-3 * abs(tot[1]), (k, tot)


def test_mask_ratio_buckets_and_masked_tail(progs):
    pts = [{"epoch_us": 1.0, "n_epochs": 12}, {"epoch_us": 10.0,
                                               "n_epochs": 4}]
    one = SW.run_grid(progs, PORT_CFG, pts, ("static17", "pcstall"))
    split = SW.run_grid(progs, PORT_CFG, pts, ("static17", "pcstall"),
                        max_mask_ratio=2.0)
    assert list(split) == list(one) == [(1.0, 12), (10.0, 4)]
    for key in one:
        _same(split[key], one[key], str(key))
        assert one[key]["comd"]["pcstall"]["work"].shape == (key[1], CU)
    long = SW.run_grid(progs, PORT_CFG, [{"epoch_us": 10.0,
                                          "n_epochs": 12}], ("pcstall",))
    np.testing.assert_array_equal(
        one[(10.0, 4)]["hacc"]["pcstall"]["work"],
        long[(10.0, 12)]["hacc"]["pcstall"]["work"][:4])


def test_seed_axis(progs):
    cfg = dataclasses.replace(PORT_CFG, n_epochs=8)
    res = SW.run_suite(progs, cfg, ("crisp", "oracle"), seeds=[0, 7])
    for s_i, seed in enumerate((0, 7)):
        one = SW.run_suite(progs, dataclasses.replace(cfg, seed=seed),
                           ("crisp", "oracle"))
        for w in progs:
            for m in ("crisp", "oracle"):
                for k, v in one[w][m].items():
                    assert res[w][m][k].shape == (2,) + v.shape
                    np.testing.assert_array_equal(res[w][m][k][s_i], v)
    assert not np.array_equal(res["comd"]["crisp"]["work"][0],
                              res["comd"]["crisp"]["work"][1])


def test_dedup_flag_and_custom_specs(progs):
    cfg = dataclasses.replace(PORT_CFG, n_epochs=6)
    grid = {"objective": ["ed2p", "edp"], "table_ema": [0.5, 0.8]}
    mechs = ("static17", "crisp", "pcstall", "oracle")
    SW.reset_counters()
    on = SW.run_grid(progs, cfg, grid, mechs)
    rows_on = dict(SW.DISPATCH_ROWS)
    SW.reset_counters()
    off = SW.run_grid(progs, cfg, grid, mechs, dedup=False)
    assert rows_on == {"grid_forks": 2 * 2 + 2 * 4, "grid_static17": 2,
                       "grid_oracle": 2 * 2}
    assert dict(SW.DISPATCH_ROWS) == {"grid_forks": 2 * 4 * 2,
                                      "grid_static17": 8, "grid_oracle": 8}
    for key in on:
        _same(on[key], off[key], str(key))

    def predict(carry, ctx, st, ax):
        return SIM.predict_instr(carry.react_i0, carry.react_sens, st, ax)

    spec = MECH.MechanismSpec("sweep_decay", "reactive", MECH._CTRL,
                              predict=predict)
    # the audited dedup (exec_axes derived exactly) equals the per-point run
    SW.reset_counters()
    audited = SW.run_grid(progs, cfg, grid, ("crisp", spec))
    assert SW.DISPATCH_ROWS["grid_sweep_decay"] == len(progs) * 2
    custom = SW.run_grid(progs, cfg, grid, ("crisp", spec), dedup=False)
    for key in custom:
        _same(audited[key], custom[key], str(key))
    tr = custom[("edp", 0.8)]["hacc"]["sweep_decay"]
    assert set(tr) == {"work", "energy", "err", "fidx", "true_sens"}
    assert np.isfinite(tr["work"]).all() and (tr["work"] > 0).all()

    def sneaky(carry, ctx, st, ax):
        i0 = carry.react_i0 * (1.0 + 0.1 * ax.table_ema)
        return SIM.predict_instr(i0, carry.react_sens, st, ax)

    # an under-declared spec (reads table_ema, a grid axis here) is refused
    under = MECH.MechanismSpec("sweep_sneaky", "reactive", MECH._CTRL,
                               predict=sneaky)
    from repro_torch.analysis.deps import AxisLivenessError
    with pytest.raises(AxisLivenessError, match="table_ema"):
        SW.run_grid(progs, cfg, grid, ("crisp", under))


def test_step_builds_are_cached(progs):
    SW._grid_step.cache_clear()
    SW.reset_counters()
    cfg = dataclasses.replace(PORT_CFG, n_epochs=3)
    for grid in ({"epoch_us": [1.0, 2.0]}, {"sigma": [0.06]}):
        SW.run_grid(progs, cfg, grid, ("static17", "crisp", "pcstall"))
    assert dict(SW.TRACE_COUNTS) == {"grid_forks": 1, "grid_static17": 1}


def test_block_cu_is_inert_on_cpu(progs):
    cfg = dataclasses.replace(PORT_CFG, n_epochs=5)
    _same(SW.run_suite(progs, dataclasses.replace(cfg, pallas_block_cu=4),
                       ("pcstall",)),
          SW.run_suite(progs, cfg, ("pcstall",)))


@pytest.mark.parametrize("mech,use_pallas", [
    (None, True), (None, False), ("static17", True), ("oracle", True)])
def test_batched_step_matches_single_row_step(progs, mech, use_pallas):
    """``_scan_rows`` over rows of different programs, block counts,
    seeds and grid points against ``_scan_sim`` of each row alone: the
    specialised families bit for bit; the traced family (whose step
    evaluates both predictors and selects) with ``fidx`` equal and floats
    to 1e-5 over a few epochs."""
    st = dataclasses.replace(PORT_CFG, n_epochs=6,
                             use_pallas=use_pallas).static_part()
    stacked, p_log = SW._stack_programs(list(progs.values()))
    ids = [SIM.FORK_MECH_IDS[m] for m in ("crisp", "accreac", "pcstall")]
    R = 4
    prog_idx = torch.tensor([0, 1, 1, 0])
    pb = torch.as_tensor(p_log)[prog_idx]
    seeds = torch.tensor([0, 3, 70000, 1], dtype=torch.int32)
    sims = [dataclasses.replace(PORT_CFG, epoch_us=e, objective=o)
            for e, o in ((1.0, "ed2p"), (10.0, "edp"), (2.0, "ed2p"),
                         (1.0, "perfcap10"))]
    axs = [s.axes("cpu") for s in sims]
    ax = SIM.SimAxes(*(torch.stack(v) if torch.is_tensor(v[0]) else
                       PWR.PowerAxes(*(torch.stack(p) for p in zip(*v)))
                       for v in zip(*axs)))
    mech_ids = torch.tensor([ids[r % 3] for r in range(R)])
    ys = SIM._scan_rows(SIM.ProgArrays(stacked.i0_rate, stacked.sens_rate,
                                       stacked.cum3), prog_idx, pb, seeds,
                        st, ax, mech, mech_ids if mech is None else None,
                        SIM.init_carry(pb, st, "cpu"))
    names = list(progs)
    for r in range(R):
        m = SIM.FORK_MECHS[int(mech_ids[r])] if mech is None else mech
        alone = SIM._scan_sim(progs[names[prog_idx[r]]], int(pb[r]),
                              int(seeds[r]), st, axs[r], m)
        for k, v in alone.items():
            if mech is not None or k == "fidx":
                assert torch.equal(ys[k][r], v), (r, k)
            elif k != "hit_rate":
                np.testing.assert_allclose(np_(ys[k][r]), np_(v), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{r} {k}")
    assert KEF.epoch_fused.launches == 0


def test_batched_noise_is_bitwise_the_rows_noise():
    """Each row's noise has the same bits alone and in a batch. Rows of
    9 x 7 = 63 elements are not a multiple of torch's vectorised ``sin``
    width, so a row's elements sit in different vector lanes (and the
    scalar tail) alone and batched."""
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(0, 4000, (5, 9, 7)),
                          dtype=torch.float32)
    pb = torch.tensor([96, 64, 80, 96, 33], dtype=torch.int32)
    seeds = torch.tensor([0, 3, 70000, -5, 1], dtype=torch.int32)
    batch = SIM._epoch_noise(pos, pb[:, None, None], seeds[:, None, None])
    for r in range(5):
        alone = SIM._epoch_noise(pos[r], int(pb[r]), int(seeds[r]))
        assert torch.equal(batch[r], alone), r
        row_t = SIM._epoch_noise(pos[r], pb[r], seeds[r])
        assert torch.equal(batch[r], row_t), r
