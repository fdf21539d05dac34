"""The port's DVFS runtime (``repro_torch.dvfs_runtime``, ``configs``,
``data.pipeline``) against the JAX reference's, on the CPU.

* configs, ``step_ops`` and ``arch_program``: every arch x its shapes
  equal to the reference (the programs' rates byte for byte, their prefix
  sums to 1e-6 as ``core/workloads.py`` states);
* ``step_time_stats`` and ``point_report`` on the same numpy traces;
* ``dvfs_request_stream``: the same requests as the reference's stream;
* ``DVFSManager.report`` / ``grid_report`` against the reference's on the
  same integer-keyed noise (``_torch_parity.lockstep_noise``) at 8 CUs x
  10 WFs: the runs agree per epoch until the first PC-loop wrap and then
  part (``tests/test_torch_sweep.py``), so reports are held to the
  whole-run bound ``AGG_TOL`` of run-level work and energy, compounded
  field by field as each report field compounds them (``REPORT_TOL``);
* inside the port: ``DVFSService`` streamed rows bitwise equal to the
  one-shot ``run_grid``, the service's lifecycle, bad requests and
  ``stats()``, and the manager's reports.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import lockstep_noise, np_  # noqa: E402
from repro import configs as JCFG  # noqa: E402
from repro.core import mechanisms as JMECH  # noqa: E402
from repro.core import simulate as JSIM  # noqa: E402
from repro.core import sweep as JSW  # noqa: E402
from repro.data import pipeline as JPIPE  # noqa: E402
from repro.dvfs_runtime import manager as JMAN  # noqa: E402
from repro.dvfs_runtime import telemetry as JTEL  # noqa: E402
from repro_torch import configs as CFG  # noqa: E402
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.workloads import get_workload  # noqa: E402
from repro_torch.data import pipeline as PIPE  # noqa: E402
from repro_torch.dvfs_runtime import manager as MAN  # noqa: E402
from repro_torch.dvfs_runtime import telemetry as TEL  # noqa: E402
from repro_torch.dvfs_runtime.service import DVFSService  # noqa: E402

CELLS = [(a, s.name) for a in JCFG.ARCH_IDS
         for s in JCFG.shapes_for(JCFG.get_config(a))]
# whole-run bound of run-level work and energy (tests/test_torch_sweep.py)
AGG_TOL = 2e-3
# each report field compounds it as it is built: energy_norm = E / E0 and
# delay_norm = D / D0 are ratios of two run-level quantities, each within
# AGG_TOL, so (1 + 1) AGG_TOL; ed2p_norm = E D^2 / (E0 D0^2) moves by up to
# (1 + 2 + 1 + 2) AGG_TOL; accuracy = 1 - mean(clip(err)) is a run-level
# mean of a relative error (predicted over measured), so (1 + 1) AGG_TOL
REPORT_TOL = {"energy_norm": 2 * AGG_TOL, "delay_norm": 2 * AGG_TOL,
              "ed2p_norm": 6 * AGG_TOL, "accuracy": 2 * AGG_TOL}
# the manager cases' SimConfig: 64 table entries and 80 epochs make a
# SimStatic no other test traces under the swapped noise
MGR_SIM = dict(n_cu=8, n_wf=10, n_epochs=80, entries=64)


def _shape(name):
    return next(s for s in JCFG.ALL_SHAPES if s.name == name)


# ---------------------------------------------------------------------------
# configs and arch programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_configs_match_reference(arch):
    want, got = JCFG.get_config(arch), CFG.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_params, got.n_active_params, got.resolved_head_dim,
            got.subquadratic) == (want.n_params, want.n_active_params,
                                  want.resolved_head_dim, want.subquadratic)
    assert [s.name for s in CFG.shapes_for(got)] == \
        [s.name for s in JCFG.shapes_for(want)]
    assert dataclasses.asdict(CFG.get_smoke_config(arch)) == \
        dataclasses.asdict(JCFG.get_smoke_config(arch))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_ops_and_arch_program_match_reference(arch, shape):
    jcfg, cfg = JCFG.get_config(arch), CFG.get_config(arch)
    jshape = _shape(shape)
    tshape = next(s for s in CFG.ALL_SHAPES if s.name == shape)
    assert TEL.step_ops(cfg, tshape) == JTEL.step_ops(jcfg, jshape)
    want = JTEL.arch_program(jcfg, jshape)
    got = TEL.arch_program(cfg, tshape, device="cpu")
    assert got.name == want.name
    for f in ("i0_rate", "sens_rate", "mem_frac"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np_(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(np_(got.cum3), np_(want.cum3), rtol=1e-6,
                               atol=1e-6)


def test_telemetry_constants_match_reference():
    from repro.roofline import hlo_analysis as JHLO
    assert (TEL.PEAK_FLOPS, TEL.HBM_BW, TEL.ICI_BW) == \
        (JHLO.PEAK_FLOPS, JHLO.HBM_BW, JHLO.ICI_BW)


# ---------------------------------------------------------------------------
# reports on the same traces; the request stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log", [(), ((10, 0.02), (20, 0.04), (40, 0.06)),
                                 ((3, 0.5),)])
def test_step_time_stats_match_reference(log):
    assert MAN.step_time_stats(log) == JMAN.step_time_stats(log)


@pytest.mark.parametrize("mech", ["pcstall", "crisp", "static22"])
def test_point_report_matches_reference(mech):
    rng = np.random.default_rng(3)

    def trace():
        return {"work": rng.uniform(50, 400, (120, 6)).astype(np.float32),
                "energy": rng.uniform(1, 3, (120, 6)).astype(np.float32),
                "err": rng.uniform(0, 1.5, (120, 6)).astype(np.float32),
                "fidx": rng.integers(0, 10, (120, 6)).astype(np.int32)}
    traces = {"static17": trace(), mech: trace()}
    log = ((1, 0.01), (5, 0.03))
    for epoch_us in (1.0, 10.0):
        want = JMAN.point_report(traces, epoch_us, JMECH.get("static17"),
                                 JMECH.get(mech), 10, log)
        got = MAN.point_report(traces, epoch_us, MECH.get("static17"),
                               MECH.get(mech), 10, log)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_request_stream_matches_reference():
    want = list(JPIPE.dvfs_request_stream(32, seed=7))
    got = list(PIPE.dvfs_request_stream(32, seed=7, device="cpu"))
    assert len(got) == len(want) == 32
    for (gp, ga, gt), (wp, wa, wt) in zip(got, want):
        assert (gp.name, ga, gt) == (wp.name, wa, wt)
        for f in ("i0_rate", "sens_rate", "mem_frac"):
            np.testing.assert_array_equal(np_(getattr(gp, f)),
                                          np_(getattr(wp, f)))
    for i in (0, 9, 31):
        a, b = PIPE.stream_rng(7, i), JPIPE.stream_rng(7, i)
        assert a.integers(1 << 30) == b.integers(1 << 30)


# ---------------------------------------------------------------------------
# the manager against the reference's
# ---------------------------------------------------------------------------


def _assert_report_close(got, want, what):
    assert got.keys() == want.keys()
    for k, tol in REPORT_TOL.items():
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), \
            (what, k, got[k], want[k])
    assert got["step_time"] == want["step_time"]
    assert len(got["freq_timeshare"]) == len(want["freq_timeshare"])
    assert abs(sum(got["freq_timeshare"]) - 1.0) < 1e-2


def test_manager_reports_match_reference(monkeypatch):
    """``report`` and a 2 x 2 ``grid_report`` of both packages' managers on
    the glm4-9b training step, under the same integer-keyed noise."""
    cfg, jcfg = CFG.get_config("glm4-9b"), JCFG.get_config("glm4-9b")
    JSW._grid_exec.cache_clear()
    lockstep_noise(monkeypatch)
    jm = JMAN.DVFSManager(JTEL.arch_program(jcfg, JCFG.TRAIN_4K),
                          JSIM.SimConfig(**MGR_SIM))
    tm = MAN.DVFSManager(TEL.arch_program(cfg, CFG.TRAIN_4K, device="cpu"),
                         SIM.SimConfig(**MGR_SIM))
    for m in (jm, tm):
        m.observe_step(3, 0.05)
        m.observe_step(4, 0.07)
    try:
        want = jm.report()
        want_grid = jm.grid_report(objectives=("ed2p", "edp"))
    finally:
        JSW._grid_exec.cache_clear()
    _assert_report_close(tm.report(), want, "report")
    got_grid = tm.grid_report(objectives=("ed2p", "edp"))
    assert got_grid.keys() == want_grid.keys()
    for key in want_grid:
        _assert_report_close(got_grid[key], want_grid[key], key)


# ---------------------------------------------------------------------------
# the port's own contracts: manager and service
# ---------------------------------------------------------------------------

SVC_SIM = SIM.SimConfig(n_cu=8, n_wf=12, n_epochs=24)
SVC_WORKLOADS = ("comd", "xsbench")
GRID2X2_JOBS = [(wl, {"epoch_us": e, "objective": o})
                for e in (1.0, 10.0) for o in ("ed2p", "edp")
                for wl in SVC_WORKLOADS]


@pytest.fixture(scope="module")
def progs():
    return {w: get_workload(w, P=256, device="cpu") for w in SVC_WORKLOADS}


def test_manager_report_is_its_grid_point_and_carries_step_stats():
    cfg = CFG.get_config("glm4-9b")
    mgr = MAN.DVFSManager.for_model(cfg, CFG.TRAIN_4K, n_cu=4,
                                    device="cpu")
    assert (mgr.sim.n_cu, mgr.sim.n_epochs, mgr.program.n_blocks) == \
        (4, 400, 1024)
    mgr.sim = dataclasses.replace(mgr.sim, n_wf=8, n_epochs=60)
    assert mgr.report()["step_time"]["n_steps"] == 0
    for step, dt in ((10, 0.02), (20, 0.04), (40, 0.06)):
        mgr.observe_step(step, dt)
    rep = mgr.report()
    st = rep["step_time"]
    assert (st["n_steps"], st["first_step"], st["last_step"]) == (3, 10, 40)
    assert st["mean_step_s"] == pytest.approx(0.04)
    assert rep["mean_step_s"] == pytest.approx(0.04)
    assert len(rep["freq_timeshare"]) == mgr.sim.power.n_freqs
    grid = mgr.grid_report(epoch_us=(1.0, 10.0), objectives=("ed2p", "edp"))
    assert set(grid) == {(1.0, "ed2p"), (1.0, "edp"), (10.0, "ed2p"),
                         (10.0, "edp")}
    # a row's bits do not depend on its batch: the one-job report is the
    # matching grid point exactly
    for k in ("ed2p_norm", "energy_norm", "delay_norm", "accuracy"):
        assert grid[(1.0, "ed2p")][k] == rep[k], k
    assert all(r["step_time"]["n_steps"] == 3 for r in grid.values())


def test_service_rows_bitwise_equal_one_shot_grid(progs):
    """The 2 x 2 grid as single-job requests, coalesced into micro-batches
    padded to a bucket of 4: every streamed row equals the one-shot
    ``run_grid`` row bit for bit."""
    mechs = ("static17", "pcstall")
    ref = SW.run_grid(progs, SVC_SIM, {"epoch_us": [1.0, 10.0],
                                       "objective": ["ed2p", "edp"]}, mechs)
    with DVFSService(SVC_SIM, max_batch=4, coalesce_s=0.05,
                     p_max=256) as svc:
        results = svc.map([(progs[w], ov) for w, ov in GRID2X2_JOBS])
        stats = svc.stats()
    for (wl, ov), res in zip(GRID2X2_JOBS, results):
        want = ref[(ov["epoch_us"], ov["objective"])][wl]
        for m in mechs:
            for ch, v in want[m].items():
                np.testing.assert_array_equal(res["traces"][m][ch], v,
                                              err_msg=f"{wl}/{ov}/{m}/{ch}")
        rep = res["report"]
        assert rep["step_time"]["n_steps"] == 0
        assert abs(sum(rep["freq_timeshare"]) - 1.0) < 1e-2
        assert 1 <= res["batch_size"] <= 4
    assert stats["jobs"] == len(GRID2X2_JOBS)
    assert stats["batches"] >= 2 and stats["mean_batch"] <= 4


def test_service_async_api_and_lifecycle(progs):
    """submit never waits on the device, futures carry latency and a
    report with the request's own telemetry stats, stats() percentiles are
    ordered, close() drains FIFO, and a closed service rejects submits."""
    svc = DVFSService(SVC_SIM, max_batch=4, coalesce_s=0.001, p_max=256)
    futs = [svc.submit(progs["comd"], {"epoch_us": float(e)},
                       telemetry=[(i, 0.01 * (i + 1)) for i in range(3)])
            for e in (1.0, 2.0, 5.0)]
    assert not all(f.done() for f in futs)
    svc.close()
    for f in futs:
        res = f.result(timeout=300)
        assert res["latency_s"] > 0 and 1 <= res["batch_size"] <= 4
        st = res["report"]["step_time"]
        assert st["n_steps"] == 3
        assert (st["first_step"], st["last_step"]) == (0, 2)
        np.testing.assert_allclose(st["mean_step_s"], 0.02)
        np.testing.assert_allclose(res["report"]["mean_step_s"], 0.02)
    stats = svc.stats()
    assert stats["jobs"] == 3 and stats["jobs_per_sec"] > 0
    assert 0 < stats["p50_latency_s"] <= stats["p99_latency_s"] \
        <= stats["max_latency_s"]
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(progs["comd"])
    svc.close()  # idempotent
    svc.reset_stats()
    assert svc.stats()["jobs"] == 0 and svc.stats()["wall_s"] == 0.0


def test_service_propagates_bad_request_errors(progs):
    """A bad request fails its own future (the whole batch it coalesced
    into), and the service keeps serving afterwards."""
    with DVFSService(SVC_SIM, max_batch=1, coalesce_s=0.0,
                     p_max=256) as svc:
        bad = svc.submit(progs["comd"], {"n_cu": 4})  # static, not an axis
        with pytest.raises(AssertionError, match="not a traced grid axis"):
            bad.result(timeout=300)
        good = svc.submit(progs["comd"], {"epoch_us": 1.0})
        assert "traces" in good.result(timeout=300)


def test_service_for_model_and_one_card():
    cfg = CFG.get_config("qwen2-moe-a2.7b")
    with DVFSService.for_model(cfg, CFG.TRAIN_4K, n_cu=4,
                               device="cpu") as svc:
        assert svc.static_cfg.n_cu == 4 and svc.static_cfg.n_epochs == 400
        assert svc.default_program.name == "qwen2-moe-a2.7b:train_4k"
        assert [s.name for s in svc.executor.specs] == ["static17",
                                                        "pcstall"]
    with pytest.raises(ValueError, match="one card"):
        DVFSService(SVC_SIM, n_dev=2)
