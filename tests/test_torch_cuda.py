"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU (decided in a
fixture, never at import). On a machine with one, build and run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes are odd on purpose (WF past one warp, NF below and at the
32-state limit, several CUs per warp) — the main path's own shape is
checked by ``chip_smoke.py``. Tolerance as there: discrete outputs equal,
floats within 1e-4 + 1e-5 |ref| (the kernels reduce in warp-tree and
fixed block order, torch in its own).
"""
import dataclasses
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import power as PWR  # noqa: E402
from repro_torch.core import predictors as PRED  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core.workloads import make_program  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402
from repro_torch.kernels import pc_table as KPT  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "devtime", Path(__file__).resolve().parents[1] / "scripts/devtime.py")
DT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DT)

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-4
# a whole run's work and energy sums, kernel engine against the unfused
# one (a last-ulp difference may flip a frequency choice; chip_smoke.py's)
AGG_TOL = 1e-3
EPOCH_FAMS = [("pc", False, None), ("pc", True, None),
              ("reactive", False, "stall"), ("reactive", False, "lead"),
              ("reactive", False, "crit"), ("reactive", False, "crisp"),
              ("reactive", True, None)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


def _close(got, want, what):
    g, w = got.cpu(), want.cpu()
    if not g.is_floating_point():
        assert torch.equal(g, w.to(g.dtype)), what
        return
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _case(family, fork_est, model, CU, WF, NF, dev, *, T=4, E=32, P=96,
          tid=None, seed=0):
    rng = np.random.default_rng(seed)
    prog = make_program("k", "mixed", 5, P=P, device=dev)
    ax = SIM.SimConfig(n_cu=CU, n_wf=WF).axes(dev)
    F = PWR.freqs_ghz(ax.power, NF)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    pos = f32(rng.uniform(0, P * 8, (CU, WF)))
    args = (prog.i0_rate, prog.sens_rate, prog.cum3.T.contiguous(), pos, F,
            SIM._epoch_noise(pos, P, 3),
            F[torch.as_tensor(rng.integers(0, NF, CU)).to(dev)].contiguous(),
            f32(rng.uniform(0, 5, CU)), f32(3.0))
    kw = dict(p_blocks=P, epoch_us=ax.epoch_us, sigma=ax.sigma,
              cap_per_ghz=ax.cap_per_ghz, membw=ax.membw, obj=ax.obj,
              lat_us=PWR.transition_latency_us(ax.epoch_us, ax.power),
              power=ax.power, family=family, fork_estimator=fork_est,
              cu_model=model, table_ema=0.4)
    if family == "pc":
        tid = np.arange(CU) % T if tid is None else np.asarray(tid)
        kw.update(
            table=PRED.PCTable(f32(rng.uniform(0, 60, (T, E))),
                               f32(rng.uniform(0, 40, (T, E))),
                               f32(rng.integers(0, 3, (T, E)))),
            tid=torch.as_tensor(tid, dtype=torch.int32).to(dev),
            wf_i0=f32(rng.uniform(0, 60, (CU, WF))),
            wf_sens=f32(rng.uniform(0, 40, (CU, WF))))
    else:
        kw.update(react_i0=f32(rng.uniform(0, 900, CU)),
                  react_sens=f32(rng.uniform(0, 500, CU)))
    return args, kw


@pytest.mark.parametrize("CU,WF,NF", [(5, 7, 6), (3, 33, 4), (40, 64, 32),
                                      (70, 1, 2)])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
@pytest.mark.parametrize("family,fork_est,model", EPOCH_FAMS)
def test_epoch_fused_kernel_matches_plain(dev, family, fork_est, model,
                                          lean, CU, WF, NF):
    args, kw = _case(family, fork_est, model, CU, WF, NF, dev, seed=CU + WF)
    before = KEF.epoch_fused.launches
    got = KEF.epoch_fused(*args, **kw, lean=lean)
    want = KEF.epoch_fused_ref(*args, **kw, lean=lean)
    torch.cuda.synchronize()
    assert KEF.epoch_fused.launches == before + 1
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is None:
            continue
        if field == "table":
            for k, gg, ww in zip(("i0", "sens", "count"), g, w):
                _close(gg, ww, f"table.{k}")
        else:
            _close(g, w, field)


@pytest.mark.parametrize("objective,cpd", [("edp", 2), ("perfcap10", 4),
                                           ("deadline05", 1),
                                           ("perfcap30", 8)])
@pytest.mark.parametrize("family,fork_est,model", [("pc", False, None),
                                                  ("reactive", False,
                                                   "crisp")])
def test_epoch_fused_kernel_objectives_and_domains(dev, family, fork_est,
                                                   model, objective, cpd):
    """Every objective's cost path (rate-normalised or perf-capped) and
    multi-CU frequency domains, kernel against plain version."""
    args, kw = _case(family, fork_est, model, 16, 20, 10, dev, seed=cpd)
    kw.update(obj=torch.as_tensor(SIM.objective_weights(objective)).to(dev),
              cus_per_domain=cpd, offset_blocks=2)
    got = KEF.epoch_fused(*args, **kw)
    want = KEF.epoch_fused_ref(*args, **kw)
    for field in ("fidx", "f_sel", "pos", "work", "energy", "err", "e_acc",
                  "true_sens"):
        _close(getattr(got, field), getattr(want, field), field)
    fidx = got.fidx.reshape(-1, cpd).cpu()
    assert (fidx == fidx[:, :1]).all()      # one choice per domain


def test_epoch_fused_kernel_table_maps(dev):
    """Arbitrary and out-of-range table maps: clamp on lookup, drop on
    update, several CUs per table."""
    tid = [0, 2, 1, 3, 7, 2, 0, 4]
    args, kw = _case("pc", False, None, 8, 12, 10, dev, T=4, tid=tid)
    got = KEF.epoch_fused(*args, **kw)
    want = KEF.epoch_fused_ref(*args, **kw)
    for k, gg, ww in zip(("i0", "sens", "count"), got.table, want.table):
        _close(gg, ww, k)
    added = float((got.table.count - kw["table"].count).sum())
    assert added == sum(t < 4 for t in tid) * 12


def _table_case(T, E, CU, WF, NF, dev, *, N=None, seed=0):
    """PC-table operands from a numpy seed: table ids past the last table,
    slots below 0 and past the last slot (clamped on lookup, dropped on
    update), ``N`` update entries per table (CU * WF // T by default)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    N = N or max(CU * WF // T, 1)
    return dict(
        tbl=[f32(rng.uniform(0, 60, (T, E))), f32(rng.uniform(0, 40, (T, E))),
             f32(rng.integers(0, 3, (T, E)))],
        tid=torch.as_tensor(rng.integers(0, T + 2, CU),
                            dtype=torch.int32).to(dev),
        idx=torch.as_tensor(rng.integers(-2, E + 2, (CU, WF))).to(dev),
        fb=[f32(rng.uniform(0, 60, (CU, WF))),
            f32(rng.uniform(0, 40, (CU, WF)))],
        F=f32(np.linspace(1.3, 2.2, NF)),
        idx2=torch.as_tensor(rng.integers(-2, E + 2, (T, N))).to(dev),
        vals=[f32(rng.uniform(0, 60, (T, N))),
              f32(rng.uniform(0, 40, (T, N)))])


def _scalar_kw(kind, dev, **vals):
    if kind == "float":
        return vals
    return {k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in vals.items()}


# ragged shapes: WF 1 / 33 / 40 / 100, E 1 / 100 / 128 / 1000 (and past
# one thread per slot), T 1 / 64 / 304, N past one staged chunk (1024)
@pytest.mark.parametrize("T,E,CU,WF,NF,N", [
    (4, 64, 8, 16, 10, None), (3, 200, 5, 70, 32, None),
    (8, 128, 16, 40, 1, None), (1, 1, 3, 1, 10, None),
    (64, 128, 64, 40, 10, None), (304, 100, 304, 33, 10, None),
    (2, 1000, 4, 100, 7, None), (2, 300, 40, 100, 10, 2000),
    (1, 2000, 30, 40, 10, 1200), (3, 1500, 6, 33, 5, 5000)])
@pytest.mark.parametrize("scalars", ["float", "tensor"])
def test_pc_table_kernels_match_plain(dev, T, E, CU, WF, NF, N, scalars):
    """K1 (I_pred and the hit mask) and K2 against their plain versions;
    int32 and int64 slots give the same bits, and so do two calls."""
    d = _table_case(T, E, CU, WF, NF, dev, N=N, seed=T * E + WF)
    tbl, tid, fb, F = d["tbl"], d["tid"], d["fb"], d["F"]
    for cap in (0.0, 80.0):
        kw = _scalar_kw(scalars, dev, epoch_us=1.5, cap_per_ghz=cap)
        outs = [KPT.pc_table_predict(*tbl, tid, d["idx"].to(dt), *fb, F,
                                     **kw, return_hit=True)
                for dt in (torch.int64, torch.int32, torch.int64)]
        want, want_hit = REF.pc_table_predict_ref(*tbl, tid, d["idx"], *fb,
                                                  F, **kw, return_hit=True)
        torch.cuda.synchronize()
        _close(outs[0][0], want, f"predict cap={cap}")
        assert torch.equal(outs[0][1], want_hit), f"hit cap={cap}"
        for got, hit in outs[1:]:
            assert torch.equal(got, outs[0][0]) and torch.equal(
                hit, outs[0][1]), f"predict cap={cap}: bits differ"
    kw = _scalar_kw(scalars, dev, ema=0.3)
    outs = [KPT.pc_table_update(*tbl, d["idx2"].to(dt), *d["vals"], **kw)
            for dt in (torch.int64, torch.int32, torch.int64)]
    want = REF.pc_table_update_ref(*tbl, d["idx2"], *d["vals"], **kw)
    for k, g, w in zip(("i0", "sens", "count"), outs[0], want):
        _close(g, w, f"update {k}")
        assert g.is_contiguous() and g.shape == (T, E)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def _pc_table_launches(scalars):
    """What 4 calls of each PC-table wrapper run on the card, as the engine
    calls them (int64 slots, the hit mask, the scalars on the card or as
    floats): {"predict": {name: records}, "update": {...}}, each from one
    torch.profiler session."""
    dev = torch.device("cuda", 0)
    d = _table_case(64, 128, 64, 40, 10, dev, seed=5)
    kp = _scalar_kw(scalars, dev, epoch_us=1.0, cap_per_ghz=5500.0)
    ke = _scalar_kw(scalars, dev, ema=0.5)
    upd = (d["idx"].reshape(64, 40), *(v.reshape(64, 40) for v in d["fb"]))
    return {"predict": DT.kernel_counts(lambda: KPT.pc_table_predict(
        *d["tbl"], d["tid"], d["idx"], *d["fb"], d["F"], **kp,
        return_hit=True), 4),
        "update": DT.kernel_counts(
            lambda: KPT.pc_table_update(*d["tbl"], *upd, **ke), 4)}


@pytest.mark.parametrize("scalars", ["float", "tensor"])
def test_pc_table_wrappers_launch_one_kernel_each(dev, scalars):
    """A wrapper call on the card is one kernel launch and nothing else
    (no conversion, scalar packing or copy), as the engine calls it:
    int64 slots, the hit mask, the scalars on the card or as floats; 4
    calls, 4 records of the one kernel. Counted in a fresh process
    (``_pc_table_launches``): in a process that has traced thousands of
    kernels, as this file's does by here, CUPTI drops records from a
    profiler session (``scripts/devtime.py``), and the count read 3 of
    4 in some runs of the whole file."""
    import json
    import os
    import sys
    root = Path(__file__).resolve().parents[1]
    code = ("import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('cuda_tests', "
            "sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(json.dumps(mod._pc_table_launches(sys.argv[2])))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root / "tests"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code, __file__, scalars],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ran = json.loads(out.stdout.strip().splitlines()[-1])
    for which in ("predict", "update"):
        got = ran[which]
        assert len(got) == 1 and f"pc_table_{which}_kernel" in next(
            iter(got)) and set(got.values()) == {4}, (which, got)


def test_pc_table_wrappers_refuse_bad_operands(dev):
    """A wrong dtype, shape, device, layout or scalar raises before any
    launch."""
    d = _table_case(4, 32, 8, 12, 10, dev, seed=2)
    tbl, tid, idx, fb, F = d["tbl"], d["tid"], d["idx"], d["fb"], d["F"]
    n0 = (KPT.pc_table_predict.launches, KPT.pc_table_update.launches)
    bad_predict = [
        ("dtype", dict(idx=idx.float())),
        ("dtype", dict(tid=tid.long())),
        ("dtype", dict(tbl0=tbl[0].double())),
        ("shape", dict(tid=tid[:5])),
        ("shape", dict(fb0=fb[0][:, :6].contiguous())),
        ("on cpu", dict(fb1=fb[1].cpu())),
        ("contiguous", dict(fb0=torch.zeros((8, 24), device=dev)[:, ::2])),
        ("32 states", dict(F=torch.linspace(1.0, 2.0, 33, device=dev))),
        ("epoch_us", dict(epoch_us=torch.tensor(1.0, device=dev,
                                                dtype=torch.float64))),
        ("cap_per_ghz", dict(cap_per_ghz=torch.ones(2, device=dev))),
        ("cap_per_ghz", dict(cap_per_ghz=torch.ones(2)))]
    for what, sub in bad_predict:
        ops = {**dict(tbl0=tbl[0], tid=tid, idx=idx, fb0=fb[0], fb1=fb[1],
                      F=F, epoch_us=1.0, cap_per_ghz=0.0), **sub}
        with pytest.raises(ValueError, match=what):
            KPT.pc_table_predict(ops["tbl0"], tbl[1], tbl[2], ops["tid"],
                                 ops["idx"], ops["fb0"], ops["fb1"], ops["F"],
                                 epoch_us=ops["epoch_us"],
                                 cap_per_ghz=ops["cap_per_ghz"])
    idx2, vals = d["idx2"], d["vals"]
    bad_update = [
        ("dtype", (idx2.float(), *vals), {}),
        ("shape", (idx2, vals[0][:, :3].contiguous(), vals[1]), {}),
        ("shape", (idx2[:3], vals[0][:3], vals[1][:3]), {}),
        ("on cpu", (idx2, vals[0].cpu(), vals[1]), {}),
        ("ema", (idx2, *vals), dict(ema=torch.tensor([0.5, 0.5],
                                                     device=dev)))]
    for what, args, kw in bad_update:
        with pytest.raises(ValueError, match=what):
            KPT.pc_table_update(*tbl, *args, **kw)
    assert (KPT.pc_table_predict.launches,
            KPT.pc_table_update.launches) == n0


def test_wrappers_reject_bad_operands(dev):
    args, kw = _case("pc", False, None, 4, 6, 10, dev)
    bad_pos = args[3].double()
    with pytest.raises(ValueError, match="dtype"):
        KEF.epoch_fused(*args[:3], bad_pos, *args[4:], **kw)
    strided = torch.zeros((4, 12), device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        KEF.epoch_fused(*args[:3], strided, *args[4:], **kw)
    with pytest.raises(ValueError, match="WF <= 64"):
        a2, k2 = _case("pc", False, None, 2, 65, 10, dev)
        KEF.epoch_fused(*a2, **k2)
    tbl = [torch.zeros((2, 8), device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="int32"):
        KPT.pc_table_update(*tbl, torch.zeros((2, 3), device=dev,
                                              dtype=torch.float32),
                            torch.zeros((2, 3), device=dev),
                            torch.zeros((2, 3), device=dev))


def test_run_sim_on_card_uses_kernels(dev):
    """A short run of every v2 family on the card launches the fused
    kernel once per epoch and gives finite traces."""
    prog = make_program("k", "phased", 11, P=256, device=dev)
    sim = SIM.SimConfig(n_cu=6, n_wf=9, n_epochs=20)
    for mech in ("crisp", "stall", "lead", "crit", "accreac", "pcstall",
                 "accpc"):
        before = KEF.epoch_fused.launches
        out = SIM.run_sim(prog, sim, mech)
        assert KEF.epoch_fused.launches == before + 20, mech
        assert all(np.isfinite(v).all() for v in out.values()), mech


@pytest.mark.parametrize("mech", ["pcstall", "accpc"])
def test_v1_run_matches_unfused_engine(dev, mech):
    """A 600-epoch run of a pc mechanism on the PC-table pair (K1's hit
    mask feeding hit_rate and the table update) against the unfused
    engine: the same shapes and hit rate, work and energy sums within
    AGG_TOL."""
    prog = get_workload("comd", device=dev)
    cfg = SIM.SimConfig(n_epochs=600)
    n0 = (KPT.pc_table_predict.launches, KPT.pc_table_update.launches)
    a = SIM.run_sim(prog, dataclasses.replace(cfg, use_pallas="v1"), mech)
    assert (KPT.pc_table_predict.launches - n0[0],
            KPT.pc_table_update.launches - n0[1]) == (600, 600)
    b = SIM.run_sim(prog, dataclasses.replace(cfg, use_pallas=False), mech)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and np.isfinite(a[k]).all(), k
    for k in ("work", "energy"):
        want = float(b[k].sum(dtype=np.float64))
        got = float(a[k].sum(dtype=np.float64))
        assert abs(got - want) <= AGG_TOL * abs(want), (k, got, want)


@pytest.mark.parametrize("mech,use_pallas", [
    ("pcstall", True), ("crisp", True), ("pcstall", "v1"),
    ("static17", True), ("oracle", True), ("pcstall", False)])
def test_epoch_loop_never_syncs(dev, mech, use_pallas):
    """The epoch loop issues no host-device synchronisation: torch's sync
    debug mode turns any synchronising call inside it into an error."""
    prog = make_program("k", "phased", 11, P=256, device=dev)
    sim = SIM.SimConfig(n_cu=8, n_wf=12, n_epochs=5, cus_per_domain=2,
                        use_pallas=use_pallas)
    st, ax = sim.static_part(), sim.axes(dev)
    carry = SIM.init_carry(prog.n_blocks, st, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = SIM._scan_sim(prog, prog.n_blocks, 0, st, ax, mech, carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(v.float()).all() for v in ys.values())


# ---------------------------------------------------------------------------
# K4: the fork-family epoch over grid rows, and the sweep layer on the card
# ---------------------------------------------------------------------------

from _torch_rows import fork_rows_case, one_row, row_fields  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.workloads import get_workload  # noqa: E402

FORK_IDS = list(range(7))


def _rows_close(got, want, what, args, kw):
    for k, w in want.items():
        if k != "true_sens":
            _close(got[k], w, f"{what} {k}")
    # true_sens = (fmax total - fmin total) / (dF T) cancels, so it keeps
    # the rounding of the two fork totals, which the kernel (warp trees)
    # and the plain version (torch's sums) add in different orders: hold
    # it at the totals' scale, a CU's committed work, not at its own
    F, T = args[5].cpu(), kw["scal"][:, 0].cpu()
    dFT = ((F[:, -1] - F[:, 0]) * T)[:, None]
    scale = want["work"].abs().amax(-1, keepdim=True)
    ref = want["true_sens"]
    tol = ATOL + RTOL * ref.abs() + 2 * RTOL * scale / dFT
    err = (got["true_sens"] - ref).abs()
    assert bool((err <= tol).all()), \
        f"{what} true_sens: max err {float(err.max()):.3e}"


@pytest.mark.parametrize("CU,WF,NF,cpd", [(5, 7, 6, 1), (3, 33, 4, 3),
                                          (40, 64, 32, 8), (70, 1, 2, 2),
                                          (16, 20, 10, 4)])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
@pytest.mark.parametrize("objective", ["ed2p", "edp", "perfcap10",
                                       "deadline05"])
def test_fork_rows_kernel_matches_plain(dev, CU, WF, NF, cpd, lean,
                                        objective):
    """K4 over 14 mixed rows (every traced id twice, programs of
    different lengths, per-row scalars and regimes) in ONE launch,
    against the plain version."""
    args, kw = fork_rows_case(FORK_IDS * 2, CU, WF, NF=NF, device=dev,
                              cus_per_domain=cpd, objectives=(objective,),
                              seed=CU + NF)
    before = KEF.epoch_fused.launches_by_family["fork"]
    got = KEF.epoch_fused_rows(*args, **kw, lean=lean)
    want = KEF.epoch_fused_rows_ref(*args, **kw, lean=lean)
    torch.cuda.synchronize()
    assert KEF.epoch_fused.launches_by_family["fork"] == before + 1
    _rows_close(row_fields(got), row_fields(want), f"cpd={cpd}", args, kw)


def test_fork_rows_are_independent_of_the_launch(dev):
    """A row's bits do not depend on which rows share its launch: 300
    mixed rows (more than two waves of CTAs) in one launch equal each row
    launched alone."""
    ids = [int(i) for i in np.random.default_rng(1).integers(0, 7, 300)]
    args, kw = fork_rows_case(ids, 16, 24, device=dev, seed=4)
    batch = row_fields(KEF.epoch_fused_rows(*args, **kw))
    for r in range(0, 300, 37):
        a, k = one_row(args, kw, r)
        alone = row_fields(KEF.epoch_fused_rows(*a, **k), 0)
        for name, v in alone.items():
            assert torch.equal(batch[name][r], v), (r, name)


@pytest.mark.parametrize("mech", FORK_IDS)
def test_fork_row_matches_specialised_kernel(dev, mech):
    """A K4 row with traced id m against K3 run as mechanism m on the
    same inputs: fidx equal, the live state within tolerance, the dead
    state group passed through bit for bit."""
    args, kw = fork_rows_case([mech], 12, 20, device=dev, seed=mech)
    fork = row_fields(KEF.epoch_fused_rows(*args, **kw), 0)
    spec = MECH.get(SIM.FORK_MECHS[mech])
    p = int(args[3][0])
    scal = kw["scal"][0]
    single = dict(
        p_blocks=int(kw["p_blocks"][0]), epoch_us=scal[0], sigma=scal[1],
        cap_per_ghz=scal[2], membw=scal[3], table_ema=scal[4],
        obj=scal[5:8], lat_us=scal[8],
        power=PWR.PowerAxes(*kw["power"][0].unbind(0)),
        family=spec.family, fork_estimator=spec.fork_estimator,
        cu_model=spec.cu_model, offset_blocks=kw["offset_blocks"])
    if spec.family == "pc":
        single.update(table=PRED.PCTable(*(t[0] for t in kw["table"])),
                      tid=kw["tid"], wf_i0=kw["wf_i0"][0],
                      wf_sens=kw["wf_sens"][0])
        live = ("table.i0", "table.sens", "table.count", "wf_i0", "wf_sens")
        dead = {"react_i0": kw["react_i0"][0],
                "react_sens": kw["react_sens"][0]}
    else:
        single.update(react_i0=kw["react_i0"][0],
                      react_sens=kw["react_sens"][0])
        live = ("react_i0", "react_sens")
        dead = {"wf_i0": kw["wf_i0"][0], "wf_sens": kw["wf_sens"][0],
                **{f"table.{k}": t[0] for k, t in
                   zip(("i0", "sens", "count"), kw["table"])}}
    k3 = row_fields(KEF.epoch_fused(
        args[0][p], args[1][p], args[2][p], args[4][0], args[5][0],
        args[6][0], args[7][0], args[8][0], args[9][0:1], **single))
    assert torch.equal(fork["fidx"], k3["fidx"])
    for name in live + ("pos", "work", "energy", "err", "e_acc"):
        _close(fork[name], k3[name], name)
    for name, before in dead.items():
        assert torch.equal(fork[name], before.cpu()), name


def test_batched_noise_is_bitwise_the_rows_noise(dev):
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(0, 4000, (5, 9, 7)),
                          dtype=torch.float32).to(dev)
    pb = torch.tensor([96, 64, 80, 96, 33], dtype=torch.int32, device=dev)
    seeds = torch.tensor([0, 3, 70000, -5, 1], dtype=torch.int32,
                         device=dev)
    batch = SIM._epoch_noise(pos, pb[:, None, None], seeds[:, None, None])
    for r in range(5):
        alone = SIM._epoch_noise(pos[r], int(pb[r]), int(seeds[r]))
        assert torch.equal(batch[r], alone), r


# the fork family in the reference's CU tiling (K5): (CU, WF, block_cu,
# cus_per_domain, table map) at the widths it exists for; "mod" spreads
# each table over CUs of every block, "triples" maps three neighbouring
# CUs to a table so tables straddle block (and CTA) boundaries
BLOCKED_SHAPES = [(256, 40, 64, 1, "mod"), (256, 40, 64, 2, "mod"),
                  (304, 40, 38, 1, "own"), (304, 40, 38, 2, "own"),
                  (304, 40, 38, 1, "triples"), (96, 64, 32, 1, "mod")]


def _tid(CU, layout):
    if layout == "own":
        return np.arange(CU), CU
    if layout == "triples":
        return np.arange(CU) // 3, CU // 3 + 1
    return np.arange(CU) % 48, 48


@pytest.mark.parametrize("CU,WF,block_cu,cpd,layout", BLOCKED_SHAPES)
def test_blocked_kernel_matches_plain(dev, CU, WF, block_cu, cpd, layout):
    """K5 over every traced id against its plain version (the reference's
    blocked pair): fidx and f_sel equal, floats within the kernels'
    tolerance (the plain version runs the selected row in lean math, the
    kernel in the exact order). One call, counted under "fork"."""
    tid, T = _tid(CU, layout)
    args, kw = fork_rows_case(FORK_IDS, CU, WF, T=T, E=128, tid=tid,
                              Ps=(1024, 768), offset_blocks=8, device=dev,
                              cus_per_domain=cpd, seed=CU + cpd)
    before = dict(KEF.epoch_fused.launches_by_family)
    got = row_fields(KEF.epoch_fused_rows(*args, **kw, block_cu=block_cu))
    want = row_fields(KEF.epoch_fused_rows_blocked_ref(*args, **kw,
                                                       block_cu=block_cu))
    torch.cuda.synchronize()
    after = KEF.epoch_fused.launches_by_family
    assert after["fork"] == before["fork"] + 1
    assert torch.equal(got["f_sel"], want["f_sel"])
    _rows_close(got, want, f"{CU}x{WF}/{block_cu} cpd={cpd} {layout}",
                args, kw)


def test_blocked_kernel_mixed_rows_are_independent(dev):
    """One K5 call of 8 rows mixing ids, programs of 1024/768/512 blocks,
    objectives and power regimes at 304 x 40 / 38 (the service's shape):
    against the plain version, and each row bitwise equal to the row
    called alone."""
    ids = FORK_IDS + [5]
    args, kw = fork_rows_case(ids, 304, 40, T=304, E=128,
                              tid=np.arange(304), Ps=(1024, 768, 512),
                              objectives=("ed2p", "edp", "perfcap10"),
                              offset_blocks=8, device=dev, seed=13)
    got = row_fields(KEF.epoch_fused_rows(*args, **kw, block_cu=38))
    want = row_fields(KEF.epoch_fused_rows_blocked_ref(*args, **kw,
                                                       block_cu=38))
    torch.cuda.synchronize()
    _rows_close(got, want, "R=8 mixed", args, kw)
    for r in (0, 3, 5, 7):
        a, k = one_row(args, kw, r)
        alone = row_fields(KEF.epoch_fused_rows(*a, **k, block_cu=38), 0)
        for name, v in alone.items():
            assert torch.equal(got[name][r], v), (r, name)


@pytest.mark.parametrize("cpd", [1, 2])
def test_blocked_kernel_is_bitwise_the_monolithic_kernel(dev, cpd):
    """A row's bits do not depend on the CTA width the launcher picks: at
    64 x 40 the rows of a 42-row call (8 CUs per CTA) equal each row
    called alone (the narrowest width) bit for bit in every output, the
    traffic partials summed over all CUs in CU order and each table slot's
    WFs walked in index order either way. K5 (block_cu) runs these same
    kernels, so its rows are K4's."""
    ids = FORK_IDS * 6
    assert KEF.cta_width(64, len(ids), cpd) == 8
    assert KEF.cta_width(64, 1, cpd) == cpd
    args, kw = fork_rows_case(ids, 64, 40, T=32, E=128, Ps=(1024, 768),
                              offset_blocks=8, device=dev,
                              cus_per_domain=cpd, seed=7 + cpd)
    batch = row_fields(KEF.epoch_fused_rows(*args, **kw, block_cu=32))
    for r in range(7):
        a, k = one_row(args, kw, r)
        alone = row_fields(KEF.epoch_fused_rows(*a, **k), 0)
        for name, v in alone.items():
            assert torch.equal(batch[name][r], v), (r, name)


def test_monolithic_kernel_refuses_rows_past_shared_memory(dev):
    """Every CTA holds the whole program: one of 8192 blocks does not fit
    and raises naming the remedy (no launch, no fallback), for K3 and K4.
    Rows of any width fit: K3 and K4 at 304 x 40 over 1024 blocks match
    their plain versions, and run_sim at 304 CUs runs. A block_cu the
    reference refuses is refused."""
    args, kw = _case("pc", False, None, 64, 40, 10, dev, T=64, E=128,
                     P=8192)
    rows, rkw = fork_rows_case([5, 3], 64, 40, T=64, E=128, Ps=(8192,),
                               device=dev)
    before = dict(KEF.epoch_fused.launches_by_family)
    with pytest.raises(RuntimeError, match="pallas_block_cu"):
        KEF.epoch_fused(*args, **kw)
    with pytest.raises(RuntimeError, match="fewer blocks"):
        KEF.epoch_fused_rows(*rows, **rkw)
    assert KEF.epoch_fused.launches_by_family == before
    args, kw = _case("pc", False, None, 304, 40, 10, dev, T=304, E=128,
                     P=1024)
    got = KEF.epoch_fused(*args, **kw)
    want = KEF.epoch_fused_ref(*args, **kw)
    for k, gg, ww in zip(("i0", "sens", "count"), got.table, want.table):
        _close(gg, ww, f"K3 at 304 x 40 table.{k}")
    for field in ("pos", "wf_i0", "wf_sens", "work", "energy", "fidx"):
        _close(getattr(got, field), getattr(want, field), f"K3 {field}")
    prog = get_workload("comd", device=dev)
    tr = SIM.run_sim(prog, SIM.SimConfig(n_cu=304, n_epochs=2), "pcstall")
    assert all(np.isfinite(v).all() for v in tr.values())
    rows, rkw = fork_rows_case([5, 3], 304, 40, T=304, E=128,
                               tid=np.arange(304), Ps=(1024,), device=dev)
    got = row_fields(KEF.epoch_fused_rows(*rows, **rkw))
    want = row_fields(KEF.epoch_fused_rows_ref(*rows, **rkw))
    _rows_close(got, want, "K4 at 304 x 40", rows, rkw)
    with pytest.raises(ValueError, match="block_cu"):
        KEF.epoch_fused_rows(*rows, **rkw, block_cu=39)


# (cus_per_table, table map) cases of K4/K5: contiguous groups of 1, 2 and
# 4 CUs per table; a non-contiguous map holding ids past the table count
# and below 0 (dropped from the update, clamped in the lookup); and slots
# that collide heavily (4 entries per table, 16 blocks per entry)
TABLE_MAPS = [
    ("cpt1", dict(T=64, E=128)), ("cpt2", dict(T=32, E=128)),
    ("cpt4", dict(T=16, E=128)),
    ("scattered", dict(T=8, E=32)),
    ("collide", dict(T=16, E=4, offset_blocks=16)),
]


def _table_map(name, CU):
    if name.startswith("cpt"):
        return np.arange(CU) // int(name[3:])
    if name == "scattered":
        base = np.array([0, 2, 1, 3, 7, 2, 0, 4, 9, -1, 5, 8])
        return base[np.arange(CU) % len(base)]
    return np.arange(CU) % 16


@pytest.mark.parametrize("layout,opts", TABLE_MAPS, ids=[m[0] for m in
                                                         TABLE_MAPS])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
def test_fork_epoch_table_maps(dev, layout, opts, lean):
    """K4 over every traced id at 64 x 40 against the plain version, and
    K5 (block_cu 16, the same kernels) against the reference's blocked
    pair in lean math, for each table map; each row called alone (one CU
    per CTA) equals the row among 14 (four) bit for bit."""
    CU = 64
    args, kw = fork_rows_case(FORK_IDS * 2, CU, 40, tid=_table_map(layout, CU),
                              Ps=(1024, 768), device=dev, seed=len(layout),
                              **opts)
    assert KEF.cta_width(CU, 14) == 4 and KEF.cta_width(CU, 1) == 1
    k4 = row_fields(KEF.epoch_fused_rows(*args, **kw, lean=lean))
    want = row_fields(KEF.epoch_fused_rows_ref(*args, **kw, lean=lean))
    torch.cuda.synchronize()
    _rows_close(k4, want, f"K4 {layout}", args, kw)
    if lean:
        k5 = row_fields(KEF.epoch_fused_rows(*args, **kw, block_cu=16))
        want5 = row_fields(KEF.epoch_fused_rows_blocked_ref(*args, **kw,
                                                            block_cu=16))
        assert torch.equal(k5["f_sel"], want5["f_sel"])
        _rows_close(k5, want5, f"K5 {layout}", args, kw)
    for r in (0, 4, 5, 13):
        a, k = one_row(args, kw, r)
        alone = row_fields(KEF.epoch_fused_rows(*a, **k, lean=lean), 0)
        for name, v in alone.items():
            assert torch.equal(k4[name][r], v), (r, name)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
def test_k3_row_is_bitwise_the_k4_row(dev, lean):
    """K3 run as mechanism m (one row: one CU per CTA at 64 CUs) equals
    the row with traced id m in a K4 call of 42 rows (8 CUs per CTA) bit
    for bit in every output K3 writes: one chain of device functions,
    whatever the family and the CTA width."""
    ids = FORK_IDS * 6
    args, kw = fork_rows_case(ids, 64, 40, T=32, E=128, Ps=(1024,),
                              offset_blocks=8, device=dev, seed=21)
    assert KEF.cta_width(64, len(ids)) == 8 and KEF.cta_width(64, 1) == 1
    fork = row_fields(KEF.epoch_fused_rows(*args, **kw, lean=lean))
    for m in FORK_IDS:
        spec = MECH.get(SIM.FORK_MECHS[m])
        scal = kw["scal"][m]
        single = dict(
            p_blocks=1024, epoch_us=scal[0], sigma=scal[1],
            cap_per_ghz=scal[2], membw=scal[3], table_ema=scal[4],
            obj=scal[5:8], lat_us=scal[8],
            power=PWR.PowerAxes(*kw["power"][m].unbind(0)),
            family=spec.family, fork_estimator=spec.fork_estimator,
            cu_model=spec.cu_model, offset_blocks=8, lean=lean)
        if spec.family == "pc":
            single.update(table=PRED.PCTable(*(t[m] for t in kw["table"])),
                          tid=kw["tid"], wf_i0=kw["wf_i0"][m],
                          wf_sens=kw["wf_sens"][m])
        else:
            single.update(react_i0=kw["react_i0"][m],
                          react_sens=kw["react_sens"][m])
        k3 = row_fields(KEF.epoch_fused(
            args[0][0], args[1][0], args[2][0], args[4][m], args[5][m],
            args[6][m], args[7][m], args[8][m], args[9][m:m + 1], **single))
        for name, v in k3.items():
            if name in ("t_acc", "hit_rate"):
                v = v.reshape(-1)[0]
            assert torch.equal(fork[name][m], v), (spec.name, name)


@pytest.mark.parametrize("family,fork_est,model", [("pc", False, None),
                                                   ("pc", True, None),
                                                   ("reactive", False,
                                                    "crisp"),
                                                   ("reactive", True, None)])
def test_tiled_k3_matches_plain_past_one_cta(dev, family, fork_est, model):
    """K3 at the README's 304 x 40 over 1024 blocks (two CUs per CTA)
    against its plain version."""
    args, kw = _case(family, fork_est, model, 304, 40, 10, dev, T=304,
                     E=128, P=1024, seed=5)
    assert KEF.cta_width(304, 1) == 2
    got = KEF.epoch_fused(*args, **kw)
    want = KEF.epoch_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        if g is None:
            continue
        if field == "table":
            for k, gg, ww in zip(("i0", "sens", "count"), g, w):
                _close(gg, ww, f"table.{k}")
        else:
            _close(g, w, field)


@pytest.mark.parametrize("mech", ["crisp", "pcstall"])
def test_run_workload_tiles_k3_with_block_cu(dev, mech):
    """run_sim of a one-row traced mechanism at the README's
    SimConfig(n_cu=304, pallas_block_cu=38) runs K3 once per epoch, and
    equals the run without block_cu bit for bit (block_cu picks nothing
    for the one-row families, as in the reference)."""
    prog = get_workload("comd", device=dev)
    cfg = SIM.SimConfig(n_cu=304, n_epochs=20)
    fam = MECH.get(mech).family
    before = dict(KEF.epoch_fused.launches_by_family)
    tr = SIM.run_sim(prog, dataclasses.replace(cfg, pallas_block_cu=38), mech)
    after = KEF.epoch_fused.launches_by_family
    assert after[fam] - before[fam] == 20
    assert all(np.isfinite(v).all() for v in tr.values())
    plain = SIM.run_sim(prog, cfg, mech)
    for k, v in plain.items():
        assert np.array_equal(tr[k], v), k


def test_block_cu_steps_the_sweep_on_k5(dev):
    """With SimConfig.pallas_block_cu the traced family steps one call
    per epoch, and over 40 closed-loop epochs its grid equals the grid
    without block_cu bit for bit."""
    progs = {n: get_workload(n, P=P, device=dev)
             for n, P in (("comd", 128), ("hacc", 96))}
    cfg = SIM.SimConfig(n_cu=16, n_wf=20, n_epochs=40)
    mechs = ("crisp", "accreac", "pcstall", "accpc")
    grid = {"epoch_us": [1.0, 10.0]}
    before = dict(KEF.epoch_fused.launches_by_family)
    tiled = SW.run_grid(progs, dataclasses.replace(cfg, pallas_block_cu=4),
                        grid, mechs)
    after = dict(KEF.epoch_fused.launches_by_family)
    assert after["fork"] - before["fork"] == 40
    mono = SW.run_grid(progs, cfg, grid, mechs)
    for key in mono:
        for w in progs:
            for m in mechs:
                for k, v in mono[key][w][m].items():
                    assert np.array_equal(tiled[key][w][m][k], v), \
                        (key, w, m, k)


def test_grid_dispatch_never_syncs(dev):
    """GridExecutor.dispatch issues no host-device synchronisation: torch's
    sync debug mode turns any synchronising call into an error. The
    traces are read after it is switched off."""
    progs = [get_workload(n, P=P, device=dev)
             for n, P in (("comd", 128), ("hacc", 96))]
    cfg = SIM.SimConfig(n_cu=8, n_wf=12, n_epochs=6)
    ex = SW.GridExecutor(cfg, ("static17", "crisp", "pcstall", "oracle"),
                         p_max=128, buckets=(2, 4))
    jobs = [(p, {"epoch_us": e}) for p in progs for e in (1.0, 10.0)]
    ex.run(jobs[:1])                         # build the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ex.dispatch(jobs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = pending.traces()
    assert len(out) == 4
    assert all(np.isfinite(v).all() for t in out for tr in t.values()
               for v in tr.values())


@pytest.mark.parametrize("use_pallas", [True, False])
def test_grid_bitwise_contracts_on_card(dev, use_pallas):
    """On the card, as on the CPU: suite == one-point grid, grid row ==
    per-point grid, streamed == one-shot, for the kernel family and the
    vmapped unfused families alike."""
    progs = {n: get_workload(n, P=P, device=dev)
             for n, P in (("comd", 128), ("hacc", 96), ("dgemm", 112))}
    cfg = SIM.SimConfig(n_cu=16, n_wf=20, n_epochs=30,
                        use_pallas=use_pallas)
    mechs = ("static17", "crisp", "pcstall", "accpc", "oracle")
    grid = SW.run_grid(progs, cfg, {"epoch_us": [1.0, 10.0],
                                    "objective": ["ed2p", "edp"]}, mechs)
    suite = SW.run_suite(progs, cfg, mechs)
    one = SW.run_grid(progs, cfg, [{}], mechs)[()]
    ex = SW.GridExecutor(cfg, mechs, p_max=128, buckets=(2, 4, 8))
    jobs = [(progs[w], {"epoch_us": e, "objective": o})
            for w in progs for e in (1.0, 10.0) for o in ("ed2p", "edp")]
    streamed = []
    for i in range(0, len(jobs), 3):
        streamed += ex.dispatch(jobs[i:i + 3]).traces()
    for w in progs:
        for m in mechs:
            for k in one[w][m]:
                assert np.array_equal(one[w][m][k], suite[w][m][k]), (w, m)
    for key in grid:
        pt = dict(zip(("epoch_us", "objective"), key))
        per = SW.run_grid(progs, cfg, [pt], mechs)[key]
        for w in progs:
            for m in mechs:
                for k in per[w][m]:
                    assert np.array_equal(per[w][m][k], grid[key][w][m][k]), \
                        (key, w, m, k)
    for (prog, ov), tr in zip(jobs, streamed):
        ref = grid[(ov["epoch_us"], ov["objective"])][prog.name]
        for m in mechs:
            for k in ref[m]:
                assert np.array_equal(tr[m][k], ref[m][k]), (prog.name, m)


def test_service_on_card_bitwise_and_dispatch_never_syncs(dev):
    """The runtime on the card with the fork family on K5 (two blocks of
    38 CUs): an executor dispatch at the service's configuration issues no
    host-device synchronisation (sync debug mode), and the service's
    streamed rows equal the one-shot ``run_grid`` bit for bit."""
    from repro_torch.dvfs_runtime.service import DVFSService
    progs = {n: get_workload(n, P=P, device=dev)
             for n, P in (("comd", 1024), ("xsbench", 512))}
    cfg = SIM.SimConfig(n_cu=76, n_wf=40, pallas_block_cu=38, n_epochs=12)
    mechs = ("static17", "pcstall")
    jobs = [(progs[w], {"epoch_us": e}) for w in progs for e in (1.0, 10.0)]
    ex = SW.GridExecutor(cfg, mechs, buckets=(4,))
    ex.run(jobs[:1])                         # build the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ex.dispatch(jobs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(pending.traces()) == 4
    ref = SW.run_grid(progs, cfg, {"epoch_us": [1.0, 10.0]}, mechs)
    before = KEF.epoch_fused.launches_by_family["fork"]
    with DVFSService(cfg, max_batch=2, coalesce_s=0.01) as svc:
        results = svc.map(jobs)
    assert KEF.epoch_fused.launches_by_family["fork"] > before
    for (prog, ov), res in zip(jobs, results):
        want = ref[(ov["epoch_us"],)][prog.name]
        for m in mechs:
            for k, v in want[m].items():
                assert np.array_equal(res["traces"][m][k], v), \
                    (prog.name, ov, m, k)
        assert np.isfinite(res["report"]["ed2p_norm"])


# ---------------------------------------------------------------------------
# K6 (flash attention) and K7 (chunked RWKV6 WKV)
# ---------------------------------------------------------------------------

# K6 in f32 to 2e-5 (the kernel and the plain version sum the products and
# the softmax denominator in different orders); in bf16 to the output's
# rounding: the two f32 results round to bf16 values at most one ulp
# (2^-7 relative) apart. K7 to 1e-4, the reference's own bound for its
# chunked kernel against the exact scan.
K6_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
K7_TOL = 1e-4


def _qkv(B, S, H, Hkv, hd, dtype, dev, seed=0, q_scale=1.0):
    """q, k, v from a numpy seed; ``q_scale`` (a power of two, exact in
    bf16) scales the scores."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    return [torch.as_tensor(a).to(dev, dtype) for a in (q * q_scale, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,q_scale", [
    (1, 128, 2, 2, 64, True, 0, 1.0),
    (2, 256, 4, 2, 64, True, 0, 1.0),
    (1, 256, 4, 1, 128, True, 0, 1.0),      # MQA
    (2, 512, 2, 2, 32, True, 0, 1.0),
    (1, 64, 4, 2, 16, True, 0, 1.0),        # S < blk
    (1, 32, 2, 1, 128, True, 0, 1.0),       # S < one staged sub-tile
    (1, 256, 2, 2, 64, True, 32, 1.0),
    (1, 256, 2, 2, 64, True, 128, 1.0),
    (1, 384, 2, 1, 64, False, 0, 1.0),
    (1, 384, 2, 1, 64, False, 100, 1.0),
    (2, 1024, 8, 2, 128, True, 0, 1.0),
    # the bf16 kernel's edges: S below one 64-row wgmma tile, its 24-key
    # block padded inside a 64-key sub-tile; 32:1 GQA at hd 128; causal
    # with a window; scores x 8, so p spans many binades and the split of p
    # into two bf16 terms is what holds the result to one bf16 ulp
    (2, 24, 4, 2, 64, True, 0, 1.0),
    (1, 256, 32, 1, 128, True, 0, 1.0),
    (1, 512, 4, 2, 128, True, 100, 1.0),
    (2, 512, 4, 2, 128, True, 0, 8.0),
    # head dim 96 (phi3-mini): 32 MHA heads, GQA, a window, and scores x 8
    (1, 256, 32, 32, 96, True, 0, 1.0),
    (2, 512, 8, 2, 96, True, 0, 1.0),
    (1, 384, 4, 4, 96, True, 100, 1.0),
    (1, 384, 4, 2, 96, False, 0, 8.0),
    # hymba-1.5b's layout: a GQA group of 5 with its 1024-token window
    (1, 2048, 25, 5, 64, True, 1024, 1.0),
    # head dim 256 (paligemma-3b): GQA with a window, MQA with scores x 8
    (1, 512, 8, 2, 256, True, 100, 1.0),
    (2, 384, 8, 1, 256, True, 0, 8.0),
])
def test_flash_attention_kernel_matches_plain(dev, dtype, B, S, H, Hkv, hd,
                                              causal, window, q_scale):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(B, S, H, Hkv, hd, dtype, dev, q_scale=q_scale)
    n0 = FA.flash_attention_bshd.launches
    got = FA.flash_attention_bshd(q, k, v, causal=causal, window=window)
    assert FA.flash_attention_bshd.launches == n0 + 1
    want = FA.flash_attention_bshd_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = K6_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,blk", [
    (512, 32), (512, 64), (512, 256),
    # key blocks that are not a multiple of the bf16 kernel's 64-key
    # sub-tile, and a sequence that is not a multiple of its 128-row tile
    (384, 48), (384, 96), (320, 64),
])
def test_flash_attention_kernel_key_blocks(dev, dtype, S, blk):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(1, S, 4, 2, 64, dtype, dev, seed=3)
    got = FA.flash_attention_bshd(q, k, v, blk_q=blk, blk_k=blk)
    want = FA.flash_attention_bshd_ref(q, k, v, blk_q=blk, blk_k=blk)
    rtol, atol = K6_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,prefix,blk", [
    (4, 2048, 8, 1, 256, True, 0, 256, 128),   # paligemma-3b's prefill
    (1, 512, 4, 2, 64, True, 0, 200, 128),     # not a multiple of the block
    # a prefix with a window: key blocks between the two are skipped
    (1, 1024, 4, 2, 128, True, 100, 150, 128),
    (1, 1024, 4, 1, 256, True, 64, 100, 128),  # the same at head dim 256
    (1, 384, 2, 1, 64, False, 100, 50, 128),   # non-causal, a window
    (2, 256, 8, 1, 256, True, 0, 256, 128),    # prefix_len = S
    (1, 384, 4, 2, 32, True, 0, 384, 96),      # prefix_len = S, 96 keys
    (1, 512, 4, 1, 256, True, 0, 70, 64),      # head dim 256, 64-key blocks
    (1, 512, 4, 2, 64, True, 0, 300, 256),     # 256-key blocks
], ids=["paligemma", "p200", "p150-w100", "hd256-p100-w64",
        "noncausal-p50-w100", "hd256-pS", "hd32-pS-blk96", "hd256-blk64",
        "blk256"])
def test_flash_attention_kernel_prefix_lm_matches_plain(
        dev, dtype, B, S, H, Hkv, hd, causal, window, prefix, blk):
    """K6 with ``prefix_len``: (causal & window) | (key < prefix_len)
    against its plain version, one launch a call."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(B, S, H, Hkv, hd, dtype, dev, seed=prefix)
    kw = dict(causal=causal, window=window, prefix_len=prefix, blk_k=blk)
    n0 = FA.flash_attention_bshd.launches
    got = FA.flash_attention_bshd(q, k, v, **kw)
    assert FA.flash_attention_bshd.launches == n0 + 1
    want = FA.flash_attention_bshd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    rtol, atol = K6_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def test_flash_attention_kernel_refuses_a_bad_prefix_and_a_long_ring(dev):
    """A ``prefix_len`` outside [0, S], and at head dim 256 in bf16 a key
    block past the two 64-key sub-tiles its K ring holds, raise before
    any launch (f32 takes the 256-key block)."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(1, 512, 2, 1, 256, torch.bfloat16, dev)
    n0 = FA.flash_attention_bshd.launches
    for prefix in (-1, 513):
        with pytest.raises(ValueError, match="prefix_len"):
            FA.flash_attention_bshd(q, k, v, prefix_len=prefix)
    with pytest.raises(ValueError, match="K ring"):
        FA.flash_attention_bshd(q, k, v, blk_k=256)
    assert FA.flash_attention_bshd.launches == n0
    qf, kf, vf = (t.float() for t in (q, k, v))
    got = FA.flash_attention_bshd(qf, kf, vf, blk_k=256)
    assert FA.flash_attention_bshd.launches == n0 + 1
    np.testing.assert_allclose(
        got.cpu().numpy(),
        FA.flash_attention_bshd_ref(qf, kf, vf, blk_k=256).cpu().numpy(),
        rtol=2e-5, atol=2e-5)


def test_flash_attention_kernel_ignores_blk_q(dev):
    """K6 tiles its own query rows (64 in f32, 128 in bf16) whatever
    ``blk_q`` says: a query block that does not divide S is accepted and
    changes nothing."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(1, 96, 2, 1, 32, torch.float32, dev, seed=5)
    got = FA.flash_attention_bshd(q, k, v, blk_q=64, blk_k=32)
    torch.testing.assert_close(
        got, FA.flash_attention_bshd(q, k, v, blk_q=32, blk_k=32),
        rtol=0, atol=0)
    want = FA.flash_attention_bshd_ref(q, k, v, blk_k=32)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_bhsd_counts_one_launch(dev):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    q, k, v = (t[:, :, 0] for t in _qkv(3, 128, 1, 1, 64, torch.float32,
                                        dev, seed=4))
    n0 = FA.flash_attention_bshd.launches
    got = FA.flash_attention_bhsd(q, k, v)
    assert FA.flash_attention_bshd.launches == n0 + 1
    want = FA.flash_attention_ref(q, k, v)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    q4, k4, v4 = _qkv(1, 128, 4, 2, 64, torch.float32, dev)
    ops.flash_attention(q4, k4, v4)
    assert FA.flash_attention_bshd.launches == n0 + 2


def test_flash_attention_kernel_refuses_bad_operands(dev):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(1, 128, 2, 2, 48, torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_bshd(q, k, v)
    q, k, v = _qkv(1, 128, 2, 2, 64, torch.float16, dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        FA.flash_attention_bshd(q, k, v)
    q, k, v = _qkv(1, 128, 2, 2, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_bshd(q, k.transpose(1, 2).contiguous()
                                .transpose(1, 2), v)


def test_flash_attention_bf16_kernel_is_wgmma_without_spills(dev):
    """The bf16 kernel runs on the tensor cores: its SASS holds HGMMA (the
    warpgroup matrix multiply), and ptxas spills none of its registers, in
    either instance (without and with a prefix) of any head dim."""
    lib = K.library()
    props = re.findall(
        r"Function properties for (\S*flash_attention_kernel_wgmma\S*)\n"
        r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
        r"bytes spill loads", K.BUILD["log"])
    assert len(props) == 12, \
        "two ptxas reports per head dim (16/32/64/96/128/256)"
    for name, _, stores, loads in props:
        assert (stores, loads) == ("0", "0"), f"{name} spills"
    tool = shutil.which("cuobjdump") or str(
        Path(K._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        pytest.skip("cuobjdump is not installed")
    sass = subprocess.run([tool, "--dump-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    tc = [f for f in funcs
          if "flash_attention_kernel_wgmma" in f.split("\n", 1)[0]]
    assert len(tc) == 12
    for f in tc:
        assert "HGMMA" in f, f.split("\n", 1)[0]


def test_flash_attention_f32_kernel_spills_nothing(dev):
    """ptxas spills none of the f32 kernel's registers at any head dim
    (16/32/64/96/128/256)."""
    K.library()
    props = re.findall(
        r"Function properties for (\S*flash_attention_kernelI\S*)\n"
        r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
        r"bytes spill loads", K.BUILD["log"])
    assert len(props) == 6, "one ptxas report per head dim"
    for name, _, stores, loads in props:
        assert (stores, loads) == ("0", "0"), f"{name} spills"


def _rwkv_case(B, T, H, hd, lo, hi, dev, seed=0):
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    r, k, v = (f32(rng.standard_normal((B, T, H, hd)) * 0.5)
               for _ in range(3))
    w = f32(rng.uniform(lo, hi, (B, T, H, hd)))
    u = f32(rng.standard_normal((H, hd)) * 0.1)
    return r, k, v, w, u


@pytest.mark.parametrize("B,T,H,hd,chunk,lo,hi", [
    (2, 256, 3, 64, 128, 0.6, 0.999),
    (1, 512, 2, 64, 128, 0.9, 0.999),
    (2, 256, 2, 32, 64, 0.6, 0.999),
    (1, 128, 4, 32, 32, 0.6, 0.95),
    (1, 96, 1, 64, 128, 0.8, 0.999),      # T < chunk: one chunk of T
    # tiles well beyond one wave (each chunk waits on its predecessor's
    # count, whatever order the CTAs run in), every head dim K7 has
    (2, 2048, 40, 64, 128, 0.6, 0.999),   # 1280 tiles, ~10 waves
    (2, 1024, 8, 32, 128, 0.6, 0.999),
    (1, 512, 6, 16, 64, 0.6, 0.999),      # the smoke models' heads
    (1, 256, 3, 128, 64, 0.6, 0.999),     # the largest chunk at hd 128
    # T == chunk: one tile per (batch, head), the state its own increment
    (3, 128, 5, 32, 128, 0.6, 0.999),
    (3, 128, 5, 64, 128, 0.6, 0.999),
])
def test_rwkv_chunk_kernel_matches_plain(dev, B, T, H, hd, chunk, lo, hi):
    from repro_torch.kernels import rwkv_chunk as RC
    r, k, v, w, u = _rwkv_case(B, T, H, hd, lo, hi, dev)
    n0 = RC.rwkv_chunked_bthd.launches
    y, S = RC.rwkv_chunked_bthd(r, k, v, w, u, chunk=chunk,
                                return_state=True)
    assert RC.rwkv_chunked_bthd.launches == n0 + 1
    yw, Sw = RC.rwkv_chunked_bthd_ref(r, k, v, w, u, chunk=chunk,
                                      return_state=True)
    torch.cuda.synchronize()
    for got, want in ((y, yw), (S, Sw)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=K7_TOL, atol=K7_TOL)


def test_rwkv_chunk_kernel_two_calls_bitwise_equal(dev):
    """The chain sums in chunk order and uses integer atomics only: two
    calls at the rwkv6-3b head shape give the same bits."""
    from repro_torch.kernels import rwkv_chunk as RC
    r, k, v, w, u = _rwkv_case(2, 2048, 40, 64, 0.6, 0.999, dev, seed=12)
    y1, S1 = RC.rwkv_chunked_bthd(r, k, v, w, u, return_state=True)
    y2, S2 = RC.rwkv_chunked_bthd(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(S1, S2)


def test_rwkv_chunk_kernel_refuses_other_head_dims(dev):
    from repro_torch.kernels import rwkv_chunk as RC
    r, k, v, w, u = _rwkv_case(1, 256, 2, 48, 0.8, 0.999, dev)
    n0 = RC.rwkv_chunked_bthd.launches
    with pytest.raises(ValueError, match="head dims"):
        RC.rwkv_chunked_bthd(r, k, v, w, u)
    with pytest.raises(ValueError, match="shared memory"):
        RC.rwkv_chunked_bthd(*_rwkv_case(1, 256, 2, 128, 0.8, 0.999, dev))
    assert RC.rwkv_chunked_bthd.launches == n0


def test_rwkv_chunk_kernel_without_state(dev):
    """Without ``return_state`` (the prefill's call) K7 writes y alone,
    the same y as with the state."""
    from repro_torch.kernels import rwkv_chunk as RC
    r, k, v, w, u = _rwkv_case(2, 256, 2, 64, 0.6, 0.999, dev, seed=2)
    n0 = RC.rwkv_chunked_bthd.launches
    y = RC.rwkv_chunked_bthd(r, k, v, w, u)
    assert RC.rwkv_chunked_bthd.launches == n0 + 1
    y_s, _ = RC.rwkv_chunked_bthd(r, k, v, w, u, return_state=True)
    torch.testing.assert_close(y, y_s, rtol=0, atol=0)


def test_rwkv_chunked_bhsd_layout_counts_one_launch(dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv_chunk as RC
    rng = np.random.default_rng(5)
    BH, T, hd = 3, 256, 64
    r, k, v = (torch.as_tensor(rng.standard_normal((BH, T, hd)) * 0.5,
                               dtype=torch.float32).to(dev)
               for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.8, 0.999, (BH, T, hd)),
                        dtype=torch.float32).to(dev)
    u = torch.as_tensor(rng.standard_normal((BH, hd)) * 0.1,
                        dtype=torch.float32).to(dev)
    n0 = RC.rwkv_chunked_bthd.launches
    got = ops.rwkv_chunked(r, k, v, w, u, chunk=128)
    assert RC.rwkv_chunked_bthd.launches == n0 + 1
    want = RC.rwkv_chunked_ref(r, k, v, w, u, chunk=128)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=K7_TOL, atol=K7_TOL)


def test_rwkv_chunk_kernel_refuses_state_and_large_chunks(dev):
    from repro_torch.kernels import rwkv_chunk as RC
    r, k, v, w, u = _rwkv_case(1, 256, 2, 64, 0.8, 0.999, dev)
    with pytest.raises(ValueError, match="zero state"):
        RC.rwkv_chunked_bthd(r, k, v, w, u,
                             S0=torch.zeros((1, 2, 64, 64), device=dev))
    n0 = RC.rwkv_chunked_bthd.launches
    with pytest.raises(ValueError, match="shared memory"):
        RC.rwkv_chunked_bthd(r, k, v, w, u, chunk=256)
    assert RC.rwkv_chunked_bthd.launches == n0


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b"])
def test_prefill_runs_one_kernel_per_layer_and_decode_agrees(dev, arch):
    """A smoke config in f32 on the card: the prefill of 256 tokens
    launches K6 (glm4) or K7 (rwkv6) once per layer, and a token-by-token
    decode of the same tokens ends at the prefill's logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv_chunk as RC
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = M.init_params(cfg, 0, dev)
    S = 256
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, S))).to(dev)
    counter = FA.flash_attention_bshd if arch == "glm4-9b" \
        else RC.rwkv_chunked_bthd
    n0 = counter.launches
    full = M.prefill(params, cfg, {"tokens": toks})
    assert counter.launches == n0 + cfg.n_layers
    cache = M.init_cache(cfg, 1, S, device=dev)
    for i in range(S):
        logits, cache = M.decode_step(params, cfg, cache, toks[:, i])
    assert counter.launches == n0 + cfg.n_layers
    np.testing.assert_allclose(logits.cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_phi3_shaped_prefill_runs_k6_at_head_dim_96(dev):
    """A phi3-mini-shaped model (2 layers, d 192, 2 MHA heads of 96) in
    f32 on the card: the prefill launches K6 at head dim 96 once per layer
    and a token-by-token decode ends at its logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              dtype="float32", d_model=192, n_heads=2,
                              n_kv_heads=2, head_dim=96)
    params = M.init_params(cfg, 0, dev)
    S = 256
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, S))).to(dev)
    n0 = FA.flash_attention_bshd.launches
    full = M.prefill(params, cfg, {"tokens": toks})
    assert FA.flash_attention_bshd.launches == n0 + cfg.n_layers
    cache = M.init_cache(cfg, 1, S, device=dev)
    for i in range(S):
        logits, cache = M.decode_step(params, cfg, cache, toks[:, i])
    np.testing.assert_allclose(logits.cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# the moe and audio models' K6 layouts (query heads, KV heads, head dim):
# musicgen-medium, granite-moe-1b-a400m and qwen2-moe-a2.7b, at a reduced
# sequence; S = 4 is the prompt of chip_smoke.py's moe decode check
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (2, 512, 24, 24, 64), (2, 512, 16, 8, 64), (2, 512, 16, 16, 128),
    (1, 4, 16, 8, 64), (1, 4, 16, 16, 128)],
    ids=["musicgen", "granite-moe", "qwen2-moe", "granite-moe-S4",
         "qwen2-moe-S4"])
def test_flash_attention_kernel_at_the_zoo_layouts(dev, dtype, B, S, H, Hkv,
                                                   hd):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(B, S, H, Hkv, hd, dtype, dev, seed=S + H)
    n0 = FA.flash_attention_bshd.launches
    got = FA.flash_attention_bshd(q, k, v, causal=True)
    assert FA.flash_attention_bshd.launches == n0 + 1
    want = FA.flash_attention_bshd_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    rtol, atol = K6_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def _moe_case(arch, seed):
    """A smoke config's first moe layer in f32 and a (2, 48, d) input,
    on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p = M.init_params(cfg, seed, "cpu")["layers"][0]["moe"]
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32))
    return cfg, {k: v.detach() for k, v in p.named_parameters()}, x


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25, 0.5])
def test_moe_layer_on_card_matches_cpu(dev, arch, capacity_factor):
    """The layer on the card against the same function on the CPU, f32 to
    1e-5 (TF32 off), at the default capacity factor and where no pair
    (capacity 96 for 48 tokens) or many drop; the same pairs dropped."""
    from repro_torch import no_tf32
    from repro_torch.models import moe as MOE
    no_tf32()
    cfg, p, x = _moe_case(arch, 11)
    MOE.moe_layer.dropped = 0
    want, aux_want = MOE.moe_layer(x, p, cfg.moe,
                                   capacity_factor=capacity_factor)
    n_cpu = int(MOE.moe_layer.dropped)
    MOE.moe_layer.dropped = 0
    got, aux = MOE.moe_layer(x.to(dev), {k: v.to(dev) for k, v in p.items()},
                             cfg.moe, capacity_factor=capacity_factor)
    assert int(MOE.moe_layer.dropped) == n_cpu
    if capacity_factor != 1.25:
        assert (n_cpu > 0) == (capacity_factor < 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_on_card_is_bitwise_deterministic(dev, dtype):
    """Two card runs of the layer on the same inputs are bitwise equal
    (no atomics in dispatch, combine or aux), with pairs dropped."""
    from repro_torch.models import moe as MOE
    cfg, p, x = _moe_case("qwen2-moe-a2.7b", 12)
    dt = getattr(torch, dtype)
    p = {k: v.to(dev, torch.float32 if k == "router" else dt)
         for k, v in p.items()}
    x = x.to(dev, dt)
    runs = [MOE.moe_layer(x, p, cfg.moe, capacity_factor=0.5)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                                  "musicgen-medium"])
def test_zoo_prefill_runs_k6_per_layer_and_matches_cpu(dev, arch):
    """A smoke config in f32: the prefill on the card launches K6 once per
    layer and lands on the CPU's logits (plain K6) to 1e-5; a decode of
    its 4 tokens (no moe pair can drop at 4) ends at them."""
    from repro_torch import no_tf32
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    no_tf32()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = M.init_params(cfg, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 64)))
    want = M.prefill(params, cfg, {"tokens": toks})
    params = params.to(dev)
    n0 = FA.flash_attention_bshd.launches
    got = M.prefill(params, cfg, {"tokens": toks.to(dev)})
    assert FA.flash_attention_bshd.launches == n0 + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    full = M.prefill(params, cfg, {"tokens": toks[:1, :4].to(dev)})
    cache = M.init_cache(cfg, 1, 4, device=dev)
    for i in range(4):
        logits, cache = M.decode_step(params, cfg, cache,
                                      toks[:1, i].to(dev))
    np.testing.assert_allclose(logits.cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head_dim", [16, 256])
def test_vlm_prefill_runs_k6_per_layer_and_matches_cpu(dev, head_dim):
    """The paligemma smoke config in f32 (and at paligemma's head dim 256):
    4 patch embeddings before 60 tokens; the prefill on the card launches
    K6 once per layer with the prefix and lands on the CPU's logits (plain
    K6) to 1e-5; a token decode (the vlm decodes without the vision step)
    of the text alone ends at the text-only prefill's logits."""
    from repro_torch import no_tf32
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    no_tf32()
    cfg = dataclasses.replace(get_smoke_config("paligemma-3b"),
                              dtype="float32", head_dim=head_dim)
    params = M.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(10)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 60))),
             "patch_embeds": torch.as_tensor(rng.standard_normal(
                 (2, cfg.n_patches, cfg.d_model)).astype(np.float32))}
    want = M.prefill(params, cfg, batch)
    params = params.to(dev)
    n0 = FA.flash_attention_bshd.launches
    got = M.prefill(params, cfg, {k: v.to(dev) for k, v in batch.items()})
    assert FA.flash_attention_bshd.launches == n0 + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    text = dataclasses.replace(cfg, frontend="none")
    toks = batch["tokens"][:1, :32].to(dev)
    full = M.prefill(params, text, {"tokens": toks})
    cache = M.init_cache(cfg, 1, 32, device=dev)
    for i in range(32):
        logits, cache = M.decode_step(params, cfg, cache, toks[:, i])
    np.testing.assert_allclose(logits.cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# K8 (the selective scan) against its plain version: y and h_out within
# 1e-4 + 1e-5 |ref| (the kernel sums y over the state in another order)
def _scan_case(B, S, H, hd, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = (rng.standard_normal((B, S, H, hd)).astype(f),
            rng.uniform(0.01, 1.5, (B, S, H)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            -rng.uniform(0.2, 2.0, H).astype(f),
            rng.standard_normal((B, H, hd, N)).astype(f) * 0.5)
    return [torch.as_tensor(a).to(dev) for a in arrs]


@pytest.mark.parametrize("B,S,H,hd,N", [
    (1, 1, 2, 64, 16),        # a decode step
    (2, 33, 3, 16, 8),        # S past one 32-token tile, not a multiple
    (3, 100, 4, 32, 16),
    (2, 64, 2, 128, 8),
    (4, 257, 25, 64, 16),     # hymba's heads and state
])
def test_ssm_scan_kernel_matches_plain(dev, B, S, H, hd, N):
    from repro_torch.kernels import ssm_scan as SS
    args = _scan_case(B, S, H, hd, N, dev, seed=S)
    n0 = SS.ssm_scan.launches
    y, h = SS.ssm_scan(*args)
    assert SS.ssm_scan.launches == n0 + 1
    y_ref, h_ref = SS.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    assert y.shape == (B, S, H, hd) and h.shape == (B, H, hd, N)
    _close(y, y_ref, "y")
    _close(h, h_ref, "h_out")


def test_ssm_scan_kernel_two_calls_bitwise_equal(dev):
    from repro_torch.kernels import ssm_scan as SS
    args = _scan_case(2, 300, 5, 64, 16, dev, seed=1)
    y1, h1 = SS.ssm_scan(*args)
    y2, h2 = SS.ssm_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("hd,N", [(48, 16), (64, 12)])
def test_ssm_scan_kernel_refuses_other_shapes(dev, hd, N):
    """A head dim or state size K8 has no kernel for raises before any
    launch; so does an operand that is not f32."""
    from repro_torch.kernels import ssm_scan as SS
    args = _scan_case(1, 8, 2, hd, N, dev)
    n0 = SS.ssm_scan.launches
    with pytest.raises(ValueError, match="K8 has kernels"):
        SS.ssm_scan(*args)
    args = _scan_case(1, 8, 2, 64, 16, dev)
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="dtype"):
        SS.ssm_scan(*args)
    assert SS.ssm_scan.launches == n0


# K8's backward against its plain version: each output within 1e-4 of its
# largest magnitude + 1e-5 |ref| (the kernel sums over the channels and
# tokens in other orders than the plain version's einsums)
def _bwd_close(got, want, what):
    for name, g, w in zip(("dxh", "ddt", "dB_", "dC_", "dA", "dh0"), got,
                          want):
        g, w = g.cpu().double(), w.cpu().double()
        assert g.shape == w.shape, (what, name)
        lim = 1e-4 * float(w.abs().max()) + 1e-5 * w.abs()
        assert bool(((g - w).abs() <= lim).all()), (
            what, name, float((g - w).abs().max() / w.abs().max()))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("N", [8, 16])
def test_ssm_scan_bwd_kernel_matches_plain(dev, hd, N):
    """Every (hd, N) the backward kernel is built for, from a non-zero h0
    and with a g_hout, S not a multiple of its 8-token tile (and one
    tile, and S = 1)."""
    from repro_torch.kernels import ssm_scan as SS
    for B, S, H in ((2, 37, 3), (1, 8, 2), (2, 1, 2)):
        args = _scan_case(B, S, H, hd, N, dev, seed=S + hd + N)
        rng = np.random.default_rng(S)
        gy = torch.as_tensor(rng.standard_normal((B, S, H, hd)).astype(
            np.float32)).to(dev)
        gh = torch.as_tensor(rng.standard_normal((B, H, hd, N)).astype(
            np.float32)).to(dev)
        n0 = SS.ssm_scan_bwd.launches
        got = SS.ssm_scan_bwd(*args, gy, gh)
        assert SS.ssm_scan_bwd.launches == n0 + 1
        want = SS.ssm_scan_bwd_ref(*args, gy, gh)
        torch.cuda.synchronize()
        _bwd_close(got, want, (B, S, H, hd, N))


def test_ssm_scan_bwd_kernel_at_hymba_layout_bitwise_twice(dev):
    """hymba's 25 heads of 64 and state 16 at 300 tokens: against the
    plain version, and two calls bit for bit equal (the sums over channels
    and heads in a fixed order; no atomics)."""
    from repro_torch.kernels import ssm_scan as SS
    args = _scan_case(2, 300, 25, 64, 16, dev, seed=3)
    rng = np.random.default_rng(4)
    gy = torch.as_tensor(rng.standard_normal((2, 300, 25, 64)).astype(
        np.float32)).to(dev)
    gh = torch.as_tensor(rng.standard_normal((2, 25, 64, 16)).astype(
        np.float32)).to(dev)
    a = SS.ssm_scan_bwd(*args, gy, gh)
    b = SS.ssm_scan_bwd(*args, gy, gh)
    want = SS.ssm_scan_bwd_ref(*args, gy, gh)
    torch.cuda.synchronize()
    _bwd_close(a, want, "hymba")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hd,N", [(48, 16), (64, 12)])
def test_ssm_scan_bwd_kernel_refuses_other_shapes(dev, hd, N):
    """A head dim or state size the backward has no kernel for raises
    before any launch; so does an operand that is not f32."""
    from repro_torch.kernels import ssm_scan as SS
    args = _scan_case(1, 8, 2, hd, N, dev)
    gy = torch.zeros_like(args[0])
    gh = torch.zeros_like(args[5])
    n0 = SS.ssm_scan_bwd.launches
    with pytest.raises(ValueError, match="K8 has kernels"):
        SS.ssm_scan_bwd(*args, gy, gh)
    args = _scan_case(1, 8, 2, 64, 16, dev)
    with pytest.raises(ValueError, match="dtype"):
        SS.ssm_scan_bwd(*args, torch.zeros_like(args[0]).double(),
                        torch.zeros_like(args[5]))
    assert SS.ssm_scan_bwd.launches == n0


def test_scan_functions_grad_on_card_match_plain(dev):
    """K8's and K7's Functions on the card (forward and backward kernels
    for K8, K7's forward and its backward in PyTorch operations) against
    autograd through their plain versions on the same inputs, f32, TF32
    off: each gradient to 1e-4 of its largest magnitude."""
    from repro_torch import no_tf32
    from repro_torch.kernels import rwkv_chunk as RC
    from repro_torch.kernels import ssm_scan as SS
    no_tf32()
    args = _scan_case(2, 70, 5, 64, 16, dev, seed=8)
    rng = np.random.default_rng(8)
    gy = torch.as_tensor(rng.standard_normal((2, 70, 5, 64)).astype(
        np.float32)).to(dev)
    gh = torch.as_tensor(rng.standard_normal((2, 5, 64, 16)).astype(
        np.float32)).to(dev)
    ins = [t.clone().requires_grad_() for t in args]
    n = (SS.ssm_scan.launches, SS.ssm_scan_bwd.launches)
    got = torch.autograd.grad(SS.SsmScan.apply(*ins), ins, (gy, gh))
    assert (SS.ssm_scan.launches, SS.ssm_scan_bwd.launches) == (n[0] + 1,
                                                                 n[1] + 1)
    ins = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(SS.ssm_scan_ref(*ins), ins, (gy, gh))
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-4
    r, k, v, w, u = _rwkv_case(2, 512, 3, 64, 0.6, 0.999, dev, seed=9)
    gy = torch.randn(r.shape, generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    n7 = RC.rwkv_chunked_bthd.launches
    y, _ = RC.RwkvChunk.apply(*ins, 128)
    got = torch.autograd.grad(y, ins, gy)
    assert RC.rwkv_chunked_bthd.launches == n7 + 1
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    want = torch.autograd.grad(RC.rwkv_chunked_bthd_ref(*ins), ins, gy)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert float((g - w_).abs().max() / w_.abs().max()) < 1e-4


@pytest.mark.parametrize("window", [1024, 16])
def test_hybrid_prefill_runs_k6_and_k8_per_layer_and_matches_cpu(dev,
                                                                 window):
    """The hymba smoke config in f32: the prefill on the card launches K6
    and K8 once per layer and lands on the CPU's logits (plain versions)
    to 1e-5; a token-by-token decode of 64 tokens (K8 once per layer and
    step) ends at the card's prefill logits."""
    from repro_torch import no_tf32
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.models import model as M
    no_tf32()
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                              dtype="float32", window=window)
    params = M.init_params(cfg, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 64)))
    want = M.prefill(params, cfg, {"tokens": toks})
    params = params.to(dev)
    n6, n8 = FA.flash_attention_bshd.launches, SS.ssm_scan.launches
    got = M.prefill(params, cfg, {"tokens": toks.to(dev)})
    assert FA.flash_attention_bshd.launches == n6 + cfg.n_layers
    assert SS.ssm_scan.launches == n8 + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    cache = M.init_cache(cfg, 2, 64, device=dev)
    for i in range(64):
        logits, cache = M.decode_step(params, cfg, cache, toks[:, i].to(dev))
    assert SS.ssm_scan.launches == n8 + cfg.n_layers * 65
    np.testing.assert_allclose(logits.cpu().numpy(), got.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: K6's gradient and the train step on the card
# ---------------------------------------------------------------------------


def _grad_ref(q, k, v, do, causal, window, prefix, blk):
    """dq, dk, dv by autograd through K6's plain version in f32."""
    from repro_torch.kernels import flash_attention as FA
    qs, ks, vs = (t.detach().float().requires_grad_() for t in (q, k, v))
    out = FA.flash_attention_bshd_ref(qs, ks, vs, causal=causal,
                                      window=window, prefix_len=prefix,
                                      blk_k=blk)
    return torch.autograd.grad(out, (qs, ks, vs), do.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,prefix,blk", [
    (1, 128, 4, 2, 16, 0, 0, 128),       # S = one key block
    (2, 256, 2, 1, 256, 0, 256, 128),    # head dim 256, prefix = S
    (1, 512, 4, 1, 64, 100, 0, 128),     # a window, GQA 4
    (1, 384, 4, 2, 16, 0, 40, 64),       # a prefix, S past a 256 block
])
def test_flash_attention_grad_on_card_matches_plain(dev, dtype, B, S, H, Hkv,
                                                    hd, window, prefix, blk):
    """The Function (forward on K6, one launch that also writes the rows'
    log-sum-exp; backward on K6's backward kernels, one call counted on
    ``flash_attention_bshd_bwd.launches``, no K6 launch) against autograd
    through the plain version in f32 on the same inputs: f32 to 1e-4 of
    each gradient's largest magnitude (both sum up to S terms in other
    orders; TF32 off), bf16 (inputs rounded to bf16, the reference from
    those values in f32) to 2e-2 (K6's bf16 output, p and ds rounded to
    bf16 as product operands, and the bf16 gradients: a few bf16 ulps of
    the largest element)."""
    from repro_torch import no_tf32
    from repro_torch.kernels import flash_attention as FA
    no_tf32()
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    want = _grad_ref(q, k, v, do, True, window, prefix, blk)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    n = FA.flash_attention_bshd.launches
    nb = FA.flash_attention_bshd_bwd.launches
    out = FA.FlashAttention.apply(qs, ks, vs, True, window, prefix, blk)
    assert FA.flash_attention_bshd.launches == n + 1
    assert FA.flash_attention_bshd_bwd.launches == nb
    got = torch.autograd.grad(out, (qs, ks, vs), do)
    torch.cuda.synchronize()
    assert FA.flash_attention_bshd.launches == n + 1
    assert FA.flash_attention_bshd_bwd.launches == nb + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = float((a.float() - b).abs().max() / b.abs().max())
        assert err < tol, (name, err)


# (B, S, H, Hkv, hd, causal, window, prefix, blk): the four above, a
# ragged S at head dims 96 and 128, and no causal mask; then the edges of
# the wgmma kernels' 128-key and 128-row tiles: S past one tile and not a
# multiple of it, S below 64, hymba's group of 5 with a window that crosses
# a key tile, a prefix longer than a key tile, head dim 96 causal with GQA
K6_BWD_LAYOUTS = [
    (1, 128, 4, 2, 16, True, 0, 0, 128),
    (2, 256, 2, 1, 256, True, 0, 256, 128),
    (1, 512, 4, 1, 64, True, 100, 0, 128),
    (1, 384, 4, 2, 16, True, 0, 40, 64),
    (2, 100, 3, 1, 96, True, 0, 0, 128),
    (1, 200, 4, 2, 128, True, 37, 0, 40),
    (1, 192, 2, 1, 32, False, 0, 9, 64),
    (2, 320, 4, 2, 64, True, 0, 0, 64),
    (2, 40, 2, 1, 64, False, 0, 0, 40),
    (1, 512, 25, 5, 64, True, 200, 0, 128),
    (1, 384, 4, 2, 64, True, 0, 160, 128),
    (2, 256, 6, 2, 96, True, 0, 0, 128),
]


def _k6_case(dev, dtype, B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(
        dev, dtype) for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                              (B, S, H, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,prefix,blk",
                         K6_BWD_LAYOUTS)
def test_flash_attention_lse_on_card_matches_plain(dev, dtype, B, S, H, Hkv,
                                                   hd, causal, window, prefix,
                                                   blk):
    """K6's log-sum-exp (``return_lse``) against the plain version's from
    the same inputs (bf16 from the same bf16 values), to 1e-5 of its
    largest magnitude (f32 sums in other orders); the output is the one
    K6 returns without it, bit for bit, and one launch either way."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, _ = _k6_case(dev, dtype, B, S, H, Hkv, hd, S + hd)
    kw = dict(causal=causal, window=window, prefix_len=prefix, blk_k=blk)
    n = FA.flash_attention_bshd.launches
    out, lse = FA.flash_attention_bshd(q, k, v, return_lse=True, **kw)
    assert FA.flash_attention_bshd.launches == n + 1
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert torch.equal(out, FA.flash_attention_bshd(q, k, v, **kw))
    _, want = FA.flash_attention_bshd_ref(q, k, v, return_lse=True, **kw)
    err = float((lse - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,prefix,blk",
                         K6_BWD_LAYOUTS)
def test_flash_attention_bwd_kernel_matches_plain_bitwise_twice(
        dev, dtype, B, S, H, Hkv, hd, causal, window, prefix, blk):
    """K6's backward kernel against its plain version
    (``flash_attention_bshd_bwd_ref``) on the same inputs and log-sum-exp:
    f32 to 1e-4 and bf16 to 2e-2 of each gradient's largest magnitude (p
    and ds rounded to bf16 as product operands, the gradients rounded to
    bf16); one launch a call, and two calls bit for bit (no atomics)."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do = _k6_case(dev, dtype, B, S, H, Hkv, hd, S + H + hd)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = FA.flash_attention_bshd(q, k, v, blk_k=blk, return_lse=True,
                                       **kw)
    n = FA.flash_attention_bshd_bwd.launches
    got = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse, **kw)
    again = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention_bshd_bwd.launches == n + 2
    want = FA.flash_attention_bshd_bwd_ref(q, k, v, out, do, lse, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b, c in zip("qkv", got, again, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, b), name
        err = float((a.float() - c.float()).abs().max()
                    / c.float().abs().max())
        assert err < tol, (name, err)


def test_flash_attention_bwd_refuses_before_a_launch(dev):
    """The backward's wrapper raises on what its kernels do not take, and
    launches nothing: a head dim outside ``HEAD_DIMS``, a missing
    log-sum-exp, mixed dtypes."""
    from repro_torch.kernels import flash_attention as FA
    n = FA.flash_attention_bshd_bwd.launches
    q, k, v, do = _k6_case(dev, torch.bfloat16, 1, 64, 2, 1, 48, 1)
    lse = torch.zeros((1, 2, 64), device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention_bshd_bwd(q, k, v, q, do, lse)
    q, k, v, do = _k6_case(dev, torch.bfloat16, 1, 64, 2, 1, 64, 1)
    with pytest.raises(ValueError, match="log-sum-exp"):
        FA.flash_attention_bshd_bwd(q, k, v, q, do)
    with pytest.raises(ValueError, match="dout: dtype"):
        FA.flash_attention_bshd_bwd(q, k, v, q, do.float(), lse)
    assert FA.flash_attention_bshd_bwd.launches == n


def test_flash_attention_bwd_kernels_spill_nothing(dev):
    """ptxas spills none of the registers of the backward's bf16 kernels
    (the wgmma dk/dv and dq kernels at head dims 16/32/64/96/128, the
    mma.sync ones at 256) or of its pre-pass."""
    K.library()
    props = re.findall(
        r"Function properties for (\S*flash_attention_bwd_(dkdv_wgmma|"
        r"dq_wgmma|dkdv|dq|dot)I\S*)\n\s*(\d+) bytes stack frame, "
        r"(\d+) bytes spill stores, (\d+) bytes spill loads",
        K.BUILD["log"])
    counts = {}
    for _, kind, _, _, _ in props:
        counts[kind] = counts.get(kind, 0) + 1
    assert counts == {"dkdv_wgmma": 5, "dq_wgmma": 5, "dkdv": 1, "dq": 1,
                      "dot": 2}, counts
    for name, _, _, stores, loads in props:
        assert (stores, loads) == ("0", "0"), f"{name} spills"


def _smoke_train(arch, comp="none", mb=2, dtype="float32"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tc = TrainConfig(lr=1e-3, total_steps=8, warmup_steps=2,
                     microbatches=mb, grad_compression=comp)
    return cfg, tc


def _run_steps(cfg, tc, dev, steps, seed=1, start=0, state=None, seq=32):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as TP
    from repro_torch.train import train_step as TT
    shape = ShapeConfig("smoke", seq, 4, "train")
    state = state or TT.init_state(cfg, tc, seed, dev)
    step = TT.make_train_step(cfg, tc)
    out = []
    for i in range(start, steps):
        batch = TP.make_batch(cfg, shape, i, microbatches=tc.microbatches,
                              device="cpu")
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        out.append({k: float(x) for k, x in m.items()})
    return state, out


def _leaves(state):
    out = {"p/" + k: p for k, p in state["params"].named_parameters()}
    out.update({"m/" + k: t for k, t in state["opt"].m.items()})
    out.update({"v/" + k: t for k, t in state["opt"].v.items()})
    out.update({"ef/" + k: t for k, t in state.get("ef", {}).items()})
    out["step"] = state["step"]
    return out


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-moe-1b-a400m"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """One f32 step (two microbatches) of a smoke config on the card
    (forward on K6, one launch per layer, microbatch and recompute)
    against the same step on the CPU from the same state and batch: loss,
    aux and grad_norm to 1e-5 relative, m and v to 1e-5 of their largest
    magnitude, and the update to 1e-4 of lr where |g| >= 1e-6 (module
    docstring of ``tests/test_torch_train.py``)."""
    from repro_torch import no_tf32
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.train import train_step as TT
    no_tf32()
    cfg, tc = _smoke_train(arch)
    cpu = TT.init_state(cfg, tc, 3, "cpu")
    card = TT.init_state(cfg, tc, 3, "cpu")
    card["params"] = card["params"].to(dev)
    card["opt"] = card["opt"]._replace(
        m={k: t.to(dev) for k, t in card["opt"].m.items()},
        v={k: t.to(dev) for k, t in card["opt"].v.items()},
        count=card["opt"].count.to(dev))
    card["step"] = card["step"].to(dev)
    old = {k: p.detach().clone() for k, p in cpu["params"].named_parameters()}
    cpu, (mc,) = _run_steps(cfg, tc, "cpu", 1, state=cpu)
    n = FA.flash_attention_bshd.launches
    card, (mg,) = _run_steps(cfg, tc, dev, 1, state=card)
    assert FA.flash_attention_bshd.launches == n + cfg.n_layers * 2 * 2
    for key in ("loss", "aux", "grad_norm"):
        assert abs(mg[key] - mc[key]) <= 1e-5 * max(abs(mc[key]), 1e-3), key
    lr = mc["lr"]
    for name, p in card["params"].named_parameters():
        m, want_m = card["opt"].m[name].cpu(), cpu["opt"].m[name]
        v, want_v = card["opt"].v[name].cpu(), cpu["opt"].v[name]
        assert float((m - want_m).abs().max()) <= 1e-5 * float(
            want_m.abs().max()), name
        assert float((v - want_v).abs().max()) <= 1e-5 * float(
            want_v.abs().max()), name
        upd = (p.detach().cpu() - old[name]) - (
            dict(cpu["params"].named_parameters())[name].detach() - old[name])
        big = (want_m / (1 - tc.beta1)).abs() >= 1e-6
        assert float(upd.abs()[big].max()) <= 1e-4 * lr, name


@pytest.mark.parametrize("arch,dtype", [("glm4-9b", "float32"),
                                        ("granite-moe-1b-a400m", "bfloat16"),
                                        ("rwkv6-3b", "bfloat16"),
                                        ("hymba-1.5b", "bfloat16")])
def test_train_steps_on_card_are_bitwise_deterministic(dev, arch, dtype):
    """Two runs of the same three steps (two microbatches, int8_ef) on the
    card give the same state bit for bit: no float atomics in any
    gradient (the embedding's, the MoE dispatch's and combine's
    index gathers sum in a fixed order; K8's backward sums over channels
    and heads in a fixed order). rwkv6-3b at 256 tokens (K7's chunked
    WKV)."""
    cfg, tc = _smoke_train(arch, "int8_ef", 2, dtype)
    seq = 256 if arch == "rwkv6-3b" else 32
    runs = [_run_steps(cfg, tc, dev, 3, seq=seq) for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0][1] == runs[1][1]
    a, b = _leaves(runs[0][0]), _leaves(runs[1][0])
    for key in a:
        assert torch.equal(a[key].detach(), b[key].detach()), key


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_scan_train_step_on_card_matches_cpu(dev, arch):
    """One f32 step (two microbatches) of the ssm and hybrid smoke configs
    on the card against the same step on the CPU from the same state and
    batch (rwkv6-3b at 256 tokens: K7's chunked WKV), to
    ``test_train_step_on_card_matches_cpu``'s bounds, but v to 2e-5 of its
    largest magnitude: v is the square of the gradient, so it doubles the
    gradient's relative error (rwkv6-3b's ``w0``, whose gradient is ~1e-5
    of the largest, read 1.04e-5 on an H100 80GB HBM3 at 700 W), and the
    update to 1e-4 of lr plus one f32 ulp of the parameter (the f32
    leaves at 0.5, the ``mu`` mixes, round ``p - step`` to 5.96e-8, more
    than 1e-4 of lr: one flip of the last bit read 5.96e-8 there); per
    layer and microbatch K7 (rwkv) or K6 and K8 (hymba) launch twice (the
    forward and the remat recompute) and K8's backward once."""
    from repro_torch import no_tf32
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv_chunk as RC
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.train import train_step as TT
    no_tf32()
    cfg, tc = _smoke_train(arch)
    seq = 256 if arch == "rwkv6-3b" else 32
    cpu = TT.init_state(cfg, tc, 3, "cpu")
    card = TT.init_state(cfg, tc, 3, "cpu")
    card["params"] = card["params"].to(dev)
    card["opt"] = card["opt"]._replace(
        m={k: t.to(dev) for k, t in card["opt"].m.items()},
        v={k: t.to(dev) for k, t in card["opt"].v.items()},
        count=card["opt"].count.to(dev))
    card["step"] = card["step"].to(dev)
    old = {k: p.detach().clone() for k, p in cpu["params"].named_parameters()}
    cpu, (mc,) = _run_steps(cfg, tc, "cpu", 1, state=cpu, seq=seq)
    counts = (FA.flash_attention_bshd.launches, RC.rwkv_chunked_bthd.launches,
              SS.ssm_scan.launches, SS.ssm_scan_bwd.launches)
    card, (mg,) = _run_steps(cfg, tc, dev, 1, state=card, seq=seq)
    per = cfg.n_layers * tc.microbatches
    want = (0, 2 * per, 0, 0) if arch == "rwkv6-3b" else (2 * per, 0,
                                                          2 * per, per)
    assert tuple(a - b for a, b in zip(
        (FA.flash_attention_bshd.launches, RC.rwkv_chunked_bthd.launches,
         SS.ssm_scan.launches, SS.ssm_scan_bwd.launches), counts)) == want
    for key in ("loss", "grad_norm"):
        assert abs(mg[key] - mc[key]) <= 1e-5 * max(abs(mc[key]), 1e-3), key
    lr = mc["lr"]
    cpu_p = dict(cpu["params"].named_parameters())
    for name, p in card["params"].named_parameters():
        for got, want_, tol in ((card["opt"].m[name], cpu["opt"].m[name],
                                 1e-5),
                                (card["opt"].v[name], cpu["opt"].v[name],
                                 2e-5)):
            assert float((got.cpu() - want_).abs().max()) <= tol * float(
                want_.abs().max()), name
        upd = (p.detach().cpu() - old[name]) - (cpu_p[name].detach()
                                                 - old[name])
        big = (cpu["opt"].m[name] / (1 - tc.beta1)).abs() >= 1e-6
        ulp = old[name].abs() * 2.0 ** -23 if old[name].dtype == \
            torch.float32 else torch.zeros_like(old[name])
        assert bool((upd.abs() <= 1e-4 * lr + ulp)[big].all()), name


def test_resume_is_bit_exact_on_card(dev):
    """The dense smoke config on the card: 6 steps straight equal 3 steps,
    a checkpoint, a restore into a fresh state and 3 more, bit for bit."""
    import tempfile
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TT
    cfg, tc = _smoke_train("glm4-9b", "none", 1, "bfloat16")
    straight, _ = _run_steps(cfg, tc, dev, 6)
    with tempfile.TemporaryDirectory() as d:
        half, _ = _run_steps(cfg, tc, dev, 3)
        CK.save(half, d, step=2)
        fresh, last = CK.restore(TT.init_state(cfg, tc, 1, dev), d)
        resumed, _ = _run_steps(cfg, tc, dev, 6, start=last + 1,
                                state=fresh)
    a, b = _leaves(straight), _leaves(resumed)
    for key in a:
        assert torch.equal(a[key].detach(), b[key].detach()), key


def test_loss_decreases_quick_train_on_card(dev):
    """The reference's quick train (granite-moe-1b-a400m smoke, 40 steps
    at lr 1e-2, warmup 3, 2 x 32 tokens a step) on the card, from the
    port's own draws (init seed 5, the default ``DataConfig``): the loss
    of a held-out batch of 16 sequences falls. The reference's bar (the
    last batch 0.3 below the first) holds for its own draws, which
    ``tests/test_torch_train.py::test_loss_decreases_quick_train`` runs
    through the port on the CPU; over other draws 40 steps at lr 1e-2
    end 0.05-0.53 lower on the held-out batch (CPU runs of the port)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data import pipeline as TP
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TT
    cfg = get_smoke_config("granite-moe-1b-a400m")
    tc = TrainConfig(lr=1e-2, total_steps=40, warmup_steps=3)
    shape = ShapeConfig("smoke", 32, 2, "train")
    held = {k: v[0] for k, v in TP.make_batch(
        cfg, ShapeConfig("held", 32, 16, "train"), 10 ** 6,
        device=dev).items()}
    state = TT.init_state(cfg, tc, 5, dev)
    step = TT.make_train_step(cfg, tc)
    with torch.no_grad():
        before = float(M.loss_fn(state["params"], cfg, held)[0])
    losses = []
    for i in range(40):
        state, m = step(state, TP.make_batch(cfg, shape, i, device=dev))
        losses.append(float(m["loss"]))
    with torch.no_grad():
        after = float(M.loss_fn(state["params"], cfg, held)[0])
    assert all(np.isfinite(losses))
    assert after < before, (before, after, losses[:3] + losses[-3:])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}",
        Path(__file__).resolve().parents[1] / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,kw", [
    ("custom_mechanism", dict(workloads=("comd", "hacc"))),
    ("dvfs_granularity", dict(domains=(1, 4))),
    ("ivr_regime", dict(workloads=("comd", "hacc")))])
def test_grid_examples_on_card_run_the_fork_kernel(dev, name, kw):
    """The three ``run_grid`` examples at 8 CUs x 40 epochs on the card:
    their pcstall (and crisp) rows on K4, every ED^nP finite."""
    before = KEF.epoch_fused.launches_by_family.get("fork", 0)
    res = _example(name).main(device=dev, n_epochs=40, n_cu=8, **kw)
    assert KEF.epoch_fused.launches_by_family["fork"] > before
    vals = [v for r in res.values() for v in r.values()]
    assert vals and all(np.isfinite(v) for v in vals)


def test_serve_batched_example_on_card_runs_k7(dev):
    """A prompt of two 128-token chunks: K7 once per layer of the
    prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import rwkv_chunk as RC
    n = RC.rwkv_chunked_bthd.launches
    rep = _example("serve_batched").main(device=dev, batch=2, prompt_len=256,
                                         gen=4, dvfs=False)
    assert RC.rwkv_chunked_bthd.launches - n == \
        get_smoke_config("rwkv6-3b").n_layers
    assert rep["tokens"].shape == (2, 5) and rep["tokens"].is_cuda


def test_train_lm_example_on_card_runs_k6_and_its_gradient(dev, tmp_path):
    """The example at its own sizes (the llama3 smoke config, 60 steps of
    8 x 128 tokens in 2 microbatches) on the card: K6 twice per layer and
    microbatch (the forward and the remat recompute), the loss falling
    (the example's own assertion), checkpoints written."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    n = FA.flash_attention_bshd.launches
    losses = _example("train_lm").main(str(tmp_path), device=dev)
    layers = get_smoke_config("llama3-405b").n_layers
    assert FA.flash_attention_bshd.launches - n == 60 * layers * 2 * 2
    assert len(losses) == 60 and losses[-1] < losses[0]
    assert (tmp_path / "step_00000059").exists()
