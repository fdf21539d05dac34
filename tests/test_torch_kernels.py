"""Tier 2 of the port's parity: one kernel call at fixed inputs.

The port's kernel wrappers on CPU tensors run their plain PyTorch versions;
each is held against the reference's Pallas kernel run as the reference's
own tests run it on the CPU (the direct-eval interpret engine, and
``pallas_call(interpret=True)`` for the PC-table pair). Both sides get the
same numpy-made inputs, the reference's noise ``eps`` included.

Tolerances: discrete outputs (``fidx``) equal; floats to rtol 1e-5 /
atol 1e-5 — the two packages sum in different orders and the reference's
jitted CPU code contracts multiply-adds into FMAs, so agreement is to a
few ulp, not bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (EPOCH_FAMS, assert_epoch_close,  # noqa: E402
                           epoch_case, epoch_fields, fork_case, np_, t_)
from repro.kernels import epoch_fused as JKEF  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import pc_table as JKPT  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from _torch_rows import fork_rows_case, one_row, row_fields  # noqa: E402
from repro_torch.core import estimators as EST  # noqa: E402
from repro_torch.core import mechanisms as TMECH  # noqa: E402
from repro_torch.core import power as TPWR  # noqa: E402
from repro_torch.core import predictors as PRED  # noqa: E402
from repro_torch.core import simulate as TSIM  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402
from repro_torch.kernels import pc_table as KPT  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402

RTOL = ATOL = 1e-5


def _pc_inputs(T, E, CU, WF, seed):
    rng = np.random.default_rng(seed)
    return dict(
        ti0=rng.uniform(0, 60, (T, E)).astype(np.float32),
        tse=rng.uniform(0, 40, (T, E)).astype(np.float32),
        tcnt=(rng.uniform(size=(T, E)) > 0.4).astype(np.float32),
        tid=rng.integers(0, T, CU).astype(np.int32),
        idx=rng.integers(0, E, (CU, WF)).astype(np.int32),
        fb0=rng.uniform(0, 60, (CU, WF)).astype(np.float32),
        fbs=rng.uniform(0, 40, (CU, WF)).astype(np.float32),
        freqs=np.linspace(1.3, 2.2, 10).astype(np.float32))


def _scalars(kind, **vals):
    """The wrappers' scalar operands as Python floats or as 0-dim f32
    tensors (the engine passes its ``SimAxes`` tensors)."""
    if kind == "float":
        return vals
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in vals.items()}


IDX_DTYPES = pytest.mark.parametrize("idx_dt", [torch.int32, torch.int64],
                                     ids=["i32", "i64"])
SCALAR_KINDS = pytest.mark.parametrize("scalars", ["float", "tensor"])


# the shapes of tests/test_kernels.py::test_pc_table_predict_sweep
@pytest.mark.parametrize("T,E,CU,WF", [(4, 64, 8, 16), (8, 128, 16, 40)])
@pytest.mark.parametrize("cap", [0.0, 60.0])
@IDX_DTYPES
@SCALAR_KINDS
def test_pc_table_predict_matches_reference(T, E, CU, WF, cap, idx_dt,
                                            scalars):
    """I_pred against the reference's kernel (interpret mode) and its
    oracle; the hit mask against the reference's v1 body's own gather
    (``count[tid[:, None], idx] > 0``); int64 slots and tensor scalars give
    the bits of int32 slots and float scalars."""
    d = _pc_inputs(T, E, CU, WF, seed=T * CU)
    names = ("ti0", "tse", "tcnt", "tid", "idx", "fb0", "fbs", "freqs")
    want = JKPT.pc_table_predict(*(jnp.asarray(d[k]) for k in names),
                                 epoch_us=1.0, cap_per_ghz=cap,
                                 interpret=True)
    also = JREF.pc_table_predict_ref(*(jnp.asarray(d[k]) for k in names),
                                     epoch_us=1.0, cap_per_ghz=cap)
    want_hit = (jnp.asarray(d["tcnt"])[jnp.asarray(d["tid"])[:, None],
                                       jnp.asarray(d["idx"])] > 0)
    dts = dict(tid=torch.int32, idx=idx_dt)
    args = [t_(d[k], dts.get(k, torch.float32)) for k in names]
    got, hit = KPT.pc_table_predict(
        *args, **_scalars(scalars, epoch_us=1.0, cap_per_ghz=cap),
        return_hit=True)
    alone = KPT.pc_table_predict(
        *args, **_scalars(scalars, epoch_us=1.0, cap_per_ghz=cap))
    base = [t_(d[k], torch.int32 if k in dts else torch.float32)
            for k in names]
    plain = REF.pc_table_predict_ref(*base, epoch_us=1.0, cap_per_ghz=cap)
    np.testing.assert_array_equal(np_(got), np_(plain))
    np.testing.assert_array_equal(np_(alone), np_(plain))
    np.testing.assert_array_equal(np_(hit), np_(want_hit).astype(np.float32))
    assert hit.dtype == torch.float32 and hit.shape == (CU, WF)
    np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(np_(got), np_(also), rtol=RTOL, atol=1e-3)
    assert KPT.pc_table_predict.launches == 0   # CPU: the plain version


def test_pc_table_predict_clamps_out_of_range_ids():
    """The reference's gathers clamp table ids past the last table; torch
    indexing would raise, so the port clamps explicitly."""
    d = _pc_inputs(4, 64, 6, 8, seed=3)
    d["tid"] = np.array([0, 3, 4, 9, 2, 1], np.int32)
    names = ("ti0", "tse", "tcnt", "tid", "idx", "fb0", "fbs", "freqs")
    want = JOPS.pc_table_predict(*(jnp.asarray(d[k]) for k in names))
    got = KPT.pc_table_predict(*[
        t_(d[k], torch.int32 if k in ("tid", "idx") else torch.float32)
        for k in names])
    np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("T,E,N", [(4, 64, 16), (8, 128, 40), (3, 16, 90)])
@IDX_DTYPES
@SCALAR_KINDS
def test_pc_table_update_matches_reference(T, E, N, idx_dt, scalars):
    """The new tables against the reference's kernel (interpret mode);
    int64 slots and a tensor ``ema`` give the bits of int32 slots and a
    float."""
    rng = np.random.default_rng(T + N)
    tbl = [rng.uniform(0, 60, (T, E)).astype(np.float32),
           rng.uniform(0, 40, (T, E)).astype(np.float32),
           ((rng.uniform(size=(T, E)) > 0.5)
            * rng.integers(1, 5, (T, E))).astype(np.float32)]
    # collisions: N wavefronts over E slots, with repeats
    idx = rng.integers(0, E, (T, N)).astype(np.int32)
    i0 = rng.uniform(0, 60, (T, N)).astype(np.float32)
    se = rng.uniform(0, 40, (T, N)).astype(np.float32)
    want = JKPT.pc_table_update(*map(jnp.asarray, tbl + [idx, i0, se]),
                                ema=0.3, interpret=True)
    got = KPT.pc_table_update(*map(t_, tbl), t_(idx, idx_dt), t_(i0),
                              t_(se), **_scalars(scalars, ema=0.3))
    plain = REF.pc_table_update_ref(*map(t_, tbl), t_(idx, torch.int32),
                                    t_(i0), t_(se), ema=0.3)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(np_(g), np_(p))
        np.testing.assert_allclose(np_(g), np_(w), rtol=RTOL, atol=ATOL)
    assert KPT.pc_table_update.launches == 0


def _run_both(family, fork_est, model, CU, WF, NF, lean, seed, **kw):
    ja, jk, ta, tk = epoch_case(family, CU, WF, NF=NF, seed=seed,
                                fork_estimator=fork_est, cu_model=model,
                                **kw)
    want = JKEF.epoch_fused(*ja, **jk, lean=lean)
    got = KEF.epoch_fused(*ta, **tk, lean=lean)
    return epoch_fields(got), epoch_fields(want), (ta, tk)


# an odd shape (the table-map cases below use it too: the reference's
# eager ops compile once per shape, which dominates this file's time)
@pytest.mark.parametrize("CU,WF,NF", [(5, 7, 6)])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
@pytest.mark.parametrize("family,fork_est,model", EPOCH_FAMS)
def test_epoch_fused_matches_reference(family, fork_est, model, lean, CU, WF,
                                       NF):
    got, want, (ta, tk) = _run_both(family, fork_est, model, CU, WF, NF,
                                    lean, seed=CU * NF + 1)
    assert_epoch_close(got, want, rtol=RTOL, atol=ATOL,
                       what=f"{family}/{model}/lean={lean}")
    # the wrapper on CPU tensors runs the plain version, bit for bit
    plain = epoch_fields(KEF.epoch_fused_ref(*ta, **tk, lean=lean))
    for k in got:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    assert KEF.epoch_fused.launches == 0


def test_epoch_fused_noncontiguous_tid_permutation_invariance():
    """Relabelling table ids (permuting tid and the table rows alike)
    leaves every CU-level output unchanged and permutes the updated table
    rows the same way."""
    T = 3
    perm = np.array([2, 0, 1])
    inv = np.argsort(perm)
    tid_a = np.array([0, 2, 1, 0, 2])
    _, _, ta, tk_a = epoch_case("pc", 5, 7, NF=6, T=T, tid=tid_a, seed=5)
    tk_b = dict(tk_a)
    tk_b["tid"] = t_(perm[tid_a], torch.int32)
    tbl = tk_a["table"]
    tk_b["table"] = type(tbl)(*(x[torch.as_tensor(inv)] for x in tbl))
    a = KEF.epoch_fused(*ta, **tk_a)
    b = KEF.epoch_fused(*ta, **tk_b)
    for field in ("pos", "wf_i0", "wf_sens", "f_sel", "e_acc", "work",
                  "energy", "err", "fidx", "true_sens", "hit_rate"):
        np.testing.assert_array_equal(np_(getattr(a, field)),
                                      np_(getattr(b, field)), err_msg=field)
    for f in ("i0", "sens", "count"):
        np.testing.assert_array_equal(np_(getattr(a.table, f)),
                                      np_(getattr(b.table, f))[perm],
                                      err_msg=f)


def test_epoch_fused_out_of_range_tid_matches_reference():
    """Out-of-range table ids clamp on lookup and drop on update, in both
    packages."""
    T, CU, WF = 3, 5, 7
    tid = np.array([0, 1, T, T + 4, 1])
    ja, jk, ta, tk = epoch_case("pc", CU, WF, NF=6, T=T, tid=tid, seed=9)
    got = KEF.epoch_fused(*ta, **tk)
    want = JKEF.epoch_fused(*ja, **jk)
    assert_epoch_close(epoch_fields(got), epoch_fields(want), rtol=RTOL,
                       atol=ATOL)
    added = float(np_(got.table.count).sum() - np_(tk["table"].count).sum())
    assert added == pytest.approx(int((tid < T).sum()) * WF)


def test_epoch_fused_rejects_unported_modes():
    """The fork family runs (it needs its traced id, and ``mech`` belongs
    to it alone); ``block_cu`` is inert on CPU tensors, as on the
    reference's interpret engine; an unknown ``cu_model`` still raises."""
    _, _, ta, tk = epoch_case("pc", 5, 7, NF=6, seed=2)
    with pytest.raises(ValueError, match="mech"):
        KEF.epoch_fused(*ta, **dict(tk, family="fork", react_i0=ta[7],
                                    react_sens=ta[7], **_LAYOUT))
    with pytest.raises(ValueError, match="mech"):
        KEF.epoch_fused(*ta, **dict(tk, mech=torch.tensor(5)))
    plain = epoch_fields(KEF.epoch_fused(*ta, **tk))
    tiled = epoch_fields(KEF.epoch_fused(*ta, **dict(tk, block_cu=2)))
    for k in plain:
        np.testing.assert_array_equal(tiled[k], plain[k], err_msg=k)
    with pytest.raises(ValueError, match="cu_model"):
        KEF.epoch_fused(*ta, **dict(tk, family="reactive", cu_model="nope",
                                    react_i0=ta[7], react_sens=ta[7]))


# ---------------------------------------------------------------------------
# the fork family (K4's plain version): every traced id, one row and rows
# ---------------------------------------------------------------------------

_LAYOUT = dict(react_models=TSIM._REACT_MODELS, pc_ids=TSIM._PC_IDS,
               id_ctr_pc=TSIM._ID_CTR_PC)
FORK_SPECS = [s for s in TMECH.fork_specs() if s.is_traced]


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
@pytest.mark.parametrize("mech", [s.traced_id for s in FORK_SPECS],
                         ids=[s.name for s in FORK_SPECS])
def test_epoch_fused_fork_matches_reference(mech, lean):
    """Tier 2: the port's fork family against the reference's
    ``epoch_fused(family="fork")`` on its interpret engine, for every
    traced id in both math modes."""
    ja, jk, ta, tk = fork_case(5, 7, 6, seed=mech + 3)
    want = epoch_fields(JKEF.epoch_fused(*ja, **jk, mech=jnp.int32(mech),
                                         lean=lean))
    got = epoch_fields(KEF.epoch_fused(*ta, **tk, mech=torch.tensor(mech),
                                       lean=lean))
    assert_epoch_close(got, want, rtol=RTOL, atol=ATOL,
                       what=f"id {mech}/lean={lean}")
    assert KEF.epoch_fused.launches_by_family["fork"] == 0


@pytest.mark.parametrize("spec", FORK_SPECS, ids=lambda s: s.name)
def test_epoch_fused_fork_matches_specialised(spec):
    """The port's fork family against its own pc/reactive family on the
    same carry (the reference's tests/test_kernels.py:292 in the port):
    the id picks which state group advances, never the math. ``fidx``
    equal, floats to 1e-5, the other group passed through bit for bit."""
    _, _, ta, tk = fork_case(8, 10, 10, seed=31)
    fork = KEF.epoch_fused(*ta, **tk, mech=torch.tensor(spec.traced_id))
    skw = {k: v for k, v in tk.items() if k not in _LAYOUT}
    skw.update(family=spec.family, fork_estimator=spec.fork_estimator,
               cu_model=spec.cu_model)
    drop = ("table", "tid", "wf_i0", "wf_sens") \
        if spec.family == "reactive" else ("react_i0", "react_sens")
    for k in drop:
        del skw[k]
    single = epoch_fields(KEF.epoch_fused(*ta, **skw))
    got = epoch_fields(fork)
    np.testing.assert_array_equal(got["fidx"], single["fidx"])
    for k, v in single.items():
        if k != "hit_rate" or spec.family == "pc":
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{spec.name}/{k}")
    carried = {"react_i0": tk["react_i0"], "react_sens": tk["react_sens"]} \
        if spec.family == "pc" else {
            "wf_i0": tk["wf_i0"], "wf_sens": tk["wf_sens"],
            **{f"table.{f}": getattr(tk["table"], f)
               for f in ("i0", "sens", "count")}}
    for k, v in carried.items():
        np.testing.assert_array_equal(got[k], np_(v), err_msg=k)
    assert got["hit_rate"].shape == (1,)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "exact"])
def test_epoch_fused_rows_bitwise_equal_single_rows(lean):
    """The batched plain version is, row for row, bitwise the one-row
    call: 9 rows mixing every traced id, three programs of different
    logical lengths padded to one block count, per-row sweep scalars,
    objectives and power regimes."""
    ids = [s.traced_id for s in FORK_SPECS] + [5, 1]
    args, kw = fork_rows_case(ids, 6, 9, NF=7, objectives=("ed2p", "edp",
                                                           "perfcap10"),
                              seed=3)
    rows = KEF.epoch_fused_rows(*args, **kw, lean=lean)
    batch = row_fields(rows)
    assert batch["t_acc"].shape == batch["hit_rate"].shape == (len(ids),)
    for r in range(len(ids)):
        a, k = one_row(args, kw, r)
        alone = row_fields(KEF.epoch_fused_rows(*a, **k, lean=lean), 0)
        for name, v in alone.items():
            assert torch.equal(batch[name][r], v), (r, name)
        # and the one-row entry point of the fork family agrees too
        p = int(args[3][r])
        sc = kw["scal"][r]
        single = KEF.epoch_fused(
            args[0][p], args[1][p], args[2][p], args[4][r], args[5][r],
            args[6][r], args[7][r], args[8][r], args[9][r], lean=lean,
            p_blocks=int(kw["p_blocks"][r]), epoch_us=sc[0], sigma=sc[1],
            cap_per_ghz=sc[2], membw=sc[3], table_ema=sc[4], obj=sc[5:8],
            lat_us=sc[8], power=TPWR.PowerAxes(*kw["power"][r].unbind(0)),
            family="fork", mech=kw["mech"][r],
            table=PRED.PCTable(*(t[r] for t in kw["table"])), tid=kw["tid"],
            wf_i0=kw["wf_i0"][r], wf_sens=kw["wf_sens"][r],
            react_i0=kw["react_i0"][r], react_sens=kw["react_sens"][r],
            offset_blocks=kw["offset_blocks"], **_LAYOUT)
        for name, v in row_fields(single).items():
            assert torch.equal(batch[name][r], v.reshape(batch[name][r]
                                                         .shape)), (r, name)
    assert KEF.epoch_fused.launches_by_family["fork"] == 0


def test_epoch_fused_rows_block_cu_is_inert_on_cpu():
    args, kw = fork_rows_case([0, 5, 6], 8, 10, seed=8)
    plain = row_fields(KEF.epoch_fused_rows(*args, **kw))
    tiled = row_fields(KEF.epoch_fused_rows(*args, **kw, block_cu=4))
    for name, v in plain.items():
        assert torch.equal(tiled[name], v), name


def test_fork_layout_rejects_what_the_kernel_cannot_encode():
    with pytest.raises(ValueError, match="react model"):
        KEF._fork_layout(("stall", "nope"), (5,), 5)
    with pytest.raises(ValueError, match="range"):
        KEF._fork_layout(("stall",) * 8, (9,), 9)
    n_react, packed, mask, ctr = KEF._fork_layout(**_LAYOUT)
    assert n_react == TSIM._N_REACT and ctr == TSIM._ID_CTR_PC
    assert mask == sum(1 << i for i in TSIM._PC_IDS)
    assert [(packed >> 4 * i) & 15 for i in range(n_react - 1)] == \
        [EST.CU_MODELS.index(m) for m in TSIM._REACT_MODELS]
