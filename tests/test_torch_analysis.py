"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* The axis-liveness auditor: for every builtin mechanism under both
  engines (the unfused body and the fused epoch's plain version) the
  port's derived axes and per-channel sets equal the reference's jaxpr
  walk, and match the declared ``exec_axes`` exactly. Mutant specs: an
  under-declaration is refused by the default ``register`` and by
  ``run_grid(dedup=True)``, naming the axis; an over-declaration warns
  naming the dead axis; a waiver downgrades the error. A perturbation of
  every axis a spec does not read leaves its run unchanged (a cross-check
  of the dependency walk, not the auditor).
* The per-epoch hazard linter: each rule has a positive and a negative
  case, per-epoch context propagates, waivers work, and the port's tree
  has no unwaived finding.
* The schema-1 report, the CLI's ``--check`` and ``mechanism_table``.
"""
import dataclasses
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import deps as JDEPS  # noqa: E402
from repro.core import mechanisms as JMECH  # noqa: E402
from repro.core import simulate as JSIM  # noqa: E402
from repro_torch.analysis import deps, lint, report  # noqa: E402
from repro_torch.analysis import __main__ as CLI  # noqa: E402
from repro_torch.analysis.deps import (AxisLivenessError,  # noqa: E402
                                       DeadAxisWarning, axis_liveness,
                                       verify_spec_axes)
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.mechanisms import MechanismSpec  # noqa: E402
from repro_torch.core.workloads import get_workload  # noqa: E402

CTRL = ("epoch_us", "sigma", "cap_per_ghz", "membw", "obj", "n_ep", "power")
ENGINES = {"unfused": (deps.TINY_CONFIG, JDEPS.TINY_CONFIG),
           "v2": (deps.TINY_CONFIG_V2, JDEPS.TINY_CONFIG_V2)}


def _sneaky_predict(carry, ctx, st, ax):
    # reads table_ema without declaring it: the dedup-unsound direction
    i0 = carry.react_i0 * (1.0 + 0.1 * ax.table_ema)
    return SIM.predict_instr(i0, carry.react_sens, st, ax)


def _honest_predict(carry, ctx, st, ax):
    return SIM.predict_instr(carry.react_i0, carry.react_sens, st, ax)


def _host_read_predict(carry, ctx, st, ax):
    # a host read of an axis: the auditor refuses rather than lose it
    i0 = carry.react_i0 * float(ax.sigma)
    return SIM.predict_instr(i0, carry.react_sens, st, ax)


def _value_branch_predict(how):
    # branches on a Python bool computed from an axis: it leaves the graph
    def predict(carry, ctx, st, ax):
        ref = torch.full_like(ax.table_ema, 0.5)
        hit = (torch.equal(ax.table_ema, ref) if how == "equal"
               else torch.allclose(ax.table_ema, ref))
        i0 = carry.react_i0 * (1.1 if hit else 1.0)
        return SIM.predict_instr(i0, carry.react_sens, st, ax)
    return predict


def _j_sneaky_predict(carry, ctx, st, ax):
    i0 = carry.react_i0 * (1.0 + 0.1 * ax.table_ema)
    return JSIM.predict_instr(i0, carry.react_sens, st, ax)


@pytest.fixture(scope="module")
def progs_one():
    return {"comd": get_workload("comd", P=128, device="cpu")}


# ---------------------------------------------------------------------------
# Axis-liveness auditor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", MECH.BUILTIN_NAMES)
def test_builtin_liveness_matches_reference(name, engine):
    """Every builtin's derived axes and per-channel sets are the
    reference's, and equal its declared exec_axes exactly."""
    t_cfg, j_cfg = ENGINES[engine]
    got = axis_liveness(name, t_cfg)
    want = JDEPS.axis_liveness(name, j_cfg)
    assert got.waiver is None
    assert got.declared == want.declared
    assert got.derived == want.derived
    assert got.per_output == want.per_output
    assert got.exact, (f"{name}: declared={got.declared} "
                       f"derived={got.derived}")
    assert got.per_output
    for ch, axes in got.per_output:
        assert set(axes) <= set(got.derived), (ch, axes)


def test_under_declared_mutant_rejected_at_registration():
    """The default registration audits a custom spec, refuses the one
    whose hook reads an undeclared axis (naming it) and leaves it out of
    the registry; the reference convicts the same axis."""
    spec = MechanismSpec("mut_under", "reactive", CTRL,
                         predict=_sneaky_predict)
    with pytest.raises(AxisLivenessError, match="table_ema"):
        MECH.register(spec)
    assert "mut_under" not in MECH.names()
    res = axis_liveness(spec)
    assert res.under_declared == ("table_ema",)
    assert not res.sound
    assert any("table_ema" in axes for _, axes in res.per_output)
    res2 = axis_liveness(spec, deps.TINY_CONFIG_V2)
    assert res2.under_declared == ("table_ema",)
    jres = JDEPS.axis_liveness(JMECH.MechanismSpec(
        "mut_under", "reactive", CTRL, predict=_j_sneaky_predict))
    assert res.derived == jres.derived
    assert res.per_output == jres.per_output


def test_under_declared_mutant_refused_by_run_grid(progs_one):
    """A spec that skipped the registration audit is refused by
    run_grid(dedup=True) before any dispatch, and runs with dedup=False,
    where no broadcast can lie."""
    spec = MechanismSpec("mut_under2", "reactive", CTRL,
                         predict=_sneaky_predict)
    MECH.register(spec, verify_axes=False)
    try:
        cfg = SIM.SimConfig(n_cu=4, n_wf=4, n_epochs=8)
        grid = {"table_ema": [0.3, 0.5]}
        SW.reset_counters()
        with pytest.raises(AxisLivenessError, match="table_ema"):
            SW.run_grid(progs_one, cfg, grid, ("mut_under2",))
        assert dict(SW.DISPATCH_ROWS) == {}
        res = SW.run_grid(progs_one, cfg, grid, ("mut_under2",),
                          dedup=False)
        a, b = (res[(e,)]["comd"]["mut_under2"]["err"] for e in (0.3, 0.5))
        assert not np.array_equal(a, b)  # table_ema really is live
    finally:
        MECH.unregister("mut_under2")


def test_over_declared_mutant_warns_naming_dead_axis():
    spec = MechanismSpec("mut_over", "reactive", CTRL + ("table_ema",),
                         predict=_honest_predict)
    with pytest.warns(DeadAxisWarning, match="table_ema"):
        MECH.register(spec)
    try:
        assert "mut_over" in MECH.names()
        res = axis_liveness(spec)
        assert res.over_declared == ("table_ema",)
        assert res.sound
    finally:
        MECH.unregister("mut_over")


def test_waiver_downgrades_under_declaration():
    spec = MechanismSpec("mut_waived", "reactive", CTRL,
                         predict=_sneaky_predict,
                         liveness_waiver="test: deliberate mutant")
    with pytest.warns(DeadAxisWarning, match="deliberate mutant"):
        res = verify_spec_axes(spec)
    assert res.under_declared == ("table_ema",)
    assert res.sound
    deps.require_dedup_sound(spec)  # waived => dispatchable


def test_host_read_of_an_axis_is_refused():
    spec = MechanismSpec("mut_host", "reactive", CTRL,
                         predict=_host_read_predict)
    with pytest.raises(AxisLivenessError, match="sigma"):
        axis_liveness(spec)


@pytest.mark.parametrize("how", ["equal", "allclose"])
def test_python_value_from_an_axis_is_refused(how):
    """An operation that turns a tagged tensor into a Python value hides
    the axis from the walk, so the audit refuses it, naming the axis."""
    spec = MechanismSpec(f"mut_{how}", "reactive", CTRL,
                         predict=_value_branch_predict(how))
    with pytest.raises(AxisLivenessError, match="table_ema"):
        axis_liveness(spec)
    with pytest.raises(AxisLivenessError, match="table_ema"):
        MECH.register(spec)
    assert f"mut_{how}" not in MECH.names()


def test_dispatch_guard_audits_the_grid_engine(monkeypatch):
    """run_grid's guard audits the engine its SimConfig selects, once."""
    point = deps.engine_audit_point
    assert point(None) is deps.TINY_CONFIG
    for up in (False, "v1"):
        assert point(SIM.SimConfig(use_pallas=up)) is deps.TINY_CONFIG
    for up in (True, "v2"):
        assert point(SIM.SimConfig(use_pallas=up)) is deps.TINY_CONFIG_V2
    assert point(SIM.SimConfig(record_wf=True)) is deps.TINY_CONFIG
    seen = []
    real = deps.axis_liveness

    def spy(mech, static_cfg=None):
        seen.append((MECH.resolve(mech).name, static_cfg))
        return real(mech, static_cfg)
    monkeypatch.setattr(deps, "axis_liveness", spy)
    for up, want in ((False, deps.TINY_CONFIG), (True, deps.TINY_CONFIG_V2)):
        seen.clear()
        deps.require_dedup_sound("pcstall", SIM.SimConfig(use_pallas=up))
        assert seen == [("pcstall", want)]


def test_first_audit_imports_no_compiler():
    """The auditor's dispatch mode is not wrapped for the compiler, so a
    process's first audit (inside its first run_grid) does not import
    torch._dynamo."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = ("import sys\n"
            "from repro_torch.analysis import deps\n"
            "assert deps.axis_liveness('static13').exact\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.strip() == "False", out.stdout + out.stderr


def test_audit_registry_covers_all_builtins():
    results = deps.audit_registry()
    assert {r.name for r in results} >= set(MECH.BUILTIN_NAMES)
    assert all(r.sound and r.exact for r in results)


def test_mechanism_table_has_verified_column():
    table = MECH.mechanism_table()
    assert "| verified |" in table
    rows = [r for r in table.splitlines() if r.startswith("| `")]
    assert len(rows) >= len(MECH.BUILTIN_NAMES)
    for name in MECH.BUILTIN_NAMES:
        row = next(r for r in rows if f"`{name}`" in r)
        assert "✓" in row, row
    assert "| verified |" not in MECH.mechanism_table(verify=False)
    assert MECH.mechanism_table(verify=False) == \
        JMECH.mechanism_table(verify=False)


@pytest.mark.parametrize("name", ["static17", "crisp", "oracle"])
def test_dead_axes_do_not_move_a_run(progs_one, name):
    """Perturbation cross-check: every axis the auditor finds dead leaves
    a whole run bit for bit unchanged."""
    res = axis_liveness(name)
    dead = [a for a in MECH.SIM_AXES_FIELDS if a not in res.derived]
    assert dead
    moves = {"obj": {"objective": "deadline05"},
             "table_ema": {"table_ema": 0.9}}
    cfg = SIM.SimConfig(n_cu=4, n_wf=4, n_epochs=12, use_pallas=False)
    base = SIM.run_sim(progs_one["comd"], cfg, name)
    for a in dead:
        moved = SIM.run_sim(progs_one["comd"],
                            dataclasses.replace(cfg, **moves[a]), name)
        for k in base:
            np.testing.assert_array_equal(moved[k], base[k],
                                          err_msg=f"{name} {a} {k}")


def test_audit_never_touches_the_sweep():
    SW.reset_counters()
    deps.audit_registry()
    assert dict(SW.TRACE_COUNTS) == {}
    assert dict(SW.DISPATCH_ROWS) == {}


# ---------------------------------------------------------------------------
# Per-epoch hazard linter
# ---------------------------------------------------------------------------


def _rules(src, roots=("f",)):
    return sorted({f.rule for f in
                   lint.lint_source(textwrap.dedent(src), roots=roots)
                   if not f.waived})


def test_repro001_host_sync_in_epoch_code():
    src = """
    import numpy as np
    def f(x):
        return float(x) + np.asarray(x).sum() + x.item() + x.cpu()
    """
    assert _rules(src) == ["REPRO001"]
    assert _rules(src, roots=()) == []         # not per-epoch: quiet
    assert _rules("""
    def f(x):
        return int(x.shape[0]) + x.numel() + len(x)
    """) == []


def test_repro002_python_branch_on_tensor():
    src = """
    import torch
    def f(x):
        if torch.any(x > 0):
            return x
        while x.all():
            x = x - 1
        return x
    """
    assert _rules(src) == ["REPRO002"]
    assert _rules("""
    import torch
    def f(x, flag):
        if flag:
            return torch.where(x > 0, x, -x)
        return x
    """) == []


def test_repro003_numpy_in_epoch_code():
    src = """
    import numpy as np
    def f(x):
        return np.tanh(x)
    """
    assert _rules(src) == ["REPRO003"]
    assert _rules("""
    import numpy as np
    def f(x):
        return x * np.float32(2.0) + np.pi
    """) == []


def test_repro006_unlocked_module_state():
    src = """
    COUNTS = {}
    def bump(k):
        COUNTS[k] = COUNTS.get(k, 0) + 1
    """
    assert _rules(src, roots=()) == ["REPRO006"]
    assert _rules("""
    import threading
    COUNTS = {}
    _LOCK = threading.Lock()
    def bump(k):
        with _LOCK:
            COUNTS[k] = COUNTS.get(k, 0) + 1
    """, roots=()) == []


def test_epoch_context_propagates_through_local_calls():
    src = """
    import numpy as np
    def helper(x):
        return np.tanh(x)
    def f(x):
        return helper(x)
    """
    assert _rules(src) == ["REPRO003"]
    assert _rules(src, roots=()) == []


def test_vmapped_lambda_is_epoch_code():
    src = """
    import numpy as np
    import torch
    def run(xs):
        return torch.func.vmap(lambda x: np.log(x))(xs)
    """
    assert _rules(src, roots=()) == ["REPRO003"]


def test_roots_come_from_the_table():
    """A package file's per-epoch roots are its EPOCH_ROOTS entry, by
    qualified name: the simulate body is per-epoch code."""
    src = """
    def _make_body(st):
        def body(carry):
            return carry.item()
        return body
    def other(x):
        return x.item()
    """
    found = lint.lint_source(textwrap.dedent(src),
                             "src/repro_torch/core/simulate.py")
    assert [(f.rule, f.context) for f in found] == \
        [("REPRO001", "_make_body.body")]


def test_waivers_line_and_file():
    line = """
    def f(x):
        return float(x)  # repro: waive[REPRO001] test waiver
    """
    findings = lint.lint_source(textwrap.dedent(line), roots=("f",))
    assert [f.rule for f in findings] == ["REPRO001"]
    assert findings[0].waived
    filewide = """
    # repro: waive-file[REPRO006] single-threaded module
    STATE = {}
    def bump(k):
        STATE[k] = 1
    """
    findings = lint.lint_source(textwrap.dedent(filewide))
    assert findings and all(f.waived for f in findings)
    assert lint.violations(findings) == []


def test_lint_rules_table_is_complete():
    from repro.analysis import lint as JLINT
    assert sorted(lint.RULES) == sorted(JLINT.RULES)
    for r in ("REPRO004", "REPRO005"):
        assert "not applicable to torch" in lint.RULES[r]


def test_source_tree_has_no_unwaived_findings():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    findings = lint.lint_paths([root / "src" / "repro_torch"])
    assert lint.violations(findings) == [], \
        [f.format() for f in lint.violations(findings)]
    # the roots of the table all exist in their files
    for rel, names in lint.EPOCH_ROOTS.items():
        src = (root / "src" / "repro_torch" / rel).read_text()
        for n in names:
            assert f"def {n.split('.')[-1]}(" in src, (rel, n)


# ---------------------------------------------------------------------------
# Report and CLI
# ---------------------------------------------------------------------------


def test_report_schema_and_ok():
    rep = report.build_report()
    assert rep["schema"] == 1
    names = {r["name"] for r in rep["liveness"]["results"]}
    assert names >= set(MECH.BUILTIN_NAMES)
    assert rep["liveness"]["unsound"] == []
    assert rep["lint"]["violations"] == 0, rep["lint"]["findings"]
    assert rep["ok"]
    row = rep["liveness"]["results"][0]
    assert set(row) == {"name", "declared", "derived", "status", "under",
                        "over", "waiver", "per_output"}
    assert set(rep["lint"]) == {"findings", "counts", "violations"}
    assert set(rep["lint"]["findings"][0]) == {
        "rule", "path", "line", "col", "msg", "context", "waived"}
    assert "liveness" in report.to_json(rep)
    assert "OK" in report.render_text(rep)


def test_cli_check_exits_zero(capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeadAxisWarning)
        assert CLI.main(["--check"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")
