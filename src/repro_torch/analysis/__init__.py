"""``repro_torch.analysis``: static analysis over the sweep substrate
(port of ``repro.analysis``).

* :mod:`repro_torch.analysis.deps`, the **axis-liveness auditor**. Every
  registered :class:`~repro_torch.core.mechanisms.MechanismSpec` declares
  ``exec_axes``, the ``SimAxes`` fields its epoch depends on, and the
  sweep's grid dedup broadcasts one row across every grid point agreeing
  on them; an under-declared axis would broadcast wrong results. The
  auditor follows one epoch of the spec operation by operation at a tiny
  static shape on the CPU, with every ``SimAxes``/``PowerAxes`` leaf
  tagged, iterates the carry to a fixpoint and compares the derived axes
  with the declaration: under-declaration is an error
  (:class:`~repro_torch.analysis.deps.AxisLivenessError`),
  over-declaration a warning naming the dead axis.
* :mod:`repro_torch.analysis.lint`, the **per-epoch hazard linter**: an
  AST pass for host syncs, Python control flow on tensors and numpy in
  per-epoch code, and unguarded module-level mutable state (rules
  ``REPRO001``-``REPRO006``, with the reference's ids; see ``lint.RULES``).

Wired in three places: ``mechanisms.register`` audits custom specs,
``sweep.run_grid(dedup=True)`` refuses under-declared specs before any
dispatch, and ``python -m repro_torch.analysis --check`` emits the
schema-1 report.
"""
from repro_torch.analysis.deps import (AuditResult, AxisLivenessError,
                                       DeadAxisWarning, audit_registry,
                                       axis_liveness, require_dedup_sound,
                                       verify_spec_axes)
from repro_torch.analysis.lint import (Finding, RULES, lint_paths,
                                       lint_source)

__all__ = [
    "AuditResult", "AxisLivenessError", "DeadAxisWarning",
    "audit_registry", "axis_liveness", "require_dedup_sound",
    "verify_spec_axes", "Finding", "RULES", "lint_paths", "lint_source",
]
