"""Machine-readable analysis report (port of ``repro.analysis.report``):
one JSON document combining the axis-liveness audit of every registered
mechanism with the per-epoch hazard lint of the package's tree. Read by
``python -m repro_torch.analysis --check`` and rendered as text for
humans.

Report schema (the reference's schema 1)::

    {
      "schema": 1,
      "liveness": {
        "results": [
          {"name": "...", "declared": [...], "derived": [...],
           "status": "exact" | "over" | "under" | "waived",
           "under": [...], "over": [...], "waiver": null | "...",
           "per_output": {"channel": [...axes...], ...}},
          ...
        ],
        "unsound": ["<names of under-declared, unwaived specs>"]
      },
      "lint": {
        "findings": [
          {"rule": "REPRO00x", "path": "...", "line": N, "col": N,
           "msg": "...", "context": "...", "waived": bool}, ...
        ],
        "counts": {"REPRO00x": N, ...},
        "violations": N          # un-waived findings
      },
      "ok": bool                 # no unsound specs AND no violations
    }
"""
from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import deps, lint

# Paths linted by default, relative to the repo root (the directory
# holding ``src/``).
DEFAULT_LINT_PATHS = ("src/repro_torch",)


def _audit_row(res: deps.AuditResult) -> Dict:
    if res.under_declared:
        status = "waived" if res.waiver is not None else "under"
    elif res.over_declared:
        status = "over"
    else:
        status = "exact"
    return {
        "name": res.name,
        "declared": list(res.declared),
        "derived": list(res.derived),
        "status": status,
        "under": list(res.under_declared),
        "over": list(res.over_declared),
        "waiver": res.waiver,
        "per_output": {ch: list(axes) for ch, axes in res.per_output},
    }


def _find_repo_root(start: Optional[Path] = None) -> Path:
    """Walk up from this file to the directory containing ``src/``."""
    cur = (start or Path(__file__)).resolve()
    for parent in [cur] + list(cur.parents):
        if (parent / "src" / "repro_torch").is_dir():
            return parent
    return Path.cwd()


def build_report(lint_paths: Optional[Sequence[str]] = None,
                 skip_liveness: bool = False,
                 skip_lint: bool = False) -> Dict:
    """Run the audit and the lint and assemble the report dict."""
    report: Dict = {"schema": 1}

    if not skip_liveness:
        with warnings.catch_warnings():
            # over-declarations are *reported*, not printed, here
            warnings.simplefilter("ignore", deps.DeadAxisWarning)
            results = deps.audit_registry()
        rows = [_audit_row(r) for r in results]
        report["liveness"] = {
            "results": rows,
            "unsound": [r["name"] for r in rows if r["status"] == "under"],
        }

    if not skip_lint:
        root = _find_repo_root()
        paths = [root / p for p in (lint_paths or DEFAULT_LINT_PATHS)]
        findings = lint.lint_paths([p for p in paths if p.exists()])
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        report["lint"] = {
            "findings": [vars(f).copy() for f in findings],
            "counts": dict(sorted(counts.items())),
            "violations": len(lint.violations(findings)),
        }

    unsound = report.get("liveness", {}).get("unsound", [])
    nviol = report.get("lint", {}).get("violations", 0)
    report["ok"] = not unsound and nviol == 0
    return report


def render_text(report: Dict) -> str:
    """Human rendering of :func:`build_report`'s output."""
    lines: List[str] = []
    live = report.get("liveness")
    if live is not None:
        lines.append("axis-liveness audit "
                     f"({len(live['results'])} mechanisms):")
        width = max((len(r["name"]) for r in live["results"]), default=4)
        for r in live["results"]:
            mark = {"exact": "✓ exact", "over": "! over ",
                    "under": "✗ UNDER", "waived": "~ waive"}[r["status"]]
            detail = ""
            if r["under"]:
                detail = f"  undeclared={r['under']}"
            elif r["over"]:
                detail = f"  dead={r['over']}"
            lines.append(f"  {mark}  {r['name']:<{width}}  "
                         f"declared={r['declared']}{detail}")
        if live["unsound"]:
            lines.append(f"  UNSOUND (dedup would broadcast wrong "
                         f"results): {live['unsound']}")
    lnt = report.get("lint")
    if lnt is not None:
        lines.append(f"per-epoch hazard lint: {len(lnt['findings'])} "
                     f"findings ({lnt['violations']} un-waived)")
        for f in lnt["findings"]:
            w = " (waived)" if f["waived"] else ""
            lines.append(f"  {f['path']}:{f['line']}: {f['rule']}{w} "
                         f"{f['msg']}")
    lines.append("OK" if report["ok"] else "FAIL")
    return "\n".join(lines)


def to_json(report: Dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)
