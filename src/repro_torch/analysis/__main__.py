"""CLI: ``python -m repro_torch.analysis [--check] [--json] [paths...]``

Runs the axis-liveness audit over every registered mechanism and the
per-epoch hazard linter over ``src/repro_torch`` (or explicit paths),
printing a text report by default or the schema-1 JSON document with
``--json``. With ``--check`` the exit status is 1 unless the report is
clean: no under-declared, unwaived mechanism and no un-waived lint
finding. The audit runs on the CPU (a static analysis at a tiny shape).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import report as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="axis-liveness audit + per-epoch hazard lint")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any unsound spec or un-waived finding")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable JSON report")
    ap.add_argument("--no-liveness", action="store_true",
                    help="skip the liveness audit")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint pass")
    args = ap.parse_args(argv)

    rep = R.build_report(lint_paths=args.paths or None,
                         skip_liveness=args.no_liveness,
                         skip_lint=args.no_lint)
    print(R.to_json(rep) if args.json else R.render_text(rep))
    return 0 if (rep["ok"] or not args.check) else 1


if __name__ == "__main__":
    sys.exit(main())
