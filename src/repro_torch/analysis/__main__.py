"""CLI: ``python -m repro_torch.analysis [--dispatch] [--baseline PATH] ...``.

Exit 0 when every finding is covered by the accepted baseline, 1 when
there are new findings (printed as ``file:line rule-id [severity]
message``), 2 on operator error. ``--write-baseline`` records the
current findings as accepted and exits 0.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.ast_rules import AST_RULES, analyze_repo
from repro_torch.analysis.findings import (DEFAULT_BASELINE, load_baseline,
                                           new_findings, write_baseline)


def _default_root() -> Path:
    # src/repro_torch/analysis/__main__.py -> repo root three levels up.
    root = Path(__file__).resolve().parents[3]
    if (root / "src" / "repro_torch").is_dir():
        return root
    cwd = Path.cwd()
    if (cwd / "src" / "repro_torch").is_dir():
        return cwd
    raise SystemExit("repro-lint: cannot locate the repo root (no "
                     "src/repro_torch next to this package or under the "
                     "current directory); pass --root")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint for the port: machine-check its contracts "
                    "(kernel / plain-version mirror, zero-tail restore, no "
                    "draws in round bodies, import hygiene; --dispatch "
                    "adds the checks on a real round's aten ops).")
    parser.add_argument("--root", default=None,
                        help="repo root (default: autodetected)")
    parser.add_argument("--dispatch", action="store_true",
                        help="also run the dispatch tier (imports torch and "
                             "runs a tiny round on the CPU: slower)")
    parser.add_argument("--baseline", default=None,
                        help="accepted-findings file (default: "
                             f"<root>/{DEFAULT_BASELINE})")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record current findings as accepted and "
                             "exit 0")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline; report every finding")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        # repro-lint: lazy-import (dispatch_checks imports the engine;
        # the AST tier reads source only)
        from repro_torch.analysis.dispatch_checks import DISPATCH_RULES
        for tier, rules in (("ast", AST_RULES), ("dispatch",
                                                 DISPATCH_RULES)):
            for rule, desc in rules.items():
                print(f"{rule:24} [{tier}]  {desc}")
        return 0

    root = Path(args.root).resolve() if args.root else _default_root()
    findings = analyze_repo(root)
    if args.dispatch:
        # repro-lint: lazy-import (the dispatch tier is opt-in; the AST
        # tier imports none of the engine)
        from repro_torch.analysis.dispatch_checks import run_dispatch_checks
        findings += run_dispatch_checks()
    findings.sort()

    baseline_path = (Path(args.baseline) if args.baseline
                     else root / DEFAULT_BASELINE)
    if args.write_baseline:
        write_baseline(str(baseline_path), findings)
        print(f"repro-lint: wrote {len(findings)} accepted finding(s) "
              f"to {baseline_path}")
        return 0

    try:
        baseline = ({} if args.no_baseline
                    else load_baseline(str(baseline_path)))
    except ValueError as exc:
        print(f"repro-lint: {exc}", file=sys.stderr)
        return 2
    fresh = new_findings(findings, baseline)
    for f in fresh:
        print(f.render())
    print(f"repro-lint: {len(fresh)} new finding(s), "
          f"{len(findings) - len(fresh)} baselined "
          f"({len(findings)} total)", file=sys.stderr)
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
