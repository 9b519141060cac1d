"""daslint CLI — `python -m das_tpu_torch.analysis [paths...]`.

Exit codes: 0 clean (baseline-grandfathered findings allowed), 1 any
new finding OR stale baseline entry, 2 usage error (unknown rule ids
included — a typo'd --select must not silently run nothing).
`--format json|sarif` emit machine-readable records (SARIF 2.1.0 for
CI annotation; `--json` is kept as an alias of `--format json`);
default paths analyze the das_tpu_torch package beside this one, with
the baseline `das_tpu_torch/analysis/baseline.json` and the repository's
tests/ directory.  `--select`/`--ignore` run rule subsets
incrementally; `--allow-partial` marks a deliberately incomplete file
set so registry-staleness legs don't fire on modules that simply aren't
in the set.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from das_tpu_torch.analysis.core import (
    apply_baseline,
    iter_rules,
    load_baseline,
    run_analysis,
)

_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemas/sarif-schema-2.1.0.json"
)


def _sarif_record(findings, stale, baseline_path, rule_titles) -> dict:
    """Minimal SARIF 2.1.0 run: one result per NEW finding plus one per
    STALE baseline entry (both fail the run, so both must be visible to
    the CI annotation consumer), rule metadata from the registry."""
    results = [
        {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line},
                },
            }],
        }
        for f in findings
    ]
    for b in stale:
        results.append({
            "ruleId": b.rule,
            "level": "error",
            "message": {"text": (
                f"stale baseline entry for {b.path}: {b.message!r} no "
                "longer matches any finding — delete it"
            )},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": str(baseline_path)},
                    "region": {"startLine": 1},
                },
            }],
        })
    used = sorted({r["ruleId"] for r in results})
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "daslint",
                "informationUri": "das_tpu_torch/analysis/__init__.py",
                "rules": [
                    {
                        "id": rid,
                        "shortDescription": {
                            "text": rule_titles.get(rid, rid)
                        },
                    }
                    for rid in used
                ],
            }},
            "results": results,
        }],
    }


def _package_root() -> Path:
    """The das_tpu_torch package directory, found from this file: the
    analyzer imports nothing of what it checks."""
    return Path(__file__).resolve().parent.parent


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m das_tpu_torch.analysis",
        description="daslint — AST invariant analyzer of das_tpu_torch",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the das_tpu_torch package)",
    )
    parser.add_argument(
        "--select", "--rules", dest="select",
        help="comma-separated rule subset to run (e.g. DL001,DL010); "
             "unknown ids exit 2",
    )
    parser.add_argument(
        "--ignore",
        help="comma-separated rules to skip (applied after --select); "
             "unknown ids exit 2",
    )
    parser.add_argument(
        "--baseline", type=Path,
        help="baseline JSON (default: das_tpu_torch/analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report grandfathered findings as errors too",
    )
    parser.add_argument(
        "--tests-dir", type=Path,
        help="tests directory for DL004's test-reference leg "
             "(default: <repo>/tests; pass a missing path to skip)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="output format (sarif: one run, new findings as results)",
    )
    parser.add_argument(
        "--json", action="store_const", const="json", dest="format",
        help="alias of --format json",
    )
    parser.add_argument(
        "--allow-partial", action="store_true",
        help="the path set is deliberately incomplete (--allow-partial): "
             "skip registry-staleness legs that need the full tree",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    args = parser.parse_args(argv)

    all_rules = dict(iter_rules())
    if args.list_rules:
        for rid, title in all_rules.items():
            print(f"{rid}  {title}")
        return 0

    package = _package_root()
    root = package.parent
    paths = [Path(p) for p in args.paths] or [package]
    for p in paths:
        if not p.exists():
            print(f"daslint: no such path: {p}", file=sys.stderr)
            return 2

    def parse_ids(raw):
        ids = [r.strip() for r in raw.split(",") if r.strip()]
        unknown = [r for r in ids if r not in all_rules]
        if unknown:
            raise ValueError(f"unknown daslint rule(s): {sorted(unknown)}")
        return ids

    try:
        selected = parse_ids(args.select) if args.select else None
        ignored = set(parse_ids(args.ignore)) if args.ignore else set()
    except ValueError as exc:
        print(f"daslint: {exc}", file=sys.stderr)
        return 2
    rules = None
    if selected is not None or ignored:
        rules = [
            r for r in (selected if selected is not None else all_rules)
            if r not in ignored
        ]
    tests_dir = args.tests_dir if args.tests_dir is not None else root / "tests"

    try:
        findings = run_analysis(
            paths, rules=rules, tests_dir=tests_dir,
            partial=args.allow_partial,
        )
    except ValueError as exc:
        print(f"daslint: {exc}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or (package / "analysis" / "baseline.json")
    if args.baseline is not None and not baseline_path.is_file():
        # the default path is allowed to be absent (no baseline yet);
        # an explicit one that is missing would silently skip the
        # stale-entry check, so it is a usage error
        print(f"daslint: no such baseline: {baseline_path}", file=sys.stderr)
        return 2
    baseline = []
    if not args.no_baseline and baseline_path.is_file():
        try:
            baseline = load_baseline(baseline_path)
        except ValueError as exc:
            print(f"daslint: bad baseline: {exc}", file=sys.stderr)
            return 2
    if rules is not None:
        # a subset run must not report other rules' grandfathered
        # entries as stale — those findings were never searched for
        baseline = [b for b in baseline if b.rule in rules]
    new, kept, stale = apply_baseline(findings, baseline)
    if args.allow_partial:
        # the path subset is deliberately incomplete: an entry whose
        # file isn't in the set matches nothing, which proves exactly
        # as little as the rules-subset case above — staleness is the
        # full run's verdict
        stale = []

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "grandfathered": [f.to_json() for f in kept],
            "stale_baseline": [
                {"rule": b.rule, "path": b.path, "message": b.message}
                for b in stale
            ],
        }, indent=2))
    elif args.format == "sarif":
        print(json.dumps(
            _sarif_record(new, stale, baseline_path, all_rules), indent=2
        ))
    else:
        for f in new:
            print(f.render())
        for b in stale:
            print(
                f"stale baseline entry: {b.rule} {b.path}: {b.message!r} "
                "no longer matches any finding — delete it"
            )
        summary = (
            f"daslint: {len(new)} finding(s), {len(kept)} grandfathered, "
            f"{len(stale)} stale baseline entr(y/ies)"
        )
        print(summary)
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
