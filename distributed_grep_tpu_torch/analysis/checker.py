"""The checker: run the invariant rules over a project root, filter
pragmas and the baseline allowlist, render text/JSON, exit 0/1.

Exposed as ``python -m distributed_grep_tpu_torch analyze`` and as
``run_analysis()`` for the tier-1 lint test (tests/test_torch_analysis.py)
and chip_smoke.py's first phase (the C interface held where the kernels
are built).

Suppression, narrowest first:

* an inline pragma on the flagged line — ``# analyze-ok: <rule>`` (or a
  bare ``# analyze-ok`` for any rule) — for single deliberate divergences;
* a baseline file (``--baseline``) of lines ``<rule>\\t<path>\\t<stripped
  source line>`` — content-keyed, so entries survive line drift.  The
  package's own baseline is EMPTY by policy: pre-existing violations
  get fixed, not inventoried.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from distributed_grep_tpu_torch.analysis.rules import (
    RULE_DOCS,
    RULES,
    Project,
    Violation,
)

PACKAGE_ROOT = Path(__file__).resolve().parents[1]

_PRAGMA = "# analyze-ok"


def _source_line(root: Path, v: Violation,
                 cache: dict[str, list[str]] | None = None) -> str:
    """Flagged source line text (pragma/baseline key).  ``cache`` holds
    splitlines per path for the run — one read per file, not per
    violation."""
    lines = cache.get(v.path) if cache is not None else None
    if lines is None:
        try:
            lines = (root / v.path).read_text(
                encoding="utf-8", errors="surrogateescape").splitlines()
        except OSError:
            lines = []
        if cache is not None:
            cache[v.path] = lines
    return lines[v.line - 1].strip() if 0 < v.line <= len(lines) else ""


def _pragma_suppressed(src_line: str, rule: str) -> bool:
    if _PRAGMA not in src_line:
        return False
    tail = src_line.split(_PRAGMA, 1)[1]
    if tail.startswith(":"):
        allowed = {r.strip() for r in tail[1:].split("#", 1)[0].split(",")}
        return rule in allowed
    return True  # bare pragma: any rule


def load_baseline(path: Path) -> set[tuple[str, str, str]]:
    entries: set[tuple[str, str, str]] = set()
    for raw in path.read_text(encoding="utf-8").splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        parts = raw.split("\t", 2)
        if len(parts) == 3:
            entries.add((parts[0], parts[1], parts[2].strip()))
    return entries


def run_analysis(
    root: Path | str | None = None,
    rules: list[str] | None = None,
    baseline: Path | str | None = None,
) -> list[Violation]:
    """All surviving violations, sorted (path, line, rule)."""
    root = Path(root) if root is not None else PACKAGE_ROOT
    selected = list(RULES) if rules is None else rules
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule(s) {unknown}; have {sorted(RULES)}")
    project = Project(root)
    base = load_baseline(Path(baseline)) if baseline is not None else set()
    lines_cache: dict[str, list[str]] = {}
    out: list[Violation] = []
    for name in selected:
        for v in RULES[name](project):
            src = _source_line(root, v, lines_cache)
            if _pragma_suppressed(src, v.rule):
                continue
            if (v.rule, v.path, src.strip()) in base:
                continue
            out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def to_sarif(violations: list[Violation]) -> dict:
    """Render violations as a SARIF 2.1.0 log (one run, one tool).
    Deterministic: rules sorted by id, results keep run_analysis's
    (path, line, rule) sort, and the serialization is sort_keys=True —
    the same tree state always yields byte-identical output (golden test
    in tests/test_torch_analysis.py)."""
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "distributed-grep-torch-analyze",
                "informationUri":
                    "https://example.invalid/distributed_grep_tpu_torch",
                "rules": [
                    {"id": name,
                     "shortDescription": {"text": RULE_DOCS[name]}}
                    for name in sorted(RULES)
                ],
            }},
            "results": [
                {
                    "ruleId": v.rule,
                    "level": "error",
                    "message": {"text": v.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": v.path},
                            "region": {"startLine": v.line},
                        },
                    }],
                }
                for v in violations
            ],
        }],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="distributed_grep_tpu_torch analyze",
        description="project invariant checker (AST-walked; exit 1 on "
                    "violations)",
    )
    p.add_argument("--root", default=None,
                   help="source tree to analyze (default: the installed "
                        "distributed_grep_tpu_torch package)")
    p.add_argument("--rule", action="append", default=None, metavar="NAME",
                   help="run only this rule (repeatable; default: all)")
    p.add_argument("--baseline", default=None,
                   help="allowlist file of known violations "
                        "(rule<TAB>path<TAB>stripped source line)")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write current violations as a baseline and exit 0")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--sarif", action="store_true", dest="as_sarif",
                   help="SARIF 2.1.0 output (CI annotations / editors); "
                        "results keep the stable (path, line, rule) sort")
    p.add_argument("--list-rules", action="store_true",
                   help="list rules with the invariant each encodes")
    p.add_argument("--knobs", action="store_true",
                   help="print the DGREP_* env-knob registry as markdown "
                        "(the generated operator docs), then the "
                        "reference's knobs this package does not read")
    p.add_argument("--events", action="store_true",
                   help="print the telemetry event vocabulary (span/"
                        "instant/daemon-event names) as markdown")
    args = p.parse_args(argv)

    if args.list_rules:
        for name in RULES:
            print(f"{name}: {RULE_DOCS[name]}")
        return 0
    if args.knobs:
        from distributed_grep_tpu_torch.analysis.knobs import knob_docs

        print(knob_docs(), end="")
        return 0
    if args.events:
        from distributed_grep_tpu_torch.analysis.events import event_docs

        print(event_docs(), end="")
        return 0

    try:
        violations = run_analysis(root=args.root, rules=args.rule,
                                  baseline=args.baseline)
    except (ValueError, OSError) as e:  # unknown rule / unreadable baseline
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        root = Path(args.root) if args.root else PACKAGE_ROOT
        cache: dict[str, list[str]] = {}
        lines = [f"{v.rule}\t{v.path}\t{_source_line(root, v, cache)}"
                 for v in violations]
        try:
            Path(args.write_baseline).write_text(
                "\n".join(lines) + ("\n" if lines else ""), encoding="utf-8")
        except OSError as e:  # same clean exit-2 contract as the read side
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"{len(violations)} violation(s) -> {args.write_baseline}")
        return 0

    if args.as_sarif:
        print(json.dumps(to_sarif(violations), indent=2, sort_keys=True))
    elif args.as_json:
        print(json.dumps({
            "violations": [
                {"rule": v.rule, "path": v.path, "line": v.line,
                 "message": v.message}
                for v in violations
            ],
            "count": len(violations),
        }, indent=2, sort_keys=True))
    else:
        for v in violations:
            print(v.render())
        if violations:
            print(f"{len(violations)} violation(s)", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
