"""Command line: ``python -m repro_torch.analysis [--gate] [--json] ...``.

Runs the three passes over ``src/repro_torch`` (+ ``tools`` and
``chip_smoke.py`` for the torchlint clock rule), subtracts the committed
baseline ``analysis/baseline_torch.json``, and reports.

Exit codes: 0 clean (or informational run), 1 with ``--gate`` when
there are findings outside the baseline, stale baseline entries (a
fingerprint the tree no longer produces: remove it, don't let
suppressions rot), or baseline entries with no reason.

``--write-baseline`` regenerates the baseline from the current tree,
keeping the reason of every entry that stays; write the reason of each
new entry by hand and review the diff like code.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from . import Finding, Project, repo_root_default
from . import ckpt_schema, locks, torchlint

PASSES = (("locks", locks.run), ("torchlint", torchlint.run),
          ("ckpt_schema", ckpt_schema.run))


def run_all(root: Path) -> list[Finding]:
    project = Project(root)
    findings: list[Finding] = []
    for _, fn in PASSES:
        findings.extend(fn(project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings


def load_baseline(path: Path) -> list[dict]:
    if not path.is_file():
        return []
    data = json.loads(path.read_text())
    return data.get("findings", [])


def write_baseline(path: Path, findings: list[Finding]) -> None:
    reasons = {e["fingerprint"]: e.get("reason", "")
               for e in load_baseline(path)}
    entries, seen = [], set()
    for f in findings:
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        entries.append({"fingerprint": f.fingerprint, "rule": f.rule,
                        "path": f.path, "scope": f.scope,
                        "detail": f.detail,
                        "reason": reasons.get(f.fingerprint, "")})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"version": 1, "comment":
         "accepted findings of the port, each with its reason; "
         "regenerate with `python -m repro_torch.analysis "
         "--write-baseline`",
         "findings": entries}, indent=2) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--root", type=Path, default=repo_root_default(),
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file "
                         "(default: <root>/analysis/baseline_torch.json)")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 on new findings, stale baseline "
                         "entries or entries with no reason")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the baseline")
    args = ap.parse_args(argv)

    root = args.root.resolve()
    baseline_path = args.baseline or root / "analysis" / \
        "baseline_torch.json"
    findings = run_all(root)

    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    entries = load_baseline(baseline_path)
    base = {e["fingerprint"] for e in entries}
    unexplained = sorted(e["fingerprint"] for e in entries
                         if not e.get("reason", "").strip())
    produced = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in base]
    suppressed = [f for f in findings if f.fingerprint in base]
    stale = sorted(base - produced)

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "new": [f.fingerprint for f in new],
            "baseline_suppressed": sorted(
                {f.fingerprint for f in suppressed}),
            "stale_baseline": stale,
            "baseline_without_reason": unexplained,
            "summary": dict(Counter(f.rule for f in findings)),
        }, indent=2))
    else:
        for f in new:
            mark = "error" if f.severity == "error" else "warn"
            print(f"{f.path}:{f.line} {f.rule} [{mark}] {f.message} "
                  f"({f.scope})")
        for fp in unexplained:
            print(f"baseline: entry {fp} has no reason; write one in "
                  f"{baseline_path}")
        for fp in stale:
            print(f"baseline: STALE entry {fp} — tree no longer "
                  f"produces it; remove it from {baseline_path}")
        counts = Counter(f.rule for f in findings)
        total = sum(counts.values())
        by_rule = ", ".join(f"{r}={n}" for r, n in sorted(
            counts.items())) or "none"
        print(f"analysis: {total} finding(s) [{by_rule}]; "
              f"{len(new)} new, {len(suppressed)} in baseline, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}")

    if args.gate and (new or stale or unexplained):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
