"""CLI: ``python -m repro_torch.obs {summary,export,validate} trace.jsonl``."""

from __future__ import annotations

import argparse
import json
import sys

from .perfetto import export_perfetto
from .summary import format_summary, summarize
from .trace import read_trace, validate_trace


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect repro_torch telemetry traces (JSONL).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summary", help="analyze a trace: comm overlap, "
                       "retry storms, stragglers, swap dips")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as JSON")

    p = sub.add_parser("export", help="convert to Perfetto trace_event "
                       "JSON (open at https://ui.perfetto.dev)")
    p.add_argument("trace")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <trace>.perfetto.json)")

    p = sub.add_parser("validate", help="schema-check every record")
    p.add_argument("trace")

    args = ap.parse_args(argv)

    if args.cmd == "summary":
        records, skipped = read_trace(args.trace)
        s = summarize(records, skipped)
        print(json.dumps(s, indent=2, default=str) if args.json
              else format_summary(s))
        return 0

    if args.cmd == "export":
        out = args.out or (args.trace.rsplit(".jsonl", 1)[0]
                           + ".perfetto.json")
        n, skipped = export_perfetto(args.trace, out)
        print(f"wrote {n} trace events -> {out}"
              + (f" (skipped {skipped} torn lines)" if skipped else ""))
        return 0

    records, skipped = read_trace(args.trace)
    errors = validate_trace(records)
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    print(f"{len(records)} records, {skipped} torn lines, "
          f"{len(errors)} schema errors")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
