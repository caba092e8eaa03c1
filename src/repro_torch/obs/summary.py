"""Trace analytics: the questions a chaos run's timeline should answer.

- **comm overlap** — per training phase, how much fragment-send wire
  time was hidden under *other shards'* inner compute (the Streaming
  DiLoCo objective: comm overlapped with compute costs nothing).
- **retry storms** — windows where transport retries cluster, with
  the shards/phases involved.
- **straggler attribution** — per-shard mean phase wall time against
  the fleet median.
- **swap dips** — serving tick latency inside engine hot-swap windows
  vs steady state.
"""

from __future__ import annotations

__all__ = ["summarize", "format_summary"]

_STORM_WINDOW_NS = 100_000_000  # 100 ms
_STORM_MIN = 3


def _spans(records, name):
    return [r for r in records
            if r.get("k") == "span" and r.get("name") == name]


def _events(records, name):
    return [r for r in records
            if r.get("k") == "ev" and r.get("name") == name]


def _overlap(a0, a1, intervals):
    """Total length of [a0, a1] covered by the union of intervals."""
    covered = 0
    cur = a0
    for b0, b1 in sorted(intervals):
        if b1 <= cur:
            continue
        if b0 >= a1:
            break
        covered += min(a1, b1) - max(cur, b0)
        cur = max(cur, b1)
        if cur >= a1:
            break
    return covered


def comm_overlap(records):
    """Per-phase % of fragment-send time overlapped with other
    shards' ``train.phase`` compute."""
    phases = {}
    for sp in _spans(records, "train.phase"):
        args = sp.get("args") or {}
        phases.setdefault(args.get("phase"), []).append(
            (args.get("shard"), sp["t0"], sp["t1"]))
    out = {}
    for sp in _spans(records, "train.fragment_send"):
        args = sp.get("args") or {}
        t, s = args.get("phase"), args.get("shard")
        total = sp["t1"] - sp["t0"]
        others = [(t0, t1) for (sh, t0, t1) in phases.get(t, ())
                  if sh != s]
        ov = _overlap(sp["t0"], sp["t1"], others)
        acc = out.setdefault(t, [0, 0])
        acc[0] += total
        acc[1] += ov
    return {
        t: {"send_ns": tot, "overlap_pct": (100.0 * ov / tot) if tot else 0.0}
        for t, (tot, ov) in sorted(out.items(), key=lambda kv: str(kv[0]))
    }


def retry_storms(records):
    """Cluster ``transport.retry`` instants into 100 ms windows."""
    retries = sorted(_events(records, "transport.retry"),
                     key=lambda r: r["t"])
    storms = []
    i = 0
    while i < len(retries):
        j = i
        while (j + 1 < len(retries)
               and retries[j + 1]["t"] - retries[i]["t"] <= _STORM_WINDOW_NS):
            j += 1
        burst = retries[i:j + 1]
        if len(burst) >= _STORM_MIN:
            shards = sorted({(b.get("args") or {}).get("shard")
                             for b in burst}, key=str)
            storms.append({
                "count": len(burst),
                "span_ms": (burst[-1]["t"] - burst[0]["t"]) / 1e6,
                "shards": shards,
            })
        i = j + 1
    return {"total_retries": len(retries), "storms": storms}


def stragglers(records):
    """Per-shard mean ``train.phase`` wall vs the fleet median."""
    per_shard = {}
    for sp in _spans(records, "train.phase"):
        s = (sp.get("args") or {}).get("shard")
        per_shard.setdefault(s, []).append(sp["t1"] - sp["t0"])
    means = {s: sum(v) / len(v) for s, v in per_shard.items() if v}
    if not means:
        return {}
    ordered = sorted(means.values())
    median = ordered[len(ordered) // 2]
    return {
        s: {
            "mean_ms": m / 1e6,
            "vs_median": (m / median) if median else 1.0,
            "straggler": median > 0 and m / median > 1.5,
        }
        for s, m in sorted(means.items(), key=lambda kv: str(kv[0]))
    }


def swap_dips(records):
    """Mean ``serve.tick`` duration inside vs outside ``serve.swap``
    windows."""
    windows = [(sp["t0"], sp["t1"]) for sp in _spans(records, "serve.swap")]
    inside, outside = [], []
    for sp in _spans(records, "serve.tick"):
        mid = (sp["t0"] + sp["t1"]) // 2
        dur = sp["t1"] - sp["t0"]
        if any(w0 <= mid <= w1 for w0, w1 in windows):
            inside.append(dur)
        else:
            outside.append(dur)
    out = {
        "swap_windows": len(windows),
        "ticks_in_swap": len(inside),
        "ticks_steady": len(outside),
    }
    if inside and outside:
        mi = sum(inside) / len(inside)
        mo = sum(outside) / len(outside)
        out["mean_tick_in_swap_us"] = mi / 1e3
        out["mean_tick_steady_us"] = mo / 1e3
        out["dip_ratio"] = mi / mo if mo else 1.0
    return out


def summarize(records, skipped=0):
    names = {}
    for r in records:
        if r.get("k") in ("span", "ev"):
            names[r["name"]] = names.get(r["name"], 0) + 1
    return {
        "records": len(records),
        "skipped_lines": skipped,
        "epochs": sum(1 for r in records if r.get("k") == "hdr"),
        "names": dict(sorted(names.items())),
        "comm_overlap": comm_overlap(records),
        "retry_storms": retry_storms(records),
        "stragglers": stragglers(records),
        "swap_dips": swap_dips(records),
    }


def format_summary(summary):
    lines = [
        f"records: {summary['records']}  "
        f"(skipped torn lines: {summary['skipped_lines']}, "
        f"epochs: {summary['epochs']})",
        "",
        "span/event counts:",
    ]
    for name, n in summary["names"].items():
        lines.append(f"  {name:<24} {n}")
    if summary["comm_overlap"]:
        lines += ["", "comm overlap (fragment-send time hidden under "
                      "other shards' compute):"]
        for t, row in summary["comm_overlap"].items():
            lines.append(f"  phase {t}: {row['overlap_pct']:5.1f}%  "
                         f"of {row['send_ns'] / 1e6:.2f} ms send time")
    rs = summary["retry_storms"]
    if rs["total_retries"]:
        lines += ["", f"transport retries: {rs['total_retries']}"]
        for storm in rs["storms"]:
            lines.append(f"  storm: {storm['count']} retries in "
                         f"{storm['span_ms']:.1f} ms "
                         f"(shards {storm['shards']})")
    if summary["stragglers"]:
        lines += ["", "straggler attribution (mean train.phase wall):"]
        for s, row in summary["stragglers"].items():
            flag = "  << straggler" if row["straggler"] else ""
            lines.append(f"  shard {s}: {row['mean_ms']:8.2f} ms  "
                         f"({row['vs_median']:.2f}x median){flag}")
    sd = summary["swap_dips"]
    if sd.get("swap_windows"):
        lines += ["", f"engine swaps: {sd['swap_windows']} windows, "
                      f"{sd['ticks_in_swap']} ticks inside"]
        if "dip_ratio" in sd:
            lines.append(
                f"  tick wall in-swap {sd['mean_tick_in_swap_us']:.1f} µs "
                f"vs steady {sd['mean_tick_steady_us']:.1f} µs "
                f"(dip ratio {sd['dip_ratio']:.2f}x)")
    return "\n".join(lines)
