"""Find a serving cell's knee: the highest open-loop rate the engine
sustains, by a sweep on the card (run once when a cell is defined; the
cell's mix then fixes its rate).

    python3 bench/tools/sweep.py --config dipaco-150m --traffic chat \\
        --seed 7 --rates 5,8,11,14,18 --seconds 15

One engine (the mix's set-up) serves a fresh window of each rate in
turn; each prints a JSON line: tokens a second, TTFT and TPOT
percentiles, the requests still waiting or running when the window
closed (a growing backlog means the rate is above the knee), those not
finished after the drain, and the requests in flight after each step
(mean, most, most on one path).
"""
import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from bench import hostload  # noqa: E402
from bench.drivers import serve  # noqa: E402
from bench.harness import BENCH, Spec, load_json  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--drain", type=float, default=30.0)
    args = p.parse_args()
    import numpy as np
    from repro_torch.serving.scheduler import Request
    spec = Spec({"name": "sweep", "config": args.config,
                 "traffic": args.traffic, "chips": 1},
                load_json(BENCH / "configs" / f"{args.config}.json"),
                load_json(BENCH / "traffic" / f"{args.traffic}.json"),
                {}, [], [])
    eng, _, _ = serve.build_engine(spec, args.seed, "cuda")
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        s = replace(spec, mix={**spec.mix, "rate": rate})
        reqs = serve.make_requests(s, args.seed + 1 + k, args.seconds)
        stamps = serve.Stamps()
        t0 = time.perf_counter()
        with hostload.Window() as host:
            w = serve.serve_window(eng, reqs, args.seconds, stamps, Request,
                                   rid0=k * 1_000_000)
        backlog = len(stamps.due) - len(stamps.done)
        serve.drain(eng, w, stamps, args.drain)
        rids = sorted(stamps.due)
        ttft = [stamps.first[r] - stamps.due[r] for r in rids
                if r in stamps.first]
        out = {"rate": rate, "requests": len(rids),
               "tokens_per_s": w["emitted"] / w["window_s"],
               "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
               "backlog_at_close": backlog,
               "live_mean": float(np.mean(w["live"])),
               "live_max": max(w["live"], default=0),
               "live_path_max": [stamps.live_path_max.get(p, 0)
                                 for p in range(s.mix["paths"])],
               "queue_wait_ms_mean": 1e3 * float(np.mean(
                   [f.admitted_at - f.arrival for f in w["finished"]])),
               "path_counts": np.bincount(
                   [f.path for f in w["finished"]],
                   minlength=s.mix["paths"]).tolist(),
               "host": host.readings,
               "wall_s": time.perf_counter() - t0, **serve.tails(stamps)}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
