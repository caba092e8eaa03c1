"""Read the comparison's numbers of a cell for its control and its
faults, at the cell's own size, on several seeds (on the card).

    python3 bench/tools/control.py --workload train-150m-2x2 \\
        --seeds 11,12,13 --variants control,frozen,half_batch \\
        --seconds 1

``control`` puts the reference computed in float8 in the program's
place; the others plant a fault of ``tools/faults.py`` under the timed
path; ``sound`` plants nothing.  Each run prints one JSON line with its
numbers and whether ``correct`` came out true.  The limits in
``cells/<cell>.json`` are set from these readings (upper) and the sound
runs' (lower); ``PERF.md`` keeps both.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from bench.harness import execute, load_spec  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args()
    spec = load_spec(args.workload)
    for variant in args.variants.split(","):
        faults = () if variant == "sound" else (variant,)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            run, correct, _ = execute(spec, seed, args.seconds, False,
                                      "cuda", t0, faults=faults)
            print(json.dumps({"variant": variant, "seed": seed,
                              "correct": correct, "numbers": run.numbers,
                              "e2e": run.e2e,
                              "paths": run.work.get("path_counts"),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
