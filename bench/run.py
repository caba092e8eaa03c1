"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, last on standard error, each compared number beside its limit,
and last on standard output one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; ``limits`` last).  Exits non-zero, printing no result,
without enough CUDA devices or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and its ``src``, never this directory (whose module
# names would shadow others)
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
