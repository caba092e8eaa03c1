"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name in files: the
model configuration (``configs/<config>.json``), the traffic mix
(``traffic/<mix>.json``), the cell's comparison limits
(``cells/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``).  ``README.md`` says how to add each.
"""
