"""95th percentile over every request due in the window of (finished -
first token) / (new tokens - 1).  A request unfinished after the drain
counts as infinite (then there is no reading).  Read in the traced run:
at 250 requests a window its spread is too wide for a bound
(``PERF.md``)."""


def read(run):
    return run.e2e.get("tpot_p95_ms")
