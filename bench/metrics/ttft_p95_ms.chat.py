"""95th percentile over every request due in the window of its time to
first token: the end of the step that emitted the token, less the time
the request was due.  A request unfinished after the drain counts as
infinite (then there is no reading).  Read in the traced run: at 250
requests a window its spread is too wide for a bound (``PERF.md``)."""


def read(run):
    return run.e2e.get("ttft_p95_ms")
