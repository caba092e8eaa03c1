"""Percent of the traced slice in which no operation ran on the device
(the union of the trace's device intervals against the slice)."""


def read(run):
    if run.trace is None or not run.trace_window_s:
        return None
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.trace_window_s) if busy else None
