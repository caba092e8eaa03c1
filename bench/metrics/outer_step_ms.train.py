"""Mean host time of one outer step (``core/dipaco.py`` ``_outer`` ->
``core/diloco.py`` ``outer_step_``), between two synchronizes, over the
window of a traced run (the profiler records after it)."""


def read(run):
    s = run.host.get("outer_step_s")
    return 1e3 * sum(s) / len(s) if s else None
