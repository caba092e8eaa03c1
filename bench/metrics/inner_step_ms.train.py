"""Mean host time of one inner step of all workers (``launch/steps.py``
``make_inner_train_step``), between two synchronizes, over the window
of a traced run (the profiler records after it)."""


def read(run):
    s = run.host.get("inner_step_s")
    return 1e3 * sum(s) / len(s) if s else None
