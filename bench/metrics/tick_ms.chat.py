"""Mean host time of one engine tick (``serving/engine.py``
``ContinuousBatchingEngine.step``): the program's own ``serve.tick``
spans that lie in the window of a traced run (the profiler records
after it)."""


def read(run):
    s = run.host.get("tick_s")
    return 1e3 * sum(s) / len(s) if s else None
