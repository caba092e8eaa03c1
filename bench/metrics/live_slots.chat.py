"""Engine (``serving/engine.py``): the requests in flight after each
engine step of the window, averaged over its steps: how much of the
slot pool the traffic fills."""


def read(run):
    live = run.host.get("live")
    return sum(live) / len(live) if live else None
