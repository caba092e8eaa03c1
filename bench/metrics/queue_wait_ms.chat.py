"""Mean time a request waited to be admitted to a slot (the engine's
``admitted_at`` less its ``arrival``, ``serving/scheduler.py`` and
``engine._admit``), over every finished request."""


def read(run):
    s = run.host.get("queue_wait_s")
    return 1e3 * sum(s) / len(s) if s else None
