"""One driver a kind of traffic (``traffic/<mix>.json``'s ``kind``):
``train`` and ``serve``.  A driver sets the cell up, runs the measured
window, and hands back a ``Run``: its end-to-end numbers, the context
the per-layer readers read, and the readings the reference judges."""
