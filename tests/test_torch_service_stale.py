"""The port's pipelined service with a staleness window of 1 held to the
JAX package's ``TrainingService`` over three phases, on one pool thread
so that both commit in the same order: the checkpoint rows in the same
order, the per-(phase, shard) losses to 1e-5 and every path's
parameters to 5e-6.  With the int8 wire an element whose delta sits on
a rounding tie of the quantizer (JAX's jitted division and the port's
eager one differ in the last bit) lands one quantization step away, and
the error-feedback residual carries the step into the next phase, so
after three phases a few elements in a thousand differ, by at most one
step (3.1e-5 measured, against 5e-5 allowed).  At lag 1 a shard that
finishes phase t starts phase t + 1 from the store as it then is,
before the other shards' phase-t deltas land, so its phase-(t + 1)
delta is taken against an older snapshot and applied on top of the
newer modules; both packages do so (the first snapshots below).  Every
service gets a 60 s phase timeout and is shut down in a
``finally``.

The row order is compared, so neither service may let the pool thread
commit a phase between the snapshot rows that one ``run`` writes as it
starts (its pump takes every shard's snapshot and enqueues its task on
the caller's thread, holding no lock).  The port takes every snapshot
before it enqueues the first task.  The JAX service enqueues each task
just after its snapshot, so under load its pool thread could commit
shard 0's phase before shard 3's snapshot was written;
``_pump_before_commits`` holds its commit lock through that pump."""
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro.data import sharder as jsharder
from repro.infra import TrainingService as JService
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import pytree
from repro_torch.data import sharder
from repro_torch.infra import TrainingService
from repro_torch.infra.ckpt_db import load_tree
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree

TIMEOUT = 60.0
TAU, PHASES = 2, 3
# chip_smoke.py phase 8's schedule, shortened to tau 2: warmup one
# phase, cosine to the end of the third
SCHEDULE = dict(batch_size=4, peak_lr=2e-3, warmup=TAU,
                total_steps=PHASES * TAU, num_workers=1, max_phase_lag=1,
                phase_timeout=TIMEOUT)
WIRES = {"fp32-k1": dict(),
         "int8-k4": dict(outer_fragments=4, fragment_stagger=1,
                         comm_dtype="int8")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pump_before_commits(svc):
    """Hold ``svc``'s commit lock while the test's thread pumps, so that
    the pool thread commits nothing between the pump's snapshot rows.
    The pool thread pumps under that lock already."""
    pump, caller = svc._pump, threading.get_ident()

    def pump_locked():
        if threading.get_ident() != caller:
            return pump()
        with svc._commit_lock:
            return pump()

    svc._pump = pump_locked


def _row_order(db):
    return [(r.kind, r.path_id, r.phase, r.level, r.expert, r.fragment)
            for r in db.rows()]


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_stale_service_three_phases_matches_reference(tiny_cfg, tiny_base,
                                                      tiny_docs, wire):
    cfg = get_smoke_config("dipaco-150m").replace(route_prefix_len=8,
                                                  attn_impl="pallas")
    jcfg = tiny_cfg.replace(attn_impl="chunked")
    base = jax.tree_util.tree_map(np.asarray, tiny_base[0])
    docs, doms = tiny_docs
    kw = dict(levels=(2, 2), inner_steps=TAU, **WIRES[wire])
    with tempfile.TemporaryDirectory() as r1, \
            tempfile.TemporaryDirectory() as r2:
        ts = TrainingService(
            cfg, DiPaCoConfig(**kw),
            sharder.shard_documents(docs, doms % 4, 4), ckpt_root=r1,
            base_params=from_numpy_tree(base, device="cpu"), device="cpu",
            **SCHEDULE)
        js = None
        try:
            js = JService(jcfg, JDiPaCoConfig(**kw),
                          jsharder.shard_documents(docs, doms % 4, 4),
                          ckpt_root=r2, key=jax.random.PRNGKey(0),
                          base_params=base, **SCHEDULE)
            _pump_before_commits(js)
            # as chip_smoke.py runs it: two phases, a sync point, one more
            for n in (PHASES - 1, 1):
                a, b = ts.run(n), js.run(n)
                assert a["outer_updates"] == b["outer_updates"]
                assert a["max_observed_lag"] == b["max_observed_lag"] == 1
            assert _row_order(ts.db) == _row_order(js.db)
            # the first shard to finish phase 0 starts phase 1 from the
            # base (no phase-0 delta has landed), the last one from
            # updated modules
            like = ts.path_params(0)
            start = [load_tree(ts.db.rows(kind="snap", path_id=s,
                                          phase=1)[0].file, like)
                     for s in (0, 3)]
            base_leaves = [x.numpy() for x in pytree.leaves(
                from_numpy_tree(base, device="cpu"))]
            assert all(np.array_equal(x.numpy(), y) for x, y in
                       zip(pytree.leaves(start[0]), base_leaves))
            assert not all(np.array_equal(x.numpy(), y) for x, y in
                           zip(pytree.leaves(start[1]), base_leaves))
            assert ts.losses.keys() == js.losses.keys()
            assert len(ts.losses) == 4 * PHASES
            for k in ts.losses:
                assert abs(ts.losses[k] - js.losses[k]) < 1e-5, k
            for p in range(4):
                mine = [x.numpy() for x in pytree.leaves(ts.path_params(p))]
                theirs = [np.asarray(x) for x in
                          jax.tree_util.tree_leaves(js.path_params(p))]
                assert len(mine) == len(theirs)
                for x, y in zip(mine, theirs):
                    d = np.abs(x - y)
                    if wire == "fp32-k1":
                        assert d.max() <= 5e-6
                    else:
                        assert (d > 5e-6).sum() <= max(8, 1e-2 * d.size)
                        assert d.max() <= 5e-5
        finally:
            ts.shutdown()
            if js is not None:
                js.shutdown()
