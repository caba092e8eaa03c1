"""The port's continuous-batching engine against the JAX package's, in
fp32 on the CPU: the nine-row engine matrix of ``tests/test_serving.py``
(greedy tokens identical to the reference group, scheduler stats equal),
§2.4.3 migration, preemption, the prefix cache, Mamba paths and
heterogeneous paths (tokens and final paths equal to the JAX engine's),
the masked decode that leaves rows bit for bit unchanged, the
path-stacked step against P single-path steps, the slot arenas, and the
scheduler copy against the original."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.serving import PRIO_HIGH as J_HIGH
from repro.serving import PRIO_PREEMPTIBLE as J_PREEMPTIBLE
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import EngineOptions as JOptions
from repro.serving import PathServingEngine as JOneShot
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import poisson_trace as jtrace
from repro.serving import prefix_hash_router as jhash
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import SyntheticCorpus
from repro_torch.models import api as tapi
from repro_torch.models import lm
from repro_torch.models.params import from_numpy_tree, tree_leaves, tree_map
from repro_torch.serving import (PRIO_HIGH, PRIO_PREEMPTIBLE, PRIO_STANDARD,
                                 ContinuousBatchingEngine, EngineOptions,
                                 Request, Scheduler, SlotArena, SlotExhausted,
                                 StackedSlotArenas, poisson_trace,
                                 prefix_hash_router)

_EQ_LENS = [16, 12, 8, 16, 12]

# the reference's matrix (tests/test_serving.py): (name, attn_impl,
# stacked islands, bucketed prefill, int8 KV cache); "chunked" stands for
# the reference's jnp branch, "pallas" for the plain kernel versions
_ENGINE_MATRIX = [
    ("chunked-looped", "chunked", False, True, False),
    ("chunked-stacked", "chunked", True, True, False),
    ("pallas-looped", "pallas", False, True, False),
    ("pallas-stacked", "pallas", True, True, False),
    ("batch1-prefill", "chunked", False, False, False),
    ("chunked-looped-int8kv", "chunked", False, True, True),
    ("chunked-stacked-int8kv", "chunked", True, True, True),
    ("pallas-looped-int8kv", "pallas", False, True, True),
    ("pallas-stacked-int8kv", "pallas", True, True, True),
]


def _jpaths(jcfg, n=2, key=0):
    k = jax.random.PRNGKey(key)
    return [japi.init_model(jax.random.fold_in(k, p) if p else k, jcfg)[0]
            for p in range(n)]


def _bridge(jpaths):
    return [from_numpy_tree(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu") for p in jpaths]


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke("dipaco-150m").replace(route_prefix_len=8)
    tcfg = tsmoke("dipaco-150m").replace(route_prefix_len=8)
    jp = _jpaths(jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


def _prompts(cfg, lens, seed=10):
    return [np.asarray(jax.random.randint(jax.random.PRNGKey(seed + i),
                                          (n,), 0, cfg.vocab_size), np.int32)
            for i, n in enumerate(lens)]


def _serve(engine, reqs):
    return {f.rid: f for f in engine.serve_trace(reqs)}


def _both(jcfg, tcfg, jp, tp, reqs, **opts):
    """The same trace through the JAX engine and the port's -> (jax
    engine, its finished, port engine, its finished)."""
    jeng = JEngine(jcfg, jp, options=JOptions(**opts))
    teng = ContinuousBatchingEngine(tcfg, tp, options=EngineOptions(**opts))
    jf = _serve(jeng, [JRequest(**r) for r in reqs])
    tf = _serve(teng, [Request(**r) for r in reqs])
    return jeng, jf, teng, tf


def _assert_same(jf, tf):
    assert sorted(jf) == sorted(tf)
    for rid in jf:
        np.testing.assert_array_equal(tf[rid].tokens, jf[rid].tokens)
        assert tf[rid].path == jf[rid].path
        assert tf[rid].switches == jf[rid].switches
        assert tf[rid].preemptions == jf[rid].preemptions
        assert tf[rid].finished_at == jf[rid].finished_at


def _stats(engine):
    return dataclasses.asdict(engine.scheduler.stats)


# ---------------------------------------------------------------------------
# the engine matrix
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def matrix_refs(setup):
    """Reference greedy tokens, computed once: fp32 rows against the JAX
    one-shot engine, int8-KV rows against the JAX continuous engine with
    an int8 cache (chunked, looped, bucketed), whose scheduler stats are
    every row's (the schedule does not depend on the decode config)."""
    jcfg, _, jp, _ = setup
    prompts = _prompts(jcfg, _EQ_LENS, seed=33)
    old = JOneShot(jcfg, jp, options=JOptions(cache_len=48))
    fp32 = {}
    for n in sorted(set(_EQ_LENS)):
        idx = [i for i, m in enumerate(_EQ_LENS) if m == n]
        r = old.generate(np.stack([prompts[i] for i in idx]), max_new=6)
        for j, i in enumerate(idx):
            fp32[i] = r.tokens[j]
    eng = JEngine(jcfg.replace(kv_quant=True), jp, options=JOptions(
        cache_len=48, slots_per_path=2, stacked=False,
        bucketed_prefill=True))
    fins = _serve(eng, [JRequest(rid=i, prompt=prompts[i], max_new=6)
                        for i in range(len(_EQ_LENS))])
    return prompts, {"fp32": fp32, "int8": {i: f.tokens
                                            for i, f in fins.items()}}, \
        _stats(eng)


@pytest.mark.parametrize(
    "name,attn_impl,stacked,bucketed,kv_quant", _ENGINE_MATRIX,
    ids=[row[0] for row in _ENGINE_MATRIX])
def test_engine_matrix_matches_reference_engine(setup, matrix_refs, name,
                                                attn_impl, stacked, bucketed,
                                                kv_quant):
    _, tcfg, _, tp = setup
    prompts, refs, stats = matrix_refs
    eng = ContinuousBatchingEngine(
        tcfg.replace(attn_impl=attn_impl, kv_quant=kv_quant), tp,
        options=EngineOptions(cache_len=48, slots_per_path=2,
                              stacked=stacked, bucketed_prefill=bucketed))
    assert eng.stacked is stacked and eng.bucketed is bucketed
    assert not eng.cuda_graph                        # CPU: no graph
    fins = _serve(eng, [Request(rid=i, prompt=prompts[i], max_new=6)
                        for i in range(len(_EQ_LENS))])
    ref = refs["int8" if kv_quant else "fp32"]
    assert sorted(fins) == list(range(len(_EQ_LENS)))
    for i in fins:
        np.testing.assert_array_equal(fins[i].tokens, ref[i])
    assert _stats(eng) == stats
    assert stats["backpressure_ticks"] > 0
    assert all(a.num_free == 2 for a in eng.arenas)
    ticks = eng.decode_stats
    assert (ticks["dense"] + ticks["sparse_islands"] > 0) == stacked
    assert (ticks["looped_islands"] > 0) == (not stacked)


# ---------------------------------------------------------------------------
# scenarios against the JAX engine
# ---------------------------------------------------------------------------
class ScriptedRouter:
    """Admission -> path 0; re-route checks alternate between paths."""

    def __init__(self):
        self.calls = 0

    def assign(self, z):
        self.calls += 1
        if self.calls == 1:
            return np.zeros(z.shape[0], np.int32)
        return np.full(z.shape[0], self.calls % 2, np.int32)


class Admit0ThenOther:
    def __init__(self):
        self.calls = 0

    def assign(self, z):
        self.calls += 1
        return np.full(z.shape[0], 0 if self.calls == 1 else 1, np.int32)


@pytest.mark.parametrize("stacked", [False, True])
def test_reroute_migration_matches_reference(setup, stacked):
    """§2.4.3: forced switches re-prefill into a fresh slot of the target
    island, as the JAX engine does, and every slot comes back."""
    jcfg, tcfg, jp, tp = setup
    prompt = _prompts(jcfg, [16], seed=5)[0]
    jeng = JEngine(jcfg, jp, options=JOptions(
        router=ScriptedRouter(), feat_params=jp[0], cache_len=64,
        slots_per_path=2, reroute_every=4, stacked=stacked))
    teng = ContinuousBatchingEngine(tcfg, tp, options=EngineOptions(
        router=ScriptedRouter(), feat_params=tp[0], cache_len=64,
        slots_per_path=2, reroute_every=4, stacked=stacked))
    jf = _serve(jeng, [JRequest(rid=0, prompt=prompt, max_new=12)])
    tf = _serve(teng, [Request(rid=0, prompt=prompt, max_new=12)])
    _assert_same(jf, tf)
    assert tf[0].switches > 0
    assert all(a.num_free == 2 for a in teng.arenas)
    assert teng.decode_stats["feature_calls"] == 1 + 12 // 4 - 1


def test_migration_deferred_when_target_full(setup):
    """A re-route to a full island is deferred: the request keeps
    decoding on its path, as in the reference."""
    jcfg, tcfg, jp, tp = setup
    prompt = _prompts(jcfg, [16], seed=6)[0]
    engines = []
    for eng_cls, opt_cls, paths in ((JEngine, JOptions, jp),
                                    (ContinuousBatchingEngine, EngineOptions,
                                     tp)):
        eng = eng_cls(jcfg if eng_cls is JEngine else tcfg, paths,
                      options=opt_cls(router=Admit0ThenOther(),
                                      feat_params=paths[0], cache_len=64,
                                      slots_per_path=1, reroute_every=4))
        eng.arenas[1].alloc()      # path 1's only slot: nowhere to go
        engines.append(eng)
    jf = _serve(engines[0], [JRequest(rid=0, prompt=prompt, max_new=8)])
    tf = _serve(engines[1], [Request(rid=0, prompt=prompt, max_new=8)])
    _assert_same(jf, tf)
    assert tf[0].path == 0 and tf[0].switches == 0


@pytest.mark.parametrize("preemption", [True, False])
def test_preemption_matches_reference(setup, preemption):
    """A high-priority arrival on a full island evicts the preemptible
    occupant (re-admitted by re-prefill) — or waits, with preemption off
    — with the JAX engine's tokens, finish ticks and stats."""
    jcfg, tcfg, jp, tp = setup
    prompts = _prompts(jcfg, [8, 8], seed=70)
    reqs = [dict(rid=0, prompt=prompts[0], max_new=8, path=0,
                 priority=PRIO_PREEMPTIBLE, arrival=0.0),
            dict(rid=1, prompt=prompts[1], max_new=3, path=0,
                 priority=PRIO_HIGH, arrival=0.003)]
    assert (PRIO_HIGH, PRIO_PREEMPTIBLE) == (J_HIGH, J_PREEMPTIBLE)
    jeng, jf, teng, tf = _both(jcfg, tcfg, jp, tp, reqs, cache_len=32,
                               slots_per_path=1, preemption=preemption)
    _assert_same(jf, tf)
    assert _stats(teng) == _stats(jeng)
    assert (tf[0].preemptions >= 1) == preemption


def test_prefix_cache_matches_reference(setup):
    """Exact repeats and shared-prefix extensions from the prefix cache:
    the JAX engine's tokens and hit / extension / miss counts."""
    jcfg, tcfg, jp, tp = setup
    p16 = _prompts(jcfg, [16], seed=80)[0]
    longer = np.concatenate([p16, _prompts(jcfg, [4], seed=81)[0]])
    jeng = JEngine(jcfg, jp, options=JOptions(cache_len=48, slots_per_path=2,
                                              prefix_cache=8))
    teng = ContinuousBatchingEngine(tcfg, tp, options=EngineOptions(
        cache_len=48, slots_per_path=2, prefix_cache=8))
    for rid, prompt in enumerate((p16, p16, longer, longer)):
        jf = _serve(jeng, [JRequest(rid=rid, prompt=prompt, max_new=6,
                                    path=0)])
        tf = _serve(teng, [Request(rid=rid, prompt=prompt, max_new=6,
                                   path=0)])
        np.testing.assert_array_equal(tf[rid].tokens, jf[rid].tokens)
    for k in ("hits", "extensions", "misses"):
        assert getattr(teng.prefix_cache, k) == getattr(jeng.prefix_cache, k)
    assert (teng.prefix_cache.misses, teng.prefix_cache.hits,
            teng.prefix_cache.extensions) == (1, 2, 1)


def test_mamba_paths_disable_bucketing_automatically():
    """SSM paths switch bucketed prefill off by themselves and serve on
    the stacked tick (dense and sparse) with the JAX engine's tokens."""
    jcfg = jsmoke("mamba2-1.3b").replace(route_prefix_len=8)
    tcfg = tsmoke("mamba2-1.3b").replace(route_prefix_len=8)
    jp = _jpaths(jcfg, n=3, key=11)
    tp = _bridge(jp)
    prompts = _prompts(jcfg, [8, 10, 9], seed=50)
    reqs = [dict(rid=i, prompt=prompts[i], max_new=3 + 2 * i, path=i)
            for i in range(3)]
    jeng, jf, teng, tf = _both(jcfg, tcfg, jp, tp, reqs, cache_len=32,
                               slots_per_path=2)
    assert not teng.bucketed and teng.stacked
    assert not jeng.bucketed and jeng.stacked
    _assert_same(jf, tf)
    assert teng.decode_stats["dense"] > 0
    assert teng.decode_stats["sparse_islands"] > 0


def test_heterogeneous_paths_fall_back_to_loop(setup):
    """Paths of different architectures cannot stack: auto-detection
    takes the per-island loop (tokens as the JAX engine's); forcing
    stacked raises, as does bucketing a Mamba path."""
    jcfg, tcfg, jp, tp = setup
    jother = japi.init_model(jax.random.PRNGKey(9),
                             jcfg.replace(d_ff=256))[0]
    jmixed = [jp[0], jother]
    tmixed = [tp[0], _bridge([jother])[0]]
    prompts = _prompts(jcfg, [12, 10, 8], seed=40)
    reqs = [dict(rid=i, prompt=prompts[i], max_new=5, path=i % 2)
            for i in range(3)]
    jeng, jf, teng, tf = _both(jcfg, tcfg, jmixed, tmixed, reqs,
                               cache_len=32, slots_per_path=2)
    assert not teng.stacked and not jeng.stacked
    _assert_same(jf, tf)
    with pytest.raises(ValueError, match="homogeneous"):
        ContinuousBatchingEngine(tcfg, tmixed, options=EngineOptions(
            cache_len=32, slots_per_path=2, stacked=True))
    mcfg = tsmoke("mamba2-1.3b")
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousBatchingEngine(
            mcfg, [tapi.init_model(mcfg, seed=0, device="cpu")],
            options=EngineOptions(cache_len=32, slots_per_path=2,
                                  bucketed_prefill=True))


def test_poisson_trace_routed_by_prefix_hash_matches_reference(setup):
    """A mixed-priority Poisson trace routed by ``prefix_hash_router``
    over both islands: the JAX engine's tokens, paths, finish ticks and
    stats, on the stacked (dense and sparse) tick."""
    jcfg, tcfg, jp, tp = setup
    kw = dict(rate=400.0, prompt_lens=(8, 12, 16), max_new=5,
              vocab_size=jcfg.vocab_size, seed=3,
              priorities=((PRIO_HIGH, PRIO_PREEMPTIBLE), (0.3, 0.7)))
    jreqs = jtrace(12, **kw)
    treqs = poisson_trace(12, **kw)
    jeng = JEngine(jcfg, jp, options=JOptions(
        cache_len=32, slots_per_path=2, route_fn=jhash(2)))
    teng = ContinuousBatchingEngine(tcfg, tp, options=EngineOptions(
        cache_len=32, slots_per_path=2, route_fn=prefix_hash_router(2)))
    _assert_same(_serve(jeng, jreqs), _serve(teng, treqs))
    assert _stats(teng) == _stats(jeng)
    assert teng.decode_stats["dense"] > 0


class _ReplayBody:
    """A stand-in for a captured CUDA graph on the CPU: ``replay`` reruns
    the tick body on the static input buffer and writes the static
    output, as a replay does."""

    def __init__(self, fn):
        self.replay = fn


def test_dense_tick_through_static_buffers_matches_eager(setup):
    """The graph tick's data flow, rehearsed on the CPU: each dense tick
    copies one (3, P, S) int32 array into the static input, replays, and
    reads the static (P, S) ids; tokens, finish ticks and stats equal the
    eager tick's."""
    from repro_torch.serving.engine import _TickGraph
    _, tcfg, _, tp = setup
    kw = dict(rate=400.0, prompt_lens=(8, 12, 16), max_new=5,
              vocab_size=tcfg.vocab_size, seed=4)
    engines = []
    for staged in (False, True):
        eng = ContinuousBatchingEngine(tcfg, tp, options=EngineOptions(
            cache_len=32, slots_per_path=2, route_fn=prefix_hash_router(2)))
        eng.warmup()
        if staged:
            sa = eng._stacked_arenas
            inp = torch.full((3, sa.num_paths, sa.num_slots), -1,
                             dtype=torch.int32)
            ids = torch.zeros((sa.num_paths, sa.num_slots),
                              dtype=torch.long)
            eng._graph = _TickGraph(
                _ReplayBody(lambda e=eng, i=inp, o=ids:
                            o.copy_(e._dense_body(i))), inp, ids)
        engines.append((eng, _serve(eng, poisson_trace(10, **kw))))
    (eager, want), (staged, got) = engines
    _assert_same(want, got)
    assert _stats(staged) == _stats(eager)
    assert staged.decode_stats["graph_replays"] == \
        staged.decode_stats["dense"] == eager.decode_stats["dense"] > 0


# ---------------------------------------------------------------------------
# the masked decode and the path-stacked step
# ---------------------------------------------------------------------------
def _random_caches(cfg, paths, slots, cache_len, seed):
    """A (reps, P, S, ...) cache tree of random values (int8 leaves too)."""
    g = torch.Generator().manual_seed(seed)
    one = tapi.init_serve_cache(cfg, slots, cache_len, device="cpu")

    def fill(a):
        shape = (a.shape[0], paths, *a.shape[1:])
        if a.dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=g).to(a.dtype)
    return tree_map(fill, one)


_DECODE_CASES = [("dipaco-150m", {}), ("dipaco-150m", {"kv_quant": True}),
                 ("dipaco-150m", {"attn_impl": "pallas", "qk_norm": True}),
                 ("dipaco-150m", {"attn_impl": "pallas", "kv_quant": True}),
                 ("mamba2-1.3b", {}), ("qwen2-moe-a2.7b", {})]


@pytest.mark.parametrize("arch,kw", _DECODE_CASES,
                         ids=[f"{a}-{'-'.join(k) or 'plain'}"
                              for a, k in _DECODE_CASES])
def test_masked_decode_and_path_stacked_step(arch, kw):
    """``decode_step(mask=)`` leaves a False row's K, V, int8 scales and
    Mamba conv / SSM state bit for bit as they were and writes the True
    rows; ``decode_step_paths`` gives the same logits and cache bits as
    one masked ``decode_step`` per path on views of the stack."""
    cfg = tsmoke(arch).replace(**kw)
    n_paths, slots, cache_len = 3, 4, 24
    paths = [tapi.init_model(cfg, seed=p, device="cpu")
             for p in range(n_paths)]
    stacked = lm.stack_paths(paths)
    caches = _random_caches(cfg, n_paths, slots, cache_len, seed=1)
    looped = tree_map(torch.clone, caches)
    before = tree_map(torch.clone, caches)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab_size, (n_paths, slots, 1), generator=g)
    idx = torch.randint(0, 2 * cache_len, (n_paths, slots),
                        generator=g).int()
    mask = torch.tensor([[True, False, True, False], [False] * 4,
                         [True] * 4])
    logits, _ = lm.decode_step_paths(stacked, cfg, tok, caches, idx, mask)
    assert logits.shape == (n_paths, slots, 1, cfg.vocab_size)
    for p in range(n_paths):
        view = lm.path_view(stacked, p)
        lp, _ = tapi.serve_step(view, cfg, {"tokens": tok[p]},
                                tree_map(lambda a, p=p: a[:, p], looped),
                                idx[p], mask=mask[p])
        assert torch.equal(lp, logits[p])
    for a, b, old in zip(tree_leaves(caches), tree_leaves(looped),
                         tree_leaves(before)):
        assert torch.equal(a, b)
        assert torch.equal(a[:, ~mask], old[:, ~mask])
        assert not torch.equal(a[:, mask], old[:, mask])
    # the views share the stack's storage: no second copy of the weights
    view = lm.path_view(stacked, 1)
    for a, s in zip(tree_leaves(view), tree_leaves(stacked)):
        assert a.untyped_storage().data_ptr() == \
            s.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# arenas and the scheduler copy
# ---------------------------------------------------------------------------
def test_slot_arenas_write_named_rows_only():
    """``write_slots`` copies the given rows in place and nothing else;
    each layer of the stacked arena is contiguous, one island's rows
    are a view of it."""
    cfg = tsmoke("dipaco-150m").replace(kv_quant=True)
    arena = SlotArena(cfg, num_slots=4, cache_len=16, device="cpu")
    stack = StackedSlotArenas(cfg, 3, 4, 16, device="cpu")
    sub = tree_map(lambda a: (torch.arange(a.numel()).reshape(a.shape) % 100
                              + 1).to(a.dtype),
                   tapi.init_serve_cache(cfg, 3, 16, device="cpu"))
    ptrs = [a.data_ptr() for a in tree_leaves(arena.cache)]
    arena.write_slots(sub, [3, 1], [5, 7])
    stack.arenas[2].write_slots(sub, [0, 2], [4, 6])
    assert [a.data_ptr() for a in tree_leaves(arena.cache)] == ptrs
    assert list(arena.positions) == [0, 7, 0, 5]
    assert stack.positions[2].tolist() == [4, 0, 6, 0]
    for a, st, s in zip(tree_leaves(arena.cache), tree_leaves(stack.cache),
                        tree_leaves(sub)):
        assert torch.equal(a[:, 3], s[:, 0]) and torch.equal(a[:, 1], s[:, 1])
        assert not a[:, [0, 2]].any()
        assert torch.equal(st[:, 2, [0, 2]], s[:, :2])
        assert not st[:, :2].any() and not st[:, 2, [1, 3]].any()
        assert all(st[layer].is_contiguous() for layer in range(st.shape[0]))
    view = stack.arenas[2].cache
    for v, st in zip(tree_leaves(view), tree_leaves(stack.cache)):
        assert v.data_ptr() == st[:, 2].data_ptr()
    slots = [arena.alloc() for _ in range(4)]
    assert arena.try_alloc() is None
    with pytest.raises(SlotExhausted):
        arena.alloc()
    arena.free(slots[1])
    with pytest.raises(ValueError):
        arena.free(slots[1])


@pytest.mark.parametrize("seed", [0, 7])
def test_scheduler_copy_matches_reference(seed):
    """``poisson_trace`` and ``Scheduler`` of the copy against the
    original on the same seeds: the same requests, and the same
    admissions, backpressure and requeues tick by tick."""
    corpus = SyntheticCorpus(vocab_size=64, num_domains=2, seq_len=8,
                             seed=seed)
    for kw in (dict(prompt_lens=(8, 12, 16)),
               dict(prompt_lens=(16, 24), corpus=corpus,
                    priorities=((PRIO_HIGH, PRIO_STANDARD,
                                 PRIO_PREEMPTIBLE), (0.2, 0.5, 0.3)))):
        a = poisson_trace(24, rate=50.0, max_new=4, vocab_size=64,
                          seed=seed, **kw)
        b = jtrace(24, rate=50.0, max_new=4, vocab_size=64, seed=seed, **kw)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert (x.rid, x.max_new, x.arrival, x.priority, x.path) == \
                (y.rid, y.max_new, y.arrival, y.priority, y.path)
            np.testing.assert_array_equal(x.prompt, y.prompt)
        route, jroute = prefix_hash_router(3), jhash(3)
        assert [route(r.prompt) for r in a] == [jroute(r.prompt) for r in b]
        mine, theirs = Scheduler(3), JScheduler(3)
        rng = np.random.default_rng(seed)
        for i in range(0, 24, 4):
            for r, s in zip(a[i:i + 4], b[i:i + 4]):
                mine.submit(r)
                theirs.submit(s)
            mine.route_arrivals(route)
            theirs.route_arrivals(jroute)
            free = {p: int(rng.integers(0, 3)) for p in range(3)}
            got, want = mine.admissions(free), theirs.admissions(free)
            assert {p: [r.rid for r in v] for p, v in got.items()} == \
                {p: [r.rid for r in v] for p, v in want.items()}
            if got:
                p, batch = next(iter(got.items()))
                mine.requeue(batch[0], p)
                theirs.requeue(want[p][0], p)
            assert [mine.queued(p, c) for p in range(3) for c in range(3)] \
                == [theirs.queued(p, c) for p in range(3) for c in range(3)]
        mine.drain_backpressure()
        theirs.drain_backpressure()
        assert dataclasses.asdict(mine.stats) == \
            dataclasses.asdict(theirs.stats)


def test_engine_options_match_reference_validation():
    """The same bad options raise the same errors; loose keyword
    arguments raise TypeError; a CUDA graph needs a card and a warmup."""
    bad = [dict(swap_policy="eager"), dict(cache_len=0),
           dict(slots_per_path=0), dict(reroute_every=-1),
           dict(prefill_buckets=(8, 600)), dict(prefix_cache=-1)]
    for kw in bad:
        with pytest.raises(ValueError):
            JOptions(**kw)
        with pytest.raises(ValueError):
            EngineOptions(**kw)
    cfg = tsmoke("dipaco-150m")
    paths = [tapi.init_model(cfg, seed=0, device="cpu")]
    with pytest.raises(TypeError, match="unexpected keyword argument"):
        ContinuousBatchingEngine(cfg, paths, cache_len=32)
    with pytest.raises(ValueError, match="CUDA device"):
        ContinuousBatchingEngine(cfg, paths, options=EngineOptions(
            cache_len=32, cuda_graph=True))
    # an engine set to replay its tick from a graph never ticks before
    # warmup() has captured it
    eng = ContinuousBatchingEngine(cfg, paths,
                                   options=EngineOptions(cache_len=32))
    eng.cuda_graph = True
    with pytest.raises(RuntimeError, match="warmup"):
        eng.step()


def test_serve_launcher_continuous_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--engine", "continuous", "--paths", "2",
          "--requests", "6", "--prompt-len", "10", "--max-new", "4",
          "--slots", "2", "--rate", "200"])
    out = capsys.readouterr().out
    assert "24 tokens" in out and "on cpu" in out
    assert "p50 latency" in out and "p50 ttft" in out
    assert "request->path" in out
