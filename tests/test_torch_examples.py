"""The port's five examples (``repro_torch.examples``) against the
repository's scripts (``examples/``) and the JAX package, on the CPU at
a tiny size.

* Each example prints its script's stage lines, in their order, and
  takes its script's flags (and ``--device``).
* ``train_dipaco``'s pipeline at the ``mini`` widths, cut to 128
  documents and 4 phases of tau 2, from the same weights, k-means seeds
  and router weights as the script's steps through the JAX package: the
  shard sizes before and after the discriminative re-shard, every
  phase's mean loss, the running minimum of the holdout losses, each
  worker's best phase and the ``best=True`` validation NLL.
* Workers that share a module hold it bit for bit after every outer
  step (DiLoCo, a 2x2 DiPaCo) and after every step of the synchronous
  trainer, in both packages: what ``chip_smoke.py`` phase 12 asserts on
  the card.
* A re-shard that leaves a shard empty raises in both packages, with
  the same message.
"""
import argparse
import importlib.util
import runpy
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import dipaco as jdipaco
from repro.core.routing import kmeans as jkmeans
from repro.core.routing import (prefix_features as jprefix_features,
                                score_documents as jscore_documents,
                                train_discriminative_router as jtrain_router)
from repro.data import SyntheticCorpus as JCorpus
from repro.data import shard_documents as jshard_documents
from repro.data.loader import ShardLoader as JShardLoader
from repro.models import api as japi
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.core import dipaco, pytree
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.examples import (multiarch_smoke, quickstart, serve_paths,
                                  train_and_serve, train_dipaco)
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree, param_axes
from repro_torch.training import make_trainer

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"quickstart": quickstart, "train_dipaco": train_dipaco,
           "serve_paths": serve_paths, "train_and_serve": train_and_serve,
           "multiarch_smoke": multiarch_smoke}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name: str) -> str:
    return (ROOT / "examples" / f"{name}.py").read_text()


# ---------------------------------------------------------------------------
# stages and flags
# ---------------------------------------------------------------------------
# fragments of each script's printed lines, in the order it prints them
STAGES = {
    "quickstart": ["== 1. coarse routing", "shard sizes:",
                   "== 2. offline pre-sharding", "== 3. DiPaCo 2x2 training",
                   ": mean loss", "== 4. routed evaluation",
                   "validation PPL:"],
    "train_dipaco": ["[init]", "[route] k-means coarse routing",
                     "[route] shard sizes:", "[phase", "[phase",
                     "[reshard] discriminative EM step",
                     "[reshard] new shard sizes:", "[phase", "[phase",
                     "[eval] routed validation", "[done] val ppl"],
    "serve_paths": ["== train 4 paths quickly",
                    "== fit a discriminative router",
                    "== serve a batch of requests", "routed to paths:",
                    "first continuation:", "== re-route every 8 tokens",
                    "path switches during generation:",
                    "== continuous batching", "requests in",
                    "admitted="],
    "train_and_serve": ["== training service",
                        "== deployment registry + canary-gated publisher",
                        "== engine serving from the registry",
                        "requests over versions", "p50 latency",
                        "publisher: published=", "== operator rollback",
                        "rolled back to"],
    "multiarch_smoke": [f"{a:24s} loss" for a in ASSIGNED_ARCHS],
}


def _tiny_run(name: str, tmp_path):
    if name == "quickstart":
        return quickstart.run(device="cpu", docs=64, val_docs=16, phases=2,
                              tau=1)
    if name == "train_dipaco":
        return train_dipaco.main(["--preset", "mini", "--docs", "64",
                                  "--phases", "4", "--tau", "1",
                                  "--batch-size", "2", "--ckpt",
                                  str(tmp_path / "ckpt"), "--device", "cpu"])
    if name == "serve_paths":
        return serve_paths.run(device="cpu", docs=64, phases=1, tau=1,
                               router_docs=16, router_steps=5, requests=2,
                               trace_requests=3)
    if name == "train_and_serve":
        return train_and_serve.run(device="cpu", phases=1, docs=32,
                                   trace_requests=3, tmp_dir=str(tmp_path))
    return multiarch_smoke.run(device="cpu", steps=2, docs=8)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_example_prints_script_stages_in_order(name, tmp_path, capsys):
    script = _script(name)
    if name == "multiarch_smoke":
        assert "ASSIGNED_ARCHS" in script and ":24s} loss" in script
    else:
        assert all(tag in script for tag in STAGES[name])
    _tiny_run(name, tmp_path)
    printed, pos = capsys.readouterr().out, 0
    for tag in STAGES[name]:
        at = printed.find(tag, pos)
        assert at >= 0, (tag, printed[pos:])
        pos = at + len(tag)


def _reference_parser(name: str, monkeypatch) -> argparse.ArgumentParser:
    """The script's own parser, caught as its ``main`` parses."""
    caught = {}

    class Caught(Exception):
        pass

    def parse_args(self, *args, **kwargs):
        caught["parser"] = self
        raise Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    main = runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["main"]
    with pytest.raises(Caught):
        main()
    return caught["parser"]


def _options(ap) -> dict:
    return {a.option_strings[-1]: a for a in ap._actions
            if a.option_strings and a.option_strings[-1] != "--help"}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_example_takes_script_flags_and_device(name, monkeypatch):
    mine = _options(MODULES[name].parser())
    assert mine.pop("--device").default == "cuda"
    if "argparse" not in _script(name):
        assert mine == {}
        return
    theirs = _options(_reference_parser(name, monkeypatch))
    assert mine.keys() == theirs.keys()
    for flag, a in theirs.items():
        b = mine[flag]
        assert (b.type, b.choices) == (a.type, a.choices), flag
        if flag != "--ckpt":   # a fixed /tmp path in the script
            assert b.default == a.default, flag


# ---------------------------------------------------------------------------
# train_dipaco against the script's steps through the JAX package
# ---------------------------------------------------------------------------
DOCS, PHASES, TAU = 128, 4, 2


def _reference_train_dipaco():
    """``examples/train_dipaco.py --preset mini --docs 128 --phases 4
    --tau 2``, step for step through the JAX package (the checkpoint
    dumps left out: they change no state), recording what the port's
    ``run`` records, and the draws the port takes across."""
    cfg = jget_smoke_config("dipaco-150m").replace(route_prefix_len=8)
    P, bs = 4, 8
    corpus = JCorpus(vocab_size=cfg.vocab_size, num_domains=max(8, P),
                     seq_len=64, seed=0)
    docs, _ = corpus.sample_documents(DOCS, return_domains=True)
    router_docs = corpus.sample_documents(256, seed=7)
    val = corpus.sample_documents(256, seed=99)
    key = jax.random.PRNGKey(0)
    base, _ = japi.init_model(key, cfg)
    feats = jprefix_features(base, cfg, jnp.asarray(docs))
    cents, assign, _ = jkmeans.kmeans_fit(jax.random.PRNGKey(1), feats, P)
    ds = jshard_documents(docs, np.asarray(assign), P, holdout_frac=0.05)
    out = {"base": jax.tree_util.tree_map(np.asarray, base),
           "kmeans_init": np.array(jkmeans._plusplus_init(
               jax.random.PRNGKey(1), feats, P)),
           "router_init_w": np.array(jax.random.normal(
               jax.random.PRNGKey(2), (cfg.d_model, P)) * 0.01),
           "sizes_before": ds.sizes.tolist(), "phases": []}
    dcfg = JDiPaCoConfig(levels=(2, 2), inner_steps=TAU, early_stopping=True)
    tr = repro.make_trainer(cfg, dcfg, ds, backend="vector", key=key,
                            base_params=base, batch_size=bs, peak_lr=2e-3,
                            warmup=TAU, total_steps=PHASES * TAU)
    for ph in range(PHASES):
        m = tr.run_phase()
        out["phases"].append({"mean_loss": m.mean_loss,
                              "best_holdout": tr.best_holdout.copy()})
        if ph == PHASES // 2 - 1:
            paths = [tr.path_params(p) for p in range(P)]
            scores = jscore_documents(paths, cfg, jnp.asarray(router_docs))
            targets = np.asarray(scores.argmax(axis=1))
            rfeats = jprefix_features(base, cfg, jnp.asarray(router_docs))
            router = jtrain_router(jax.random.PRNGKey(2), rfeats, targets, P,
                                   steps=300)
            new_ds = jshard_documents(docs, np.asarray(router.assign(feats)),
                                      P, holdout_frac=0.05)
            out["sizes_after"] = new_ds.sizes.tolist()
            tr.dataset = new_ds
            tr.loaders = [JShardLoader(s, bs, seed=100 + i)
                          for i, s in enumerate(new_ds.shards)]
    vfeats = jprefix_features(base, cfg, jnp.asarray(val))
    va, _ = jkmeans.kmeans_assign(vfeats, cents)
    out["eval"] = tr.evaluate_routed(val, np.asarray(va), best=True)
    return out


def _best_phases(phases) -> list:
    """Each worker's best phase: the last at which the running minimum
    of its holdout loss fell."""
    hist = np.stack([p["best_holdout"] for p in phases])
    return [max(ph for ph in range(len(hist))
                if ph == 0 or hist[ph, w] < hist[ph - 1, w])
            for w in range(hist.shape[1])]


def test_train_dipaco_matches_reference_pipeline(tmp_path):
    theirs = _reference_train_dipaco()
    mine = train_dipaco.run(
        preset_name="mini", phases=PHASES, tau=TAU, docs=DOCS,
        ckpt=str(tmp_path / "ckpt"), device="cpu",
        base_params=from_numpy_tree(theirs["base"], device="cpu"),
        kmeans_init=torch.from_numpy(theirs["kmeans_init"]),
        router_init_w=torch.from_numpy(theirs["router_init_w"]))
    assert mine["sizes_before"] == theirs["sizes_before"]
    assert mine["sizes_after"] == theirs["sizes_after"]
    assert mine["sizes_after"] != mine["sizes_before"]
    np.testing.assert_allclose([p["mean_loss"] for p in mine["phases"]],
                               [p["mean_loss"] for p in theirs["phases"]],
                               rtol=1e-5)
    np.testing.assert_allclose(
        np.stack([p["best_holdout"] for p in mine["phases"]]),
        np.stack([p["best_holdout"] for p in theirs["phases"]]), rtol=1e-5)
    assert _best_phases(mine["phases"]) == _best_phases(theirs["phases"])
    np.testing.assert_allclose(mine["eval"]["nll"], theirs["eval"]["nll"],
                               rtol=1e-5)
    # one full dump a phase, the last equal to the workers' weights
    rows = mine["db"].rows(kind="full")
    assert [r.phase for r in rows] == list(range(PHASES))
    workers = mine["trainer"].worker_params
    back = train_dipaco.restore_dump(mine["db"], workers)
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(back),
                                                  pytree.leaves(workers)))


# ---------------------------------------------------------------------------
# modules shared by workers stay bit-equal
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


SHARING = {"diloco": (dict(levels=(1,)), "uniform", False),
           "2x2": (dict(levels=(2, 2)), "domains", False),
           "sync": (dict(levels=(2, 2)), "domains", True)}


@pytest.mark.parametrize("kind", sorted(SHARING))
def test_shared_modules_stay_bit_equal_in_both_packages(kind, chip_smoke):
    """After every outer step workers through one module hold it bit for
    bit, in the port and in the JAX trainer, from the same weights, whose
    phase losses agree.  The synchronous trainer (§4.5) mixes gradients:
    the port's mixed gradients are the same bits for such workers at
    every step.  AdamW clips each worker's mixed gradient by its own
    global norm; its first step (lr g / |g| elementwise) does not see
    that scale, so the shared modules are still equal after it, and they
    part from the second step on, in both packages alike."""
    levels, shards, sync = SHARING[kind]
    cfg = get_smoke_config("dipaco-150m").replace(route_prefix_len=8)
    jcfg = jget_smoke_config("dipaco-150m").replace(route_prefix_len=8)
    docs, doms = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                                 seq_len=32, seed=0).sample_documents(
        64, return_domains=True)
    assign = np.arange(len(docs)) % 4 if shards == "uniform" else doms % 4
    base, _ = japi.init_model(jax.random.PRNGKey(0), jcfg)
    kw = dict(batch_size=2, peak_lr=3e-3, warmup=1, total_steps=4)
    jds, tds = (f(docs, assign, 4) for f in (jshard_documents,
                                             shard_documents))
    tbase = from_numpy_tree(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    if sync:
        jt = jdipaco.SyncDiPaCoTrainer(jcfg, JDiPaCoConfig(**levels), jds,
                                       key=jax.random.PRNGKey(0),
                                       base_params=base, **kw)
        tt = dipaco.SyncDiPaCoTrainer(cfg, DiPaCoConfig(**levels), tds,
                                      base_params=tbase, device="cpu", **kw)
        mixed = tt._step_fn = chip_smoke.MixedGradients(tt)
        steps = [1, 1]          # one inner step a phase: check each
    else:
        jt = repro.make_trainer(jcfg, JDiPaCoConfig(**levels), jds,
                                backend="vector", key=jax.random.PRNGKey(0),
                                base_params=base, **kw)
        tt = make_trainer(cfg, DiPaCoConfig(**levels), tds, backend="vector",
                          device="cpu", base_params=tbase, **kw)
        steps = [2, 2]
    axes = param_axes(cfg)
    seen = []
    for tau in steps:
        jm, tm = jt.run_phase(tau), tt.run_phase(tau)
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-5)
        seen.append({
            name: chip_smoke.sharing_mismatch(
                wp, axes, np.array(tr.mix_layers), np.array(tr.mix_shared))
            for name, tr, wp in (
                ("port", tt, tt.worker_params),
                ("reference", jt, from_numpy_tree(jax.tree_util.tree_map(
                    np.asarray, jt.worker_params), device="cpu")))})
    assert all(s["pairs"] > 0 for step in seen for s in step.values())
    if not sync:
        assert all(s["differ"] == 0 for step in seen
                   for s in step.values()), seen
        return
    assert all(g["pairs"] > 0 and g["differ"] == 0 for g in mixed.grads)
    assert mixed.params == [s["port"] for s in seen]
    first, second = seen
    assert first["port"]["differ"] == first["reference"]["differ"] == 0
    assert len(set(mixed.clip_scales[1])) > 1
    mine, theirs = second["port"]["differ"], second["reference"]["differ"]
    assert theirs > 0 and abs(mine - theirs) <= 1e-2 * theirs, second


# ---------------------------------------------------------------------------
# a re-shard that starves a shard
# ---------------------------------------------------------------------------
def test_reshard_to_an_empty_shard_raises_in_both_packages():
    """Both packages refuse a shard with no document when its loader is
    built, with the same message: the reference by an ``assert``
    (``AssertionError``, gone under ``python -O``), the port by a check
    that raises ``ValueError``.  The port's re-shard raises before it
    touches the trainer."""
    docs = np.arange(40 * 8, dtype=np.int32).reshape(40, 8)
    assign = np.arange(40) % 3          # shard 3 gets no document
    with pytest.raises(AssertionError) as theirs:
        new_ds = jshard_documents(docs, assign, 4, holdout_frac=0.05)
        [JShardLoader(s, 8, seed=100 + i) for i, s in enumerate(new_ds.shards)]
    tr = types.SimpleNamespace(dataset="old", loaders="old")
    with pytest.raises(ValueError) as mine:
        train_dipaco.swap_shards(tr, docs, assign, 4, 8)
    assert str(mine.value) == str(theirs.value) == "empty shard"
    assert (tr.dataset, tr.loaders) == ("old", "old")
