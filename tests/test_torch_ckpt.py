"""The port's checkpoint DB, module store and sharded-dataset files
against the JAX package's, on the CPU: ``save_tree`` / ``load_tree``
read each other's files (f32, int8 and int32 trees, the ``treedef``
string equal to JAX's), a bf16 leaf is written with the reference's
bytes and read back, the reference's validation errors, retention GC,
pinning and restart, ``PreShardedDataset`` files across packages, and
``ModuleStore`` against the reference."""
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import fragments as jfrag
from repro.core.module_store import ModuleStore as JStore
from repro.core.partition import make_partition as jmake_partition
from repro.data import sharder as jsharder
from repro.infra import ckpt_db as jdb
from repro.models import api as japi
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke_config
from repro_torch.core import fragments as tfrag
from repro_torch.core import pytree
from repro_torch.core.module_store import ModuleStore
from repro_torch.core.partition import make_partition
from repro_torch.data import sharder
from repro_torch.infra import ckpt_db as tdb
from repro_torch.infra.ckpt_db import CheckpointDB, load_tree, save_tree
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import param_axes
from repro_torch.optim import adamw_init


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """A JAX f32 tree (None leaves kept) as CPU tensors."""
    return pytree.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _same(mine, theirs):
    a, b = pytree.leaves(mine), jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tfrag.leaf_bytes(x) == np.asarray(y).tobytes()


@pytest.fixture(scope="module")
def base():
    cfg = jget_smoke("dipaco-150m")
    jp, axes = japi.init_model(jax.random.PRNGKey(0), cfg)
    return jp, axes


def _service_trees(jp, axes):
    """(name, JAX tree) of every kind of tree the service writes: path
    params, AdamW state with its int32 count, int8/int4 wire payloads, a
    module row with None leaves (params + momentum), a slice row keyed
    by leaf index, the flush and fleet markers."""
    store = JStore(jp, axes, jmake_partition(JDiPaCoConfig(levels=(2, 2)),
                                             jget_smoke("dipaco-150m")
                                             .pattern_repeats))
    mod = store.module_params(0, 1)
    mom = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape) + 0.5, mod)
    leaves = jax.tree_util.tree_leaves(mod)
    delta = jax.tree_util.tree_map(lambda x: x * 0.01, jp)
    return [("params", jp),
            ("opt", jax.tree_util.tree_map(lambda x: x + 1,
                                           jadamw.adamw_init(jp))),
            ("wire_int8", jfrag.encode_wire(delta, "int8")),
            ("wire_int4", jfrag.encode_wire(delta, "int4")),
            ("module", {"params": mod, "momentum": {"momentum": mom}}),
            ("slice", {"params": {0: leaves[0], 3: leaves[3]},
                       "momentum": {0: leaves[0] * 2, 3: leaves[3] * 2}}),
            ("flush", {"flushed": jnp.zeros((1,), jnp.int32)}),
            ("fleet", {"epoch": jnp.asarray([3], jnp.int32)})]


def test_trees_cross_read_both_ways(base, tmp_path):
    for name, jt in _service_trees(*base):
        tt = _t(jt)
        assert str(pytree.flatten(tt)[1]) == \
            str(jax.tree_util.tree_structure(jt)), name
        fj, ft = str(tmp_path / f"{name}_j.npz"), str(tmp_path / f"{name}_t")
        jdb.save_tree(fj, jt)
        save_tree(ft, tt)
        ft += ".npz"
        # each package reads the other's file, with the same bits
        _same(load_tree(fj, tt), jt)
        _same(tt, jdb.load_tree(ft, jt))
        # the stored treedef strings and leaves are identical
        with np.load(fj) as a, np.load(ft) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes(), (name, k)


def test_bf16_leaf_bytes_match_reference_and_read_back(tmp_path):
    x = np.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                   ml_dtypes.bfloat16)
    jt = {"w": jnp.asarray(x), "n": jnp.ones((2,), jnp.float32)}
    tt = {"w": torch.from_numpy(x.view(np.int16).copy())
          .view(torch.bfloat16), "n": torch.ones(2)}
    fj, ft = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jdb.save_tree(fj, jt)
    save_tree(ft, tt)
    with zipfile.ZipFile(fj) as a, zipfile.ZipFile(ft) as b:
        # the .npy members (header with its '|V2' descr, then the bytes)
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    for f in (fj, ft):
        back = load_tree(f, tt)
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"].view(torch.int16),
                           tt["w"].view(torch.int16))
        # a |V2 leaf goes only into a bf16 template leaf
        with pytest.raises(ValueError, match="dtype"):
            load_tree(f, {"w": torch.zeros(3, 5), "n": torch.ones(2)})
    # the reference cannot read its own bf16 rows back (ROADMAP queue 3)
    with pytest.raises(ValueError, match="V2"):
        jdb.load_tree(fj, jt)


def test_load_tree_validates_structure(tmp_path):
    """The reference's checks (tests/test_training_service.py)."""
    f = str(tmp_path / "t.npz")
    tree = {"a": torch.ones(2, 3), "b": {"c": torch.zeros(4)}}
    save_tree(f, tree)
    with pytest.raises(ValueError, match="leaves"):
        load_tree(f, {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="treedef"):
        load_tree(f, {"a": torch.ones(2, 3), "z": {"c": torch.zeros(4)}})
    with pytest.raises(ValueError, match="shape"):
        load_tree(f, {"a": torch.ones(2, 3), "b": {"c": torch.zeros(5)}})
    with pytest.raises(ValueError, match="dtype"):
        load_tree(f, {"a": torch.ones(2, 3, dtype=torch.int8),
                      "b": {"c": torch.zeros(4)}})
    back = load_tree(f, tree)
    assert torch.equal(back["a"], tree["a"])


def test_io_stats_count_rows(tmp_path):
    tdb.reset_io_stats()
    save_tree(str(tmp_path / "a.npz"), {"x": torch.ones(4)})
    load_tree(str(tmp_path / "a.npz"), {"x": torch.zeros(4)})
    st = tdb.io_stats()
    assert st["rows_written"] == 1 and st["rows_read"] == 1
    assert st["d2h_bytes"] == 0 and st["h2d_bytes"] == 0   # CPU tensors
    assert st["write_s"] >= 0 and st["read_s"] >= 0
    assert st["file_bytes"] == (tmp_path / "a.npz").stat().st_size


def _ones(n=2):
    return {"a": torch.ones(n)}


def test_ckpt_db_retention_gc(tmp_path):
    db = CheckpointDB(str(tmp_path), max_rows_per_path=2)
    files = []
    for ph in range(5):
        files.append(db.write({"a": torch.ones(2) * ph}, path_id=0,
                              phase=ph, step=ph, kind="train").file)
    rows = db.rows(kind="train", path_id=0)
    assert [r.phase for r in rows] == [3, 4]
    assert not os.path.exists(files[0]) and os.path.exists(files[-1])
    db.write(_ones(), path_id=1, phase=0, step=0, kind="train")
    assert len(db.rows(path_id=1)) == 1
    assert db.nbytes() > 0


def test_ckpt_db_gc_pins_module_rows_with_live_train_rows(tmp_path):
    db = CheckpointDB(str(tmp_path), max_rows_per_path=2)
    for ph in range(4):
        db.write(_ones(), path_id=0, phase=ph, step=ph, kind="train")
    assert [r.phase for r in db.rows(kind="train")] == [2, 3]
    for ph in range(4):
        db.write(_ones(), path_id=-1, phase=ph, step=ph + 1, kind="module",
                 level=0, expert=0, extra={"consumed": [[0, ph]]})
    assert [r.phase for r in db.rows(kind="module")] == [2, 3]
    db.write(_ones(), path_id=-1, phase=9, step=9, kind="module", level=0,
             expert=0, extra={"consumed": [[0, 9]]})
    assert [r.phase for r in db.rows(kind="module")] == [2, 3, 9]


def test_ckpt_db_gc_unpins_at_train_eviction_boundary(tmp_path):
    db = CheckpointDB(str(tmp_path), max_rows_per_path=2)
    db.write(_ones(), path_id=0, phase=0, step=0, kind="train")
    db.write(_ones(), path_id=0, phase=1, step=1, kind="train")
    files = {}
    for ph in range(3):
        files[ph] = db.write(
            _ones(), path_id=-1, phase=ph, step=ph + 1, kind="module",
            level=0, expert=0, extra={"consumed": [[0, min(ph, 1)]]}).file
    assert [r.phase for r in db.rows(kind="module")] == [0, 1, 2]
    db.write(_ones(), path_id=0, phase=2, step=2, kind="train")
    assert [r.phase for r in db.rows(kind="train")] == [1, 2]
    assert os.path.exists(files[0])
    db.write(_ones(), path_id=-1, phase=3, step=4, kind="module", level=0,
             expert=0, extra={"consumed": [[0, 2]]})
    assert [r.phase for r in db.rows(kind="module")] == [1, 2, 3]
    assert not os.path.exists(files[0])
    assert os.path.exists(files[1]) and os.path.exists(files[2])


def test_ckpt_db_pinning_and_rows_survive_restart(tmp_path):
    db = CheckpointDB(str(tmp_path), max_rows_per_path=2)
    db.write(_ones(), path_id=0, phase=0, step=0, kind="train",
             extra={"loss": 1.5})
    db.write(_ones(), path_id=0, phase=1, step=1, kind="train")
    for ph in range(3):
        db.write(_ones(), path_id=-1, phase=ph, step=ph + 1, kind="module",
                 level=0, expert=0, extra={"consumed": [[0, min(ph, 1)]]})
    db2 = CheckpointDB(str(tmp_path), max_rows_per_path=2)   # restart
    assert [r.phase for r in db2.rows(kind="module")] == [0, 1, 2]
    assert db2.rows(kind="train")[0].extra["loss"] == 1.5
    db2.write(_ones(), path_id=0, phase=2, step=2, kind="train")
    db2.write(_ones(), path_id=-1, phase=3, step=4, kind="module", level=0,
              expert=0, extra={"consumed": [[0, 2]]})
    assert [r.phase for r in db2.rows(kind="module")] == [1, 2, 3]
    # the reference reads the port's table and rows
    jdb_ = jdb.CheckpointDB(str(tmp_path))
    assert [(r.kind, r.phase) for r in jdb_.rows()] == \
        [(r.kind, r.phase) for r in db2.rows()]
    back = jdb.load_tree(jdb_.rows(kind="train")[0].file,
                         {"a": jnp.zeros(2)})
    np.testing.assert_array_equal(np.asarray(back["a"]), [1.0, 1.0])


def test_ckpt_db_listeners_and_wait_for(tmp_path):
    db = CheckpointDB(str(tmp_path))
    seen = []
    db.add_listener(lambda r: seen.append(r.kind))
    db.add_listener(lambda r: 1 / 0)          # a broken subscriber
    db.write(_ones(), path_id=1, phase=0, step=5)
    assert seen == ["train"] and db.listener_errors == 1
    assert db.wait_for(lambda r: r.path_id == 1, timeout=0.5)
    assert db.wait_for(lambda r: r.path_id == 7, timeout=0.1) == []


def test_sharded_dataset_files_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    docs = rng.integers(0, 512, (64, 16)).astype(np.int32)
    assign = np.arange(64) % 4
    tds = sharder.shard_documents(docs, assign, 4, holdout_frac=0.1)
    jds = jsharder.shard_documents(docs, assign, 4, holdout_frac=0.1)
    tds.save(str(tmp_path / "t"))
    jds.save(str(tmp_path / "j"))
    for a, b in ((jsharder.PreShardedDataset.load(str(tmp_path / "t")),
                  sharder.PreShardedDataset.load(str(tmp_path / "j"))),
                 (sharder.PreShardedDataset.load(str(tmp_path / "t")),
                  jds)):
        assert a.num_shards == b.num_shards
        assert a.holdout_frac == b.holdout_frac
        for x, y in zip(a.shards + a.holdouts, b.shards + b.holdouts):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.alphas(), b.alphas())


@pytest.mark.parametrize("shared", [True, False])
def test_module_store_matches_reference(base, shared):
    jp, axes = base
    cfg = get_smoke_config("dipaco-150m")
    dk = dict(levels=(2, 2), shared_embeddings=shared)
    js = JStore(jp, axes, jmake_partition(JDiPaCoConfig(**dk),
                                          cfg.pattern_repeats))
    ts = ModuleStore(_t(jp), param_axes(cfg),
                     make_partition(DiPaCoConfig(**dk), cfg.pattern_repeats))
    assert ts.num_params() == js.num_params()
    for p in range(4):
        _same(ts.assemble(p), js.assemble(p))
    # a module update and a shared update reach exactly the paths they
    # should, and a tree handed out before keeps its values
    before = ts.assemble(0)
    before_bytes = [tfrag.leaf_bytes(x) for x in pytree.leaves(before)]
    jnew = jax.tree_util.tree_map(lambda x: x * 2.0 + 1.0,
                                  js.module_params(1, 0))
    js.set_module(1, 0, jnew)
    ts.set_module(1, 0, _t(jnew))
    jsh = jax.tree_util.tree_map(lambda x: x - 0.5, js.shared)
    js.set_shared(jsh)
    ts.set_shared(pytree.tree_map(lambda x: x - 0.5, ts.shared))
    for p in range(4):
        _same(ts.assemble(p), js.assemble(p))
    for lv in (0, 1):
        for e in (0, 1):
            _same(ts.module_params(lv, e), js.module_params(lv, e))
    _same(ts.slice_for_level(ts.assemble(2), 1),
          js.slice_for_level(js.assemble(2), 1))
    _same(ts.shared_of(ts.assemble(3)), js.shared_of(js.assemble(3)))
    assert [tfrag.leaf_bytes(x) for x in pytree.leaves(before)] == \
        before_bytes


def test_adamw_state_and_opt_rows_round_trip(base, tmp_path):
    """The service's ``opt`` rows: the port's AdamW state written by one
    package and read with the other's template."""
    jp, _ = base
    tp = _t(jp)
    st = adamw_init(tp)
    st["count"] += 3
    f = str(tmp_path / "opt")
    save_tree(f, st)
    back = jdb.load_tree(f + ".npz", jadamw.adamw_init(jp))
    assert int(back["count"]) == 3 and np.asarray(back["count"]).dtype == \
        np.int32
    mine = load_tree(f + ".npz", adamw_init(tp))
    assert mine["count"].dtype == torch.int32 and int(mine["count"]) == 3
