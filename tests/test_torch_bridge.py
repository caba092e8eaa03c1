"""The port's scaffold against the JAX package: configs, the parameter
bridge, the corpus copy, the import rule and the device rule."""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_fragments
from repro import configs as jcfgs
from repro.data import SyntheticCorpus as JCorpus
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.data import SyntheticCorpus as TCorpus
from repro_torch.models import api as tapi
from repro_torch.models.params import from_numpy_tree, to_numpy_tree

ROOT = Path(__file__).resolve().parents[1]

# JAX starts its CPU backend on a process's first array op (about 0.25 s)
# and compiles each op again for each new shape (10-20 ms each, three
# times that on a loaded machine). Collection imports this module in every
# pytest process, so that start and the compiles of test_fragments.py's
# input trees are paid here, once, and not inside the first example of its
# hypothesis tests, which have hypothesis's 200 ms deadline. The code
# those tests check compiles nothing here: only their inputs are made.
test_fragments._tree()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("name", tcfgs.ALL_CONFIGS)
@pytest.mark.parametrize("kind", ["config", "smoke"])
def test_config_asdict_matches_reference(name, kind):
    getter = "get_config" if kind == "config" else "get_smoke_config"
    mine = getattr(tcfgs, getter)(name)
    theirs = getattr(jcfgs, getter)(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_unported_arch_raises_keyerror():
    """The port declares every config of the reference, in its order;
    any other name raises ``KeyError`` from both getters."""
    assert tcfgs.ALL_CONFIGS == jcfgs.ALL_CONFIGS
    for getter in (tcfgs.get_config, tcfgs.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch"):
            getter("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_roundtrip_is_bit_exact(dtype):
    cfg = jcfgs.get_smoke_config("dipaco-150m").replace(dtype=dtype)
    tree = _np_tree(japi.init_model(jax.random.PRNGKey(0), cfg)[0])
    back = to_numpy_tree(from_numpy_tree(tree, device="cpu"))
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_model_has_reference_tree(dtype):
    cfg = tcfgs.get_smoke_config("dipaco-150m").replace(dtype=dtype,
                                                        qk_norm=True)
    mine = to_numpy_tree(tapi.init_model(cfg, seed=0, device="cpu"))
    theirs = _np_tree(japi.init_model(
        jax.random.PRNGKey(0),
        jcfgs.get_smoke_config("dipaco-150m").replace(dtype=dtype,
                                                      qk_norm=True))[0])
    a, b = _flat(mine), _flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
        # same scales: the std of each random leaf within 10%
        if b[k].size > 1000:
            ratio = a[k].astype(np.float32).std() / \
                b[k].astype(np.float32).std()
            assert 0.9 < ratio < 1.1, (k, ratio)


@pytest.mark.parametrize("vocab,seed", [(512, 0), (32000, 3)])
def test_corpus_copy_matches_reference(vocab, seed):
    mine = TCorpus(vocab_size=vocab, num_domains=4, seq_len=48, seed=seed)
    theirs = JCorpus(vocab_size=vocab, num_domains=4, seq_len=48, seed=seed)
    a, da = mine.sample_documents(16, return_domains=True)
    b, db = theirs.sample_documents(16, return_domains=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(da, db)
    np.testing.assert_array_equal(mine.sample_documents(5, seed=9),
                                  theirs.sample_documents(5, seed=9))
    assert mine.oracle_nll() == theirs.oracle_nll()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.mark.parametrize("entry", [
    "init_model", "from_numpy_tree", "init_serve_cache", "serve_main",
    "serve_continuous_main", "make_trainer", "train_main"])
def test_default_device_without_card_raises(entry):
    _no_card()
    cfg = tcfgs.get_smoke_config("dipaco-150m")
    from repro_torch.data import shard_documents
    from repro_torch.models.config import DiPaCoConfig
    ds = shard_documents(np.zeros((8, 16), np.int32), np.arange(8) % 4, 4)
    calls = {
        "init_model": lambda: tapi.init_model(cfg),
        "from_numpy_tree": lambda: from_numpy_tree(
            {"w": np.zeros(3, np.float32)}),
        "init_serve_cache": lambda: tapi.init_serve_cache(cfg, 1, 8),
        "serve_main": lambda: __import__(
            "repro_torch.launch.serve", fromlist=["main"]).main([]),
        "serve_continuous_main": lambda: __import__(
            "repro_torch.launch.serve", fromlist=["main"]).main(
                ["--engine", "continuous"]),
        "make_trainer": lambda: __import__(
            "repro_torch", fromlist=["make_trainer"]).make_trainer(
                cfg, DiPaCoConfig(), ds),
        "train_main": lambda: __import__(
            "repro_torch.launch.train", fromlist=["main"]).main(["--smoke"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never computes on the CPU: only ``ops`` sends a
    CPU tensor to the plain version."""
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_dkv, flash_attention_dq, flash_attention_lse)
    from repro_torch.kernels.router_assign import router_assign
    q = torch.zeros(1, 4, 2, 32)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q[:, 0], q, q, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_lse(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dkv(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        router_assign(q[0, 0], q[0, 0])
    kernels = (flash_attention, flash_decode, flash_attention_lse,
               flash_attention_dkv, flash_attention_dq, router_assign)
    assert all(k.launches == 0 for k in kernels)


def test_ops_reject_other_devices():
    """A tensor on neither the CPU nor a card (an XPU stand-in: this
    build can make no such tensor) has no kernel; a meta tensor, the
    dry-run's, takes the plain version's shapes."""
    from repro_torch.kernels import ops

    class OnXpu:
        device = torch.device("xpu")
        requires_grad = False

    meta = torch.zeros(1, 4, 2, 32, device="meta")
    assert ops.flash_attention(meta, meta, meta).device.type == "meta"
    q = OnXpu()
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention_trainable(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.router_assign(q, q)
