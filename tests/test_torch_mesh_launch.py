"""The port's ``MeshStreamingTrainer`` and its launcher on the CPU.

* ``make_trainer(backend="mesh", device="cpu")`` over 2 phases against
  the JAX ``MeshStreamingTrainer`` from the same f32 weights (the int8
  wire, K 2), within ``test_torch_mesh.assert_near_reference``'s bound.
* Phase-state files: 2 phases, kill, resume and 1 more phase equal 3
  uninterrupted phases bit for bit in a world of one (across 2 ranks:
  ``test_torch_mesh_worlds.py``), and a file written by the JAX trainer
  resumes in the port with the reference's bits, its next phase near the
  JAX trainer's next phase.
* ``python -m repro_torch.launch.train --device cpu --smoke`` with
  ``--backend mesh`` (in this process, and under ``torchrun`` with two
  gloo ranks, which must print what the world of one prints), and with
  ``--backend service`` and the reference's fault, profile and chaos
  flags; ``_parse_profiles`` against the reference's.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import sharder as jsharder
from repro.launch import train as jtrain
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.core import pytree
from repro_torch.data import sharder
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import MeshStreamingTrainer
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.training import Trainer, make_trainer
from test_torch_mesh import assert_near_reference
from test_torch_mesh_worlds import assert_bitexact, smoke_cfg

ROOT = Path(__file__).resolve().parents[1]
DCFG = dict(levels=(2, 2), inner_steps=4, outer_fragments=2,
            comm_dtype="int8")
KW = dict(batch_size=2, peak_lr=1e-3, warmup=4, total_steps=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base_np(tiny_base):
    return jax.tree_util.tree_map(np.asarray, tiny_base[0])


def _ds(tiny_docs):
    docs, doms = tiny_docs
    return sharder.shard_documents(docs, doms % 4, 4)


def _port(tiny_docs, base_np, **over):
    return make_trainer(smoke_cfg(), DiPaCoConfig(**DCFG), _ds(tiny_docs),
                        backend="mesh", device="cpu",
                        base_params=from_numpy_tree(base_np, device="cpu"),
                        **KW, **over)


def _state(tr) -> list:
    """The trainer's six trees, as comparable leaf lists (the residuals
    and fragment states in leaf-index order)."""
    return [tr.worker_params, tr.global_params,
            [tr.opt_state["m"], tr.opt_state["v"]],
            [s[i] for s in tr.frag_states for i in sorted(s)],
            [tr.residuals[i] for i in sorted(tr.residuals)]]


@pytest.fixture(scope="module")
def reference_run(tiny_cfg, tiny_docs, base_np, tmp_path_factory):
    """The JAX trainer, 2 phases from the f32 base, writing its phase
    files: its metrics and its state after each phase."""
    docs, doms = tiny_docs
    root = str(tmp_path_factory.mktemp("mesh-ref"))
    jt = jtrain.MeshStreamingTrainer(
        tiny_cfg.replace(attn_impl="chunked"), JDiPaCoConfig(**DCFG),
        jsharder.shard_documents(docs, doms % 4, 4),
        key=jax.random.PRNGKey(0), ckpt_root=root,
        base_params=jax.tree_util.tree_map(jax.numpy.asarray, base_np), **KW)
    out = {"root": root, "metrics": [], "state": []}
    for _ in range(2):
        out["metrics"].append(jt.run_phase())
        out["state"].append(jax.tree_util.tree_map(np.asarray,
                                                   _state(jt)))
    return out


def test_mesh_trainer_matches_reference(tiny_docs, base_np, reference_run):
    tr = _port(tiny_docs, base_np)
    assert isinstance(tr, MeshStreamingTrainer) and isinstance(tr, Trainer)
    for ph in range(2):
        m = tr.run_phase()
        jm = reference_run["metrics"][ph]
        np.testing.assert_allclose(m.mean_loss, jm.mean_loss, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(m.per_path_loss, jm.per_path_loss,
                                   atol=1e-5, rtol=0)
        assert m["outer_updates"] == jm["outer_updates"] == 2
        assert m["comm"] == jm["comm"]
        for a, b in zip(_state(tr), reference_run["state"][ph]):
            assert_near_reference(a, b, "int8")


def test_mesh_trainer_resumes_reference_file(tiny_docs, base_np,
                                             reference_run):
    """The JAX trainer's phase-1 file (f32) resumes in the port with the
    reference's bits; the next phase lands near the reference's."""
    with tempfile.TemporaryDirectory() as root:
        src = Path(reference_run["root"]) / "mesh_phase_000001.npz"
        os.link(src, Path(root) / src.name)
        tr = _port(tiny_docs, base_np, ckpt_root=root, resume=True)
        assert (tr.phase, tr.step) == (1, 4)
        assert tr.comm_stats == reference_run["metrics"][0]["comm"]
        for a, b in zip(_state(tr), reference_run["state"][0]):
            for x, y in zip(pytree.leaves(a), jax.tree_util.tree_leaves(b)):
                assert x.numpy().tobytes() == np.asarray(y).tobytes()
        m = tr.run_phase()
        np.testing.assert_allclose(
            m.mean_loss, reference_run["metrics"][1].mean_loss, atol=1e-5,
            rtol=0)
        for a, b in zip(_state(tr), reference_run["state"][1]):
            assert_near_reference(a, b, "int8")
        assert (Path(root) / "mesh_phase_000002.npz").exists()


def test_mesh_trainer_resume_bitexact(tiny_docs, base_np):
    """3 uninterrupted phases == 2 phases + kill + resume + 1 phase."""
    ref = _port(tiny_docs, base_np)
    for _ in range(3):
        ref.run_phase()
    with tempfile.TemporaryDirectory() as root:
        vic = _port(tiny_docs, base_np, ckpt_root=root)
        vic.run_phase()
        vic.run_phase()
        del vic                                          # kill
        res = _port(tiny_docs, base_np, ckpt_root=root, resume=True)
        assert (res.phase, res.step) == (2, 8)
        res.run_phase()
    for a, b in zip(_state(ref), _state(res)):
        assert_bitexact(a, b)
    for p in range(4):
        assert_bitexact(ref.path_params(p), res.path_params(p))
    assert ref.comm_stats == res.comm_stats


# ---------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------

SMOKE = ["--device", "cpu", "--smoke", "--docs", "128", "--tau", "3",
         "--seq", "48"]


def test_launcher_mesh_in_a_world_of_one_and_under_torchrun(capsys):
    argv = SMOKE + ["--phases", "2", "--backend", "mesh", "--fragments",
                    "2", "--comm-dtype", "int8"]
    res = ttrain.main(argv)
    out = capsys.readouterr().out
    assert "[comm] {'peak_sync_bytes'" in out and "[done]" in out
    assert all(np.isfinite(res["phase_loss"])) and np.isfinite(res["ppl"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-3000:]
    mine = [ln for ln in run.stdout.splitlines() if ln.startswith("[")]
    # one rank prints; the losses, the comm line and the routed PPL are
    # those of the world of one (the phase lines carry their seconds)
    assert sum(ln == "[done]" for ln in mine) == 1
    strip = [ln.split(" (")[0] for ln in mine]
    want = [ln.split(" (")[0] for ln in out.splitlines()
            if ln.startswith("[")]
    assert strip == want


def test_launcher_service_with_fault_and_fleet_flags(capsys, tmp_path):
    res = ttrain.main(SMOKE + [
        "--phases", "3", "--backend", "service", "--num-workers", "2",
        "--ckpt-root", str(tmp_path), "--transport-retries", "2",
        "--fault-drop", "0.2", "--fault-seed", "3", "--profile", "0:0.5",
        "--chaos-kill-frac", "0.25", "--chaos-phase", "1"])
    out = capsys.readouterr().out
    assert "[chaos] events=[{'action': 'kill_frac'" in out
    assert "[chaos] rejoined" in out and "[final] mean_loss" in out
    assert "'drops':" in out and "[done]" in out
    assert all(np.isfinite(res["phase_loss"])) and np.isfinite(res["ppl"])


def test_parse_profiles_matches_reference():
    good = ["0:0.5", "1:0.25:2", "2:1:0.5:0.1"]
    mine, theirs = ttrain._parse_profiles(good), jtrain._parse_profiles(good)
    assert sorted(mine) == sorted(theirs) == [0, 1, 2]
    for s in mine:
        assert (mine[s].bandwidth, mine[s].compute, mine[s].preempt_rate) \
            == (theirs[s].bandwidth, theirs[s].compute,
                theirs[s].preempt_rate)
    for bad in (["3"], ["1:2:3:4:5"]):
        with pytest.raises(SystemExit, match="bad --profile"):
            ttrain._parse_profiles(bad)
        with pytest.raises(SystemExit, match="bad --profile"):
            jtrain._parse_profiles(bad)
    with pytest.raises(ValueError):
        ttrain._parse_profiles(["0:0"])          # a link needs bandwidth
