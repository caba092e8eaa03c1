"""The port's mesh half of ``launch/steps.py``, ``launch/mesh.py`` and
``MeshTransport`` on the CPU, case by case against
``tests/test_mesh_steps.py`` and the JAX package.

* The streaming mesh phase in a world of one (the reference's (1, 1)
  mesh) is bit-exact to the port's single-process oracle, and near the
  JAX ``make_streaming_mesh_phase`` on the same f32 weights
  (``from_numpy_tree``): losses within 1e-5, and every element within
  1e-5 but for the few that ``assert_near_reference`` explains, for
  fp32, int8 and int4 wires at W 4, K 2, tau 4, and for K 1 at tau 3.
* ``MeshTransport`` decodes the reference's bits; the service over it
  equals the in-process transport bit for bit and resumes; drops and
  corruptions through ``RetryingTransport`` (``tests/test_fleet.py``).
* The reference's lock and checkpoint-schema passes find nothing in
  ``src/repro_torch``.
"""
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diloco as jdiloco
from repro.core import fragments as jfrag
from repro.core.dipaco import stack_tree as jstack_tree
from repro.infra import transport as jtransport
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw_init as jadamw_init
from repro_torch.core import pytree
from repro_torch.core.fragments import fake_quantize, quantize_with_feedback
from repro_torch.data import sharder
from repro_torch.infra import (FaultInjector, InProcessTransport,
                               MeshTransport, RetryingTransport, RetryPolicy,
                               TrainingService, TransportError,
                               make_transport)
from repro_torch.launch.mesh import (make_worker_mesh, num_workers,
                                     world_backend, worker_axes)
from repro_torch.launch.steps import worker_rows
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree
from test_torch_mesh_worlds import (assert_bitexact, case_inputs,
                                    run_mesh_phase, run_oracle, smoke_cfg)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base_np(tiny_base):
    return jax.tree_util.tree_map(np.asarray, tiny_base[0])


# ---------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------

def test_make_worker_mesh_divides_workers():
    for W in (1, 3, 4, 8):
        mesh = make_worker_mesh(W, device="cpu")
        assert mesh.shape["model"] == 1 and mesh.backend == "gloo"
        assert W % num_workers(mesh) == 0      # rows shard cleanly
        assert worker_axes(mesh) == ("data",)
        assert list(mesh.rows) == list(range(W))   # a world of one
        assert worker_rows(mesh) == slice(0, W)
    # a second mesh joins the world the first one made
    assert make_worker_mesh(4, device="cpu").world == 1
    # NCCL only where every rank has a card of its own
    assert world_backend("cpu", 1) == "gloo"
    assert world_backend("cuda", torch.cuda.device_count() + 1) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_worker_mesh(4)


# ---------------------------------------------------------------------
# the mesh phase in a world of one: the port's oracle and the reference
# ---------------------------------------------------------------------

def _reference_phase(tiny_cfg, base_np, inp, *, W, K, comm_dtype):
    """The JAX mesh phase on the same weights, tokens and rates."""
    jcfg = tiny_cfg.replace(attn_impl="chunked")
    base = jax.tree_util.tree_map(jnp.asarray, base_np)
    _, axes = japi.init_model(jax.random.PRNGKey(0), jcfg)
    worker = jstack_tree(base, W)
    glob = jstack_tree(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), base), W)
    spec = jfrag.FragmentSpec(glob, K)
    states = jdiloco.fragment_state_init(glob, spec)
    phase = jsteps.make_streaming_mesh_phase(
        jcfg, jmesh.make_worker_mesh(W), axes, spec, comm_dtype=comm_dtype)
    bounds = jfrag.segment_bounds(len(inp["lrs"]), K)
    tok, lrs = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lrs"])
    wp, _, gp, st, res, losses = phase(
        worker, jax.vmap(jadamw_init)(worker), glob, states, {},
        jnp.asarray(inp["mixl"].numpy()), jnp.asarray(inp["mixs"].numpy()),
        [tok[bounds[s]:bounds[s + 1]] for s in range(K)],
        [lrs[bounds[s]:bounds[s + 1]] for s in range(K)])
    return (wp, gp, st, res), np.asarray(losses)


def assert_near_reference(mine, theirs, comm_dtype):
    """Every element within 1e-5 of the reference's, but for a few (at
    most 1e-3 of a leaf, or 16), each within one wire step.

    Where an element's first gradient is within a few eps (1e-8) of 0,
    AdamW's step m / (sqrt(v) + eps) turns the two packages' f32
    summation orders (gradients 1e-8 apart) into steps up to 4e-5 apart
    (measured in fp32: 12 of 524288 elements of ``w_down`` past 1e-5,
    none past 7.3e-5).  On a quantized wire such a delta, or one on a
    rounding tie (XLA's fused f32 operations round a scale differently
    from eager ones), lands a quantization step away, and the mixing
    carries it to every worker row of its module (measured: at most
    4.3e-4 of a leaf past 1e-5 with int8, none past 6.9e-5; with int4,
    whose step is larger, none past 4.4e-4)."""
    bound = {"fp32": 1e-4, "int8": 1e-4, "int4": 1e-3}[comm_dtype]
    a = pytree.leaves(mine)
    b = jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.shape == y.shape
        d = np.abs(x.numpy() - y)
        assert (d > 1e-5).sum() <= max(16, 1e-3 * d.size)
        assert d.max() <= bound


@pytest.mark.parametrize("comm_dtype,K,tau", [
    ("fp32", 2, 4), ("int8", 2, 4), ("int4", 2, 4), ("fp32", 1, 3)])
def test_mesh_phase_world_of_one(tiny_cfg, base_np, comm_dtype, K, tau):
    """Bit-exact to the port's oracle (worker params, global params,
    Nesterov fragment states, residuals), and near the reference's mesh
    phase.  K = 1 is burst DiLoCo through the same code path."""
    cfg, W = smoke_cfg(), 4
    inp = case_inputs(cfg, W=W, K=K, tau=tau,
                      base=from_numpy_tree(base_np, device="cpu"))
    oracle = run_oracle(cfg, inp, comm_dtype)
    *meshed, losses = run_mesh_phase(cfg, inp, comm_dtype,
                                     make_worker_mesh(W, device="cpu"))
    for a, b in zip(oracle, meshed):
        assert_bitexact(a, b)
    assert losses.shape == (tau, W) and torch.isfinite(losses).all()
    theirs, jlosses = _reference_phase(tiny_cfg, base_np, inp, W=W, K=K,
                                       comm_dtype=comm_dtype)
    np.testing.assert_allclose(losses.numpy(), jlosses, atol=1e-5, rtol=0)
    for a, b in zip(meshed[:2], theirs[:2]):
        assert_near_reference(a, b, comm_dtype)
    for f in range(K):
        assert sorted(meshed[2][f]) == sorted(theirs[2][f])
    assert_near_reference([meshed[2][f][i] for f in range(K)
                           for i in sorted(meshed[2][f])],
                          [theirs[2][f][i] for f in range(K)
                           for i in sorted(theirs[2][f])], comm_dtype)
    assert sorted(meshed[3]) == sorted(theirs[3])
    assert_near_reference([meshed[3][i] for i in sorted(meshed[3])],
                          [theirs[3][i] for i in sorted(theirs[3])],
                          comm_dtype)


# ---------------------------------------------------------------------
# MeshTransport
# ---------------------------------------------------------------------

def _delta():
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    return {"a": x, "b": np.float32([0.5, -2.0, 0.0])}


@pytest.mark.parametrize("comm_dtype", ["int8", "int4", "fp32"])
def test_mesh_transport_ships_reference_bits(comm_dtype):
    d = _delta()
    wire, _, payload = quantize_with_feedback(
        pytree.tree_map(torch.from_numpy, d), None, comm_dtype,
        return_payload=True)
    t = make_transport("mesh", comm_dtype=comm_dtype, devices=[CPU])
    assert isinstance(t, MeshTransport) and t.exec_device == CPU
    out = t.ship(0, wire, payload)
    assert_bitexact(out, wire)             # decode(encode) == the wire
    assert t.stats == {"sends": 1, "payload_bytes": t.stats["payload_bytes"],
                       "device_hops": 0}
    jwire, _, jpayload = jfrag.quantize_with_feedback(
        jax.tree_util.tree_map(jnp.asarray, d), None, comm_dtype,
        return_payload=True)
    jt = jtransport.make_transport("mesh", comm_dtype=comm_dtype)
    jout = jt.ship(0, jwire, jpayload)
    for x, y in zip(pytree.leaves(out), jax.tree_util.tree_leaves(jout)):
        assert x.numpy().tobytes() == np.asarray(y).tobytes()
    assert t.stats["payload_bytes"] == jt.stats["payload_bytes"] > 0
    # two devices: a shard's home is round-robin, a hop is counted
    t2 = MeshTransport(comm_dtype, devices=[CPU, CPU])
    assert t2.worker_device(3) == CPU
    tin = make_transport("inproc")
    assert isinstance(tin, InProcessTransport)
    assert tin.ship(2, wire, payload) is wire


def test_service_mesh_transport_bitexact_and_resume(tiny_docs, base_np):
    """The service over ``MeshTransport`` equals the in-process transport
    bit for bit, records measured payload bytes, and a killed run resumes
    bit-exactly (replay bypasses the transport)."""
    cfg = smoke_cfg()
    docs, doms = tiny_docs
    ds = sharder.shard_documents(docs, doms % 4, 4)

    def kw():
        return dict(base_params=from_numpy_tree(base_np, device="cpu"),
                    batch_size=4, peak_lr=1e-3, warmup=10, total_steps=100,
                    num_workers=1, device="cpu", phase_timeout=60.0)

    def mk(transport):
        return DiPaCoConfig(levels=(2, 2), inner_steps=2, outer_fragments=2,
                            comm_dtype="int8", transport=transport)

    def same_paths(a, b):
        for p in range(4):
            assert_bitexact(a.path_params(p), b.path_params(p))

    services = []
    try:
        with tempfile.TemporaryDirectory() as ra, \
                tempfile.TemporaryDirectory() as rb:
            ref = TrainingService(cfg, mk("inproc"), ds, ckpt_root=ra,
                                  **kw())
            services.append(ref)
            mesh = TrainingService(cfg, mk("mesh"), ds, ckpt_root=rb, **kw())
            services.append(mesh)
            assert isinstance(mesh.transport, MeshTransport)
            for _ in range(2):
                ref.run(1, tau=2)
                m = mesh.run(1, tau=2)
            same_paths(ref, mesh)
            assert m["transport"]["sends"] > 0
            assert m["transport"]["payload_bytes"] > 0
            mesh.shutdown()                               # kill
            res = TrainingService.resume(cfg, mk("mesh"), ds, ckpt_root=rb,
                                         **kw())
            services.append(res)
            ref.run(1, tau=2)
            res.run(1, tau=2)
            same_paths(ref, res)
    finally:
        for s in services:
            s.shutdown()


def test_mesh_transport_corrupt_drop_failure_paths():
    """The mesh backend under injected drops and corruptions: the decoded
    value stays bitwise the clean quantization, corrupted copies are
    checksum-rejected and counted as retry overhead, goodput counts only
    delivered payloads, and exhaustion delivers nothing."""
    rng = np.random.default_rng(0)
    delta = {"w": torch.from_numpy(rng.standard_normal((16, 8))
                                   .astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(8)
                                   .astype(np.float32))}
    wire, _, payload = quantize_with_feedback(delta, None, "int8",
                                              return_payload=True)
    want = fake_quantize(delta, "int8")
    t = RetryingTransport(
        MeshTransport("int8", devices=[CPU]), policy=RetryPolicy(retries=16),
        injector=FaultInjector(seed=2, drop=0.25, corrupt=0.25),
        comm_dtype="int8", sleep=lambda s: None)
    n = 8
    for s in range(n):
        assert_bitexact(t.ship(s, wire, payload, phase=0), want)
    st = t.stats
    assert st["sends"] == n                     # goodput: one per report
    assert st["corruptions"] > 0 and st["drops"] > 0
    assert st["checksum_rejects"] == st["corruptions"]
    assert st["retries"] == st["corruptions"] + st["drops"]
    per_send = st["payload_bytes"] // n
    assert st["retry_bytes"] == st["corruptions"] * per_send
    t2 = RetryingTransport(
        MeshTransport("int8", devices=[CPU]), policy=RetryPolicy(retries=0),
        injector=FaultInjector(seed=0, drop=1.0), comm_dtype="int8",
        sleep=lambda s: None)
    with pytest.raises(TransportError):
        t2.ship(0, wire, payload, phase=0)
    assert t2.inner.stats["sends"] == 0


# ---------------------------------------------------------------------
# the reference's static passes over the port
# ---------------------------------------------------------------------

@pytest.mark.parametrize("check", ["locks", "ckpt_schema"])
def test_reference_static_passes_find_nothing(check):
    """The lock-discipline pass (copy-on-write reads carry the
    reference's ``# analysis: lockfree(...)`` marks) and the
    checkpoint-schema pass over ``src/repro_torch``, the mesh modules
    included."""
    import importlib
    from repro.analysis import Project
    project = Project(ROOT, dirs=("src/repro_torch",))
    assert any(m.dotted == "repro_torch.launch.mesh"
               for m in project.modules)
    findings = importlib.import_module(f"repro.analysis.{check}").run(
        project)
    assert findings == []
