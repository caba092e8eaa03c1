"""The port's fragment layout and int8/int4 wire format against the JAX
package's ``repro.core.fragments``, on the CPU: the leaf-to-fragment
assignment, the wire payloads (``q`` and ``scale``) bit for bit, the
decoded and fake-quantized f32 bits, the crc32 checksums and the byte
and slot helpers.  Also the port's tree order (``core.pytree``) against
``jax.tree_util``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import fragments as jfrag
from repro.core.module_store import ModuleStore as JStore
from repro.core.partition import make_partition as jmake_partition
from repro.models import api as japi
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.core import fragments as tfrag
from repro_torch.core import pytree
from repro_torch.core.module_store import ModuleStore
from repro_torch.core.partition import make_partition
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree, param_axes
from repro_torch.configs import get_smoke_config

ARCHES = ("dipaco-150m", "qwen2-moe-a2.7b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x) -> bytes:
    return tfrag.leaf_bytes(x)


@pytest.fixture(scope="module")
def trees():
    """{arch: (JAX params, port params, JAX axes)} of the smoke configs."""
    out = {}
    for arch in ARCHES:
        jp, axes = japi.init_model(jax.random.PRNGKey(0), jget_smoke(arch))
        out[arch] = (jp, from_numpy_tree(_np(jp), device="cpu"), axes)
    return out


@pytest.mark.parametrize("arch", ARCHES)
def test_pytree_order_and_treedef_match_jax(trees, arch):
    jp, tp, _ = trees[arch]
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = pytree.flatten(tp)
    assert str(tdef) == str(jdef)
    assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in pytree.flatten_with_path(tp)] == jpaths
    for t in ({"b": None, "a": [1, (2,)], "c": {3: 1, 0: 2}}, {}, (1,), 5,
              {"q": 1, "scale": 2, "x": {"z": None}}):
        assert str(pytree.flatten(t)[1]) == \
            str(jax.tree_util.tree_structure(t))


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 64])
def test_fragment_spec_assignment_matches_reference(trees, arch, k):
    """The whole path tree and each module's tree (None leaves where
    the leaf is another module's) fragment the same way."""
    jp, tp, axes = trees[arch]
    cfg = get_smoke_config(arch)
    pairs = [(jp, tp)]
    jstore = JStore(jp, axes, jmake_partition(JDiPaCoConfig(levels=(2, 2)),
                                              cfg.pattern_repeats))
    tstore = ModuleStore(tp, param_axes(cfg),
                         make_partition(DiPaCoConfig(levels=(2, 2)),
                                        cfg.pattern_repeats))
    pairs.append((jstore.module_params(1, 0), tstore.module_params(1, 0)))
    pairs.append((jstore.shared, tstore.shared))
    for jt, tt in pairs:
        js, ts = jfrag.FragmentSpec(jt, k), tfrag.FragmentSpec(tt, k)
        assert ts.num_fragments == js.num_fragments
        np.testing.assert_array_equal(ts.assign, js.assign)
        assert ts.indices == js.indices and ts.elems == js.elems
        for dt in tfrag.COMM_DTYPES:
            assert ts.total_bytes(dt) == js.total_bytes(dt)
            for f in range(ts.num_fragments):
                assert ts.wire_bytes(f, dt) == js.wire_bytes(f, dt)
        lw_t = tfrag.leaf_comm_dtypes(tt, "int8", large_elems=1 << 12)
        assert lw_t == jfrag.leaf_comm_dtypes(jt, "int8", large_elems=1 << 12)
        assert tfrag.resolve_comm_dtype("leafwise", "int8", tt) == \
            jfrag.resolve_comm_dtype("leafwise", "int8", jt)
        for bw in (None, 0.5, 2.0):
            for stagger in (0, 1, 3):
                assert tfrag.bandwidth_slots(
                    ts, stagger, "int8", bandwidth=bw, ref_bandwidth=1.0) == \
                    jfrag.bandwidth_slots(js, stagger, "int8", bandwidth=bw,
                                          ref_bandwidth=1.0)
    with pytest.raises(ValueError, match="leaves"):
        tfrag.FragmentSpec(tp, 2).flatten({"x": torch.zeros(2)})


def _payload_tree(seed):
    """Odd lengths, a scalar, an all-zero leaf, values around rounding
    ties, and large magnitudes."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal(7).astype(np.float32),
            "b": {"c": (rng.standard_normal((3, 5)) * 40).astype(np.float32),
                  "z": np.zeros((5,), np.float32)},
            "s": np.asarray(rng.standard_normal(), np.float32),
            "t": ((np.arange(13, dtype=np.float32) - 6) / 12 * 7.0)
            .astype(np.float32),
            "u": rng.standard_normal((1,)).astype(np.float32)}
    return tree


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_payload_bits_match_reference(dtype, seed):
    jt, tt = _both(_payload_tree(seed))
    jw, tw = jfrag.encode_wire(jt, dtype), tfrag.encode_wire(tt, dtype)
    jl = jax.tree_util.tree_leaves(jw)
    tl = pytree.leaves(tw)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        assert a.tobytes() == _bits(b)
    assert tfrag.payload_checksum(tw) == jfrag.payload_checksum(jw)
    assert tfrag.payload_nbytes(tw, dtype) == jfrag.payload_nbytes(jw, dtype)
    # decode and fake_quantize: each the reference's bits; the two agree
    # in value (a negative value that rounds to 0 is -0.0 in
    # fake_quantize and +0.0 once decoded from the int payload, in both
    # packages)
    jd, td = jfrag.decode_wire(jw, dtype, jt), tfrag.decode_wire(tw, dtype, tt)
    jq, tq = jfrag.fake_quantize(jt, dtype), tfrag.fake_quantize(tt, dtype)
    for a, b, c, d in zip(jax.tree_util.tree_leaves(jd), pytree.leaves(td),
                          jax.tree_util.tree_leaves(jq), pytree.leaves(tq)):
        assert np.asarray(a).tobytes() == _bits(b)
        assert np.asarray(c).tobytes() == _bits(d)
        np.testing.assert_array_equal(b.numpy(), d.numpy())
    # the all-zero leaf round-trips to zeros with a zero scale
    assert float(tw["b"]["z"]["scale"]) == 0.0
    assert not torch.any(td["b"]["z"])
    # the odd-length int4 leaf is padded by one nibble
    if dtype == "int4":
        assert tuple(tw["a"]["q"].shape) == (4,)
        assert tuple(tw["t"]["q"].shape) == (7,)


@pytest.mark.parametrize("dtype", ["fp32", "int8", "int4"])
def test_quantize_with_feedback_matches_reference(dtype):
    jt, tt = _both(_payload_tree(5))
    jr, tr = _both(jax.tree_util.tree_map(
        lambda x: np.asarray(x * 0.01, np.float32), _payload_tree(6)))
    for jres, tres in ((None, None), (jr, tr)):
        jw, jnr, jp = jfrag.quantize_with_feedback(jt, jres, dtype,
                                                   return_payload=True)
        tw, tnr, tp = tfrag.quantize_with_feedback(tt, tres, dtype,
                                                   return_payload=True)
        for a, b in zip(jax.tree_util.tree_leaves(jw), pytree.leaves(tw)):
            assert np.asarray(a).tobytes() == _bits(b)
        if dtype == "fp32":
            assert jnr is None and tnr is None
        else:
            for a, b in zip(jax.tree_util.tree_leaves(jnr),
                            pytree.leaves(tnr)):
                assert np.asarray(a).tobytes() == _bits(b)
        assert tfrag.payload_checksum(tp) == jfrag.payload_checksum(jp)


def test_per_leaf_dtype_lists_match_reference():
    jt, tt = _both(_payload_tree(3))
    dts = ["int4", "fp32", "int8", "int8", "int4", "fp32"]
    for fn in ("encode_wire", "fake_quantize"):
        a = getattr(jfrag, fn)(jt, dts)
        b = getattr(tfrag, fn)(tt, dts)
        assert tfrag.payload_checksum(b) == jfrag.payload_checksum(a)
    enc_j, enc_t = jfrag.encode_wire(jt, dts), tfrag.encode_wire(tt, dts)
    assert tfrag.payload_nbytes(enc_t, dts) == \
        jfrag.payload_nbytes(enc_j, dts)
    dec = tfrag.decode_wire(enc_t, dts, tt)
    assert tfrag.payload_checksum(dec) == jfrag.payload_checksum(
        jfrag.decode_wire(enc_j, dts, jt))
    assert tfrag.tree_wire_bytes(tt, dts) == jfrag.tree_wire_bytes(jt, dts)
    for dt in tfrag.COMM_DTYPES:
        assert tfrag.tree_wire_bytes(tt, dt) == jfrag.tree_wire_bytes(jt, dt)
    with pytest.raises(ValueError, match="comm_dtype"):
        tfrag.fake_quantize(tt, "int2")
    with pytest.raises(ValueError, match="entries"):
        tfrag.encode_wire(tt, ["int8"])


def test_schedule_helpers_match_reference():
    for tau, k in ((4, 4), (10, 3), (7, 1), (5, 2)):
        assert tfrag.segment_bounds(tau, k) == jfrag.segment_bounds(tau, k)
    with pytest.raises(ValueError):
        tfrag.segment_bounds(2, 3)
    for k in (1, 3, 4):
        for stagger in (0, 1, 2):
            assert [tfrag.fragment_send_slot(f, stagger, k)
                    for f in range(k)] == \
                [jfrag.fragment_send_slot(f, stagger, k) for f in range(k)]
    for n, l, dt in ((10, 1, "int4"), (11, 3, "int4"), (7, 2, "int8"),
                     (5, 5, "fp32")):
        assert tfrag._wire_bytes(n, l, dt) == jfrag._wire_bytes(n, l, dt)
