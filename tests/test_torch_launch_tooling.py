"""The port's dry-run arithmetic against the JAX package, config by
config: ``launch/flopmodel.analyze`` (relative 1e-12), the parameter
counts and ``model_flops`` (exact), the meta shape trees against the
reference's ``jax.eval_shape`` trees and against ``init_model`` at smoke
size, and ``spec_for`` / ``rules_for`` on every parameter and cache
leaf on both production meshes (the same choice, dimension for
dimension).

The reference recounts its parameters through ``jax.eval_shape`` on
every ``analyze`` call (0.6-3.1 s a config), so its shape trees are made
once per config here and shared: ``repro.launch.steps.model_param_shapes``
is memoised for this module (the same trees, only not recomputed)."""
import os
from types import SimpleNamespace

import pytest
import torch

import repro.launch.steps as jsteps
from repro.configs import ALL_CONFIGS as J_ALL
from repro.configs import get_config as jget
from repro.launch import flopmodel as jflop
from repro.launch import sharding as jshard
from repro.launch import specs as jspecs
from repro.models.config import INPUT_SHAPES as J_SHAPES
from repro_torch.configs import ALL_CONFIGS, ASSIGNED_ARCHS, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import flopmodel, sharding, specs, steps
from repro_torch.launch.dryrun import opt_transform
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.models.config import INPUT_SHAPES


def reference_dryrun():
    """``repro.launch.dryrun`` for its pure helpers.  It appends a 512
    host-device flag to ``XLA_FLAGS`` at import, which would take effect
    at this process's first JAX backend start; the variable is put back
    as it was."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return dryrun


j_opt = reference_dryrun().opt_transform
REL = 1e-12
MESHES = {"16x16": SimpleNamespace(shape={"data": 16, "model": 16}),
          "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16,
                                            "model": 16})}

_REF_SHAPES: dict = {}


def _ref_param_shapes(cfg):
    if cfg.name not in _REF_SHAPES:
        _REF_SHAPES[cfg.name] = _real_model_param_shapes(cfg)
    return _REF_SHAPES[cfg.name]


_real_model_param_shapes = jsteps.model_param_shapes


@pytest.fixture(autouse=True, scope="module")
def _memoised_reference_shapes():
    """The reference's parameter shapes depend on the widths only, not on
    the fields ``opt_transform`` sets, so one eval_shape a config serves
    both variants."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "model_param_shapes", _ref_param_shapes)
        yield


def test_configs_lists_match_reference():
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert ALL_CONFIGS == J_ALL
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for k, s in INPUT_SHAPES.items():
        assert vars(s) == vars(J_SHAPES[k])


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0), (a, b)


def _same_report(mine, theirs):
    _close(mine.fwd_flops, theirs.fwd_flops)
    _close(mine.total_flops, theirs.total_flops)
    _close(mine.hbm_bytes, theirs.hbm_bytes)
    assert mine.breakdown.keys() == theirs.breakdown.keys()
    for k in mine.breakdown:
        _close(mine.breakdown[k], theirs.breakdown[k])


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_analyze_matches_reference(name, shape):
    """The base config at ``num_workers`` 16, and at ``train_4k`` also
    the ``opt`` variant and ``num_workers`` 1."""
    cfg, jcfg = get_config(name), jget(name)
    _same_report(flopmodel.analyze(cfg, INPUT_SHAPES[shape], num_workers=16),
                 jflop.analyze(jcfg, J_SHAPES[shape], num_workers=16))
    if shape == "train_4k":
        _same_report(
            flopmodel.analyze(opt_transform(cfg), INPUT_SHAPES[shape],
                              num_workers=16),
            jflop.analyze(j_opt(jcfg), J_SHAPES[shape], num_workers=16))
        _same_report(flopmodel.analyze(cfg, INPUT_SHAPES[shape]),
                     jflop.analyze(jcfg, J_SHAPES[shape]))


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_param_counts_and_model_flops_match_reference(name):
    cfg, jcfg = get_config(name), jget(name)
    assert specs.active_param_count(cfg) == jspecs.active_param_count(jcfg)
    for shape in INPUT_SHAPES:
        assert specs.model_flops(cfg, INPUT_SHAPES[shape]) == \
            jspecs.model_flops(jcfg, J_SHAPES[shape])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_meta_param_tree_matches_reference_eval_shape(name):
    """Keys, shapes, dtypes and axes at full size, nothing allocated."""
    shapes, axes = steps.model_param_shapes(get_config(name))
    jshapes, jaxes = _ref_param_shapes(jget(name))
    a, b = _flat(shapes), _flat(jshapes)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].device.type == "meta"
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert str(a[k].dtype).split(".")[-1] == str(b[k].dtype), k
    assert _flat(axes) == _flat(jaxes)


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_meta_param_tree_matches_init_model(name):
    """The meta tree against ``init_model(device="cpu")`` at smoke size,
    leaf for leaf (keys, shapes, dtypes), and its worker stack and AdamW
    state."""
    cfg = get_smoke_config(name)
    shapes, axes = steps.model_param_shapes(cfg)
    real = api.init_model(cfg, seed=0, device="cpu")
    a, b = _flat(shapes), _flat(real)
    assert a.keys() == b.keys()
    for k in a:
        assert (tuple(a[k].shape), a[k].dtype) == \
            (tuple(b[k].shape), b[k].dtype), k
    stacked, _ = steps.worker_param_shapes(cfg, 3)
    assert all(tuple(x.shape) == (3, *b[k].shape)
               for k, x in _flat(stacked).items())
    opt = steps.adamw_state_shapes(shapes)
    assert all(x.dtype == torch.float32 and x.device.type == "meta"
               for x in _flat(opt["m"]).values())
    assert opt["count"].dtype == torch.int32


def _ref_spec(axes, shape, mesh, rules):
    return tuple(jshard.spec_for(tuple(axes), tuple(shape), mesh, rules))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_spec_for_matches_reference(name, mesh):
    """Every parameter leaf worker-stacked, under ``rules_for`` of the base
    and the opt variant, and every decode-cache leaf (both cache lengths)
    under the default rules: the same mesh-axis choice a dimension."""
    m = MESHES[mesh]
    W = 32 if "pod" in m.shape else 16
    shapes, axes = steps.worker_param_shapes(get_config(name), W)
    for variant in (lambda c: c, opt_transform):
        cfg = variant(get_config(name))
        jcfg = (j_opt if variant is opt_transform else (lambda c: c))(
            jget(name))
        rules, jrules = specs.rules_for(cfg), jspecs.rules_for(jcfg)
        assert {k: tuple(v) for k, v in rules.items()} == \
            {k: tuple(v) for k, v in jrules.items()}
        for path, x, ax in P.tree_axes_flatten(shapes, axes):
            full = (P.WORKER, *ax)
            assert sharding.spec_for(full, tuple(x.shape), m, rules) == \
                _ref_spec(full, x.shape, m, jrules), (path, full)
        for b, T, kv_quant in ((8, 32768, False), (1, 4096, True)):
            c = cfg.replace(kv_quant=kv_quant)
            cs, cax = specs.decode_cache_shapes(c, b, T)
            jcs, jcax = jspecs.decode_cache_shapes(
                jcfg.replace(kv_quant=kv_quant), b, T)
            for (path, x, ax), (_, y, jax_) in zip(
                    P.tree_axes_flatten(cs, cax),
                    P.tree_axes_flatten(jcs, jcax)):
                assert tuple(x.shape) == tuple(y.shape) and ax == jax_
                assert str(x.dtype).split(".")[-1] == str(y.dtype), path
                assert sharding.spec_for(ax, tuple(x.shape), m,
                                         specs.RULES) == \
                    _ref_spec(ax, y.shape, m, jspecs.RULES), path


@pytest.mark.parametrize("axes,shape,mesh,want", [
    (("worker", None, None), (16, 8, 4096), "16x16", ("data", None, None)),
    (("worker", None, None), (32, 8, 4096), "2x16x16",
     (("pod", "data"), None, None)),
    (("embed", "heads", "head_dim"), (4096, 64, 128), "16x16",
     (None, "model", None)),
    (("embed", "heads", "head_dim"), (2048, 8, 256), "16x16",
     (None, None, None)),
    (("expert", "embed", "expert_mlp"), (128, 4096, 1536), "16x16",
     ("model", None, None)),
])
def test_spec_for_hand_cases(axes, shape, mesh, want):
    """The reference's own hand cases (``tests/test_sharding_rules.py``)."""
    m = MESHES[mesh]
    assert sharding.spec_for(axes, shape, m) == want == \
        tuple(jshard.spec_for(axes, shape, m))


def test_sharding_helpers_and_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == MESHES["16x16"].shape and one.size == 256
    assert two.shape == MESHES["2x16x16"].shape and two.size == 512
    assert sharding.replicated(one) == ()
    assert sharding.worker_stacked_sharding(one) == ("data",)
    assert sharding.worker_stacked_sharding(two) == (("pod", "data"),)
    assert sharding.batch_sharding(one, 3, batch_dim=1) == \
        (None, "data", None)
    assert sharding.batch_sharding(two, 2) == (("pod", "data"), None)
    tree = {"a": torch.empty(16, 64, device="meta")}
    assert sharding.shardings_for_tree(
        tree, {"a": ("mlp",)}, one, prepend=("worker",)) == \
        {"a": ("data", "model")}
    assert sharding.device_bytes((16, 64), 2, ("data", "model"), one) == 8.0


@pytest.mark.parametrize("name", ["dipaco-150m", "qwen3-moe-235b-a22b",
                                  "jamba-v0.1-52b", "whisper-base",
                                  "pixtral-12b"])
def test_cases_build_on_meta_without_allocating(name):
    """Every case of the four shapes on the 16x16 mesh: meta arguments
    only, one spec a leaf of the same rank, W worker rows, the batch
    split over them; a rank's arguments hold one worker row."""
    mesh = make_production_mesh()
    for shape in INPUT_SHAPES.values():
        case = specs.build_case(get_config(name), shape, mesh)
        W = case.static["workers"]
        assert W == (16 if shape.global_batch > 1 else 1)
        for arg, axes, spec in zip(case.args, case.axes, case.specs):
            for x, ax, s in zip(P.tree_leaves(arg), P.tree_leaves(axes),
                                P.tree_leaves(spec)):
                assert x.device.type == "meta"
                assert len(ax) == len(s) == x.ndim
                if ax and ax[0] == P.WORKER:
                    assert x.shape[0] == W
        local = case.local_args(W)
        tok = local[case.names.index("inputs")]["tokens"]
        lead = (1,) if W > 1 else ()
        assert tuple(tok.shape[:-1]) == (*lead, shape.global_batch // W)
