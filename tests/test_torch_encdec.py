"""The port's encoder-decoder (``whisper-base``) against the JAX package
in fp32 on the CPU at smoke size, on the reference's ``init_model``
weights bridged to torch and numpy-seeded frames and tokens: the tree,
``encode``, ``apply_encdec`` and its gradients, ``build_cross_cache``,
decoding with and without the cross-KV cache (the counterpart of
``tests/test_beyond_paper.py::test_cross_kv_cache_decode_exact``),
``api.prefill``'s replay, the per-layer cache buffers, and the engines'
and launchers' refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import encdec as jed
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import api as tapi
from repro_torch.models import encdec as ted
from repro_torch.models.params import (from_numpy_tree, param_axes,
                                       to_numpy_tree)

ATOL = 1e-5
NAME = "whisper-base"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _pair(**kw):
    return jsmoke(NAME).replace(**kw), tsmoke(NAME).replace(**kw)


@pytest.fixture(scope="module")
def weights():
    jcfg = jsmoke(NAME)
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)[0]
    return jp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    enc = cfg.encoder
    frames = rng.standard_normal((b, enc.source_len, enc.d_source)).astype(
        np.float32)
    return frames, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_keys_shapes_dtypes_and_axes_match(dtype):
    jcfg, tcfg = _pair(dtype=dtype)
    jp, jaxes = japi.init_model(jax.random.PRNGKey(0), jcfg)
    assert param_axes(tcfg) == jaxes
    mine = _flat(to_numpy_tree(tapi.init_model(tcfg, seed=0, device="cpu")))
    theirs = _flat(jp)
    assert mine.keys() == theirs.keys()
    assert {k.split("/")[0] for k in mine} == {
        "embed", "src_proj", "enc", "dec", "enc_norm", "final_norm"}
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
        assert mine[k].dtype == theirs[k].dtype, k
    assert mine["dec/cross_attn/wk"].shape[0] == jcfg.num_layers
    assert mine["enc/attn/wq"].shape[0] == jcfg.encoder.num_layers


def test_sinusoidal_matches():
    pos = np.arange(37)
    for dim in (128, 2):                 # 2: the max(half - 1, 1) floor
        _close(ted._sinusoidal(torch.from_numpy(pos), dim),
               jed._sinusoidal(jnp.asarray(pos), dim))


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_encode_and_apply_encdec_match(weights, attn_impl):
    """The encoder at 64 frames runs the full attention under chunked
    (64 <= attn_chunk_q) and a chunked one at chunk 16; the decoder's
    causal self-attention goes through the FlashAttention Function under
    pallas."""
    jp, tp = weights
    for chunk in (512, 16):
        jcfg, tcfg = _pair(attn_impl=attn_impl, attn_chunk_q=chunk,
                           attn_chunk_k=chunk)
        frames, toks = _inputs(jcfg)
        _close(ted.encode(tp, tcfg, torch.from_numpy(frames)),
               jed.encode(jp, jcfg, jnp.asarray(frames)))
        tlog, taux = tapi.forward_logits(
            tp, tcfg, {"tokens": torch.from_numpy(toks),
                       "frames": torch.from_numpy(frames)})
        jlog, _ = japi.forward_logits(jp, jcfg, {"tokens": jnp.asarray(toks),
                                                 "frames": jnp.asarray(frames)})
        _close(tlog, jlog)
        assert float(taux) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_gradients_match(weights, remat):
    """``jax.grad`` of the reference's ``forward_loss`` (with its remat
    setting) against the port's at ``attn_impl="pallas"``, leaf by leaf
    within 1e-5 (of the leaf's largest gradient where that exceeds 1)."""
    jp, tp = weights
    jcfg, tcfg = _pair(remat=remat, route_prefix_len=4)
    frames, toks = _inputs(jcfg, s=20, seed=1)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    jloss = japi.forward_loss(jp, jcfg, jb)[0]
    jgrads = jax.grad(lambda p: japi.forward_loss(p, jcfg, jb)[0])(jp)
    loss, _, grads = value_and_grad(
        tp, tcfg.replace(attn_impl="pallas"),
        {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    _close(loss, jloss)
    mine, theirs = _flat(to_numpy_tree(grads)), _flat(jgrads)
    assert mine.keys() == theirs.keys()
    for k in mine:
        scale = max(float(np.abs(theirs[k]).max()), 1.0)
        assert float(np.abs(mine[k] - theirs[k]).max()) <= ATOL * scale, k
    assert np.abs(mine["src_proj"]).max() > 0
    assert np.abs(mine["dec/cross_attn/wk"]).max() > 0


def test_build_cross_cache_matches(weights):
    jp, tp = weights
    jcfg, tcfg = _pair()
    frames, _ = _inputs(jcfg)
    enc = jed.encode(jp, jcfg, jnp.asarray(frames))
    jc = jed.build_cross_cache(jp, jcfg, enc)
    tc = ted.build_cross_cache(tp, tcfg, torch.from_numpy(np.array(enc)))
    assert tc.keys() == jc.keys()
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape == (
            jcfg.num_layers, 2, jcfg.encoder.source_len, jcfg.num_kv_heads,
            jcfg.head_dim)
        _close(tc[n], jc[n])


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_serve_step_with_and_without_cross_kv(weights, attn_impl):
    """5 decode steps with the encoder output and with the precomputed
    cross K/V: the two equal each other (1e-5, as the reference's own
    test) and the reference's; both caches end equal to the
    reference's."""
    jp, tp = weights
    jcfg, tcfg = _pair(attn_impl=attn_impl)
    frames, toks = _inputs(jcfg, s=5, seed=2)
    enc = jed.encode(jp, jcfg, jnp.asarray(frames))
    jcross = jed.build_cross_cache(jp, jcfg, enc)
    t_enc = ted.encode(tp, tcfg, torch.from_numpy(frames))
    tcross = ted.build_cross_cache(tp, tcfg, t_enc)
    jc = japi.init_serve_cache(jcfg, 2, 8)
    c1 = tapi.init_serve_cache(tcfg, 2, 8, device="cpu")
    c2 = tapi.init_serve_cache(tcfg, 2, 8, device="cpu")
    for t in range(5):
        tok = toks[:, t:t + 1]
        jl, jc = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(tok),
                                            "enc_out": enc}, jc, jnp.int32(t))
        l1, c1 = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(tok),
                                            "enc_out": t_enc}, c1, t)
        l2, c2 = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(tok),
                                            "enc_out": t_enc,
                                            "cross_kv": tcross}, c2, t)
        _close(l1, l2)
        _close(l1, jl)
    for n in jc:
        _close(c1[n], jc[n])
        _close(c2[n], jc[n])
    jl2, _ = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(toks[:, :1]),
                                        "enc_out": enc, "cross_kv": jcross},
                             japi.init_serve_cache(jcfg, 2, 8), jnp.int32(0))
    l3, _ = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(
        toks[:, :1]), "cross_kv": tcross},
        tapi.init_serve_cache(tcfg, 2, 8, device="cpu"), 0)
    _close(l3, jl2)


def test_prefill_replays_the_prompt(weights):
    """``api.prefill`` of an encoder-decoder replays the prompt through
    ``serve_step`` and returns the last step's (B, 1, V) logits and the
    cache, as the reference's; decoding on from it matches too."""
    jp, tp = weights
    jcfg, tcfg = _pair(attn_impl="pallas")
    frames, toks = _inputs(jcfg, s=7, seed=3)
    enc = jed.encode(jp, jcfg, jnp.asarray(frames))
    t_enc = ted.encode(tp, tcfg, torch.from_numpy(frames))
    tcross = ted.build_cross_cache(tp, tcfg, t_enc)
    jlog, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                       "enc_out": enc}, 12)
    tlog, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                       "enc_out": t_enc,
                                       "cross_kv": tcross}, 12)
    assert tuple(tlog.shape) == jlog.shape == (2, 1, jcfg.vocab_size)
    _close(tlog, jlog)
    for n in jc:
        _close(tc[n], jc[n])
    nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    jlog, _ = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(nxt),
                                         "enc_out": enc}, jc, jnp.int32(7))
    tlog, _ = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(nxt),
                                         "cross_kv": tcross}, tc, 7)
    _close(tlog, jlog)


def test_cache_layers_are_separate_buffers(weights):
    """Each decoder layer's cache is its own memory: a write to layer 0
    leaves layer 1 zero, and one decode step writes each layer's own K/V
    into its slot (the layers' weights differ, so the slots do)."""
    _, tp = weights
    _, tcfg = _pair()
    cache = tapi.init_serve_cache(tcfg, 2, 8, device="cpu")
    cache["k"][0].fill_(1.0)
    assert not cache["k"][1].any() and not cache["v"].any()
    cache = tapi.init_serve_cache(tcfg, 2, 8, device="cpu")
    frames, toks = _inputs(tcfg, s=1, seed=4)
    enc = ted.encode(tp, tcfg, torch.from_numpy(frames))
    tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(toks),
                               "enc_out": enc}, cache, 3)
    for n in ("k", "v"):
        written = cache[n][:, :, 3]
        assert all(written[i].abs().max() > 0 for i in range(len(written)))
        assert not torch.equal(written[0], written[1])
        rest = torch.cat([cache[n][:, :, :3], cache[n][:, :, 4:]], dim=2)
        assert not rest.any()


def test_engines_and_launchers_refuse_encdec(weights):
    """No bucketed prefill for an encoder-decoder (the reference engine's
    ``can_bucket``); the launchers serve and train decoders only; the
    decode takes no mask."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.serving import ContinuousBatchingEngine, EngineOptions
    _, tp = weights
    _, tcfg = _pair()
    with pytest.raises(ValueError, match="bucketed prefill requires"):
        ContinuousBatchingEngine(tcfg, [tp], options=EngineOptions(
            cache_len=16, bucketed_prefill=True, stacked=False))
    eng = ContinuousBatchingEngine(tcfg, [tp], options=EngineOptions(
        cache_len=16, stacked=False))
    assert not eng.bucketed
    for main, argv in ((serve_main, []), (train_main, ["--smoke"])):
        with pytest.raises(ValueError, match="encoder-decoder"):
            main(["--arch", NAME, "--device", "cpu", *argv])
    with pytest.raises(ValueError, match="no mask"):
        tapi.serve_step(tp, tcfg, {"tokens": torch.zeros((1, 1), dtype=int)},
                        tapi.init_serve_cache(tcfg, 1, 4, device="cpu"), 0,
                        mask=torch.ones(1, dtype=torch.bool))
