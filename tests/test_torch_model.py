"""The port's model against the JAX package in fp32 on the CPU: layers,
``apply_lm`` logits and loss, and prefill followed by decode steps with
a mixed (B,) cache_index, on the same weights (the JAX tree bridged to
torch) and numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.models import api as tapi
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_numpy_tree

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def _pair(**kw):
    return (jsmoke("dipaco-150m").replace(**kw),
            tsmoke("dipaco-150m").replace(**kw))


def _weights(jcfg, seed=0):
    jp = japi.init_model(jax.random.PRNGKey(seed), jcfg)[0]
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(scale), torch.from_numpy(x)),
           jl.rms_norm(jnp.asarray(scale), jnp.asarray(x)))
    pos = np.asarray([[3], [17]], np.int32)                   # (B, 1)
    for p in (np.arange(6)[None, :], pos):
        xx = x[:, :p.shape[1]]
        _close(tl.apply_rope(torch.from_numpy(xx), torch.from_numpy(p), 1e4),
               jl.apply_rope(jnp.asarray(xx), jnp.asarray(p), 1e4))


@pytest.mark.parametrize("mlp_type", ["gelu", "swiglu", "geglu", "relu2"])
def test_mlp_matches(mlp_type):
    jcfg, tcfg = _pair(mlp_type=mlp_type)
    jp = jl.init_mlp(jax.random.PRNGKey(1), jcfg)[0]
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 5, 128)).astype(
        np.float32)
    _close(tl.apply_mlp(tp, tcfg, torch.from_numpy(x)),
           jl.apply_mlp(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("causal,window,causal_skip", [
    (True, None, False), (True, 24, True), (False, None, False),
    (True, 40, False)])
def test_chunked_attention_matches(causal, window, causal_skip):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 70, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk_q=32, chunk_k=16,
              causal_skip=causal_skip)
    out = tl.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(out, jl.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw))
    _close(out, tl.full_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window))


# ---------------------------------------------------------------------------
# The model: four variants
# ---------------------------------------------------------------------------
VARIANTS = {
    "chunked": dict(attn_impl="chunked"),
    "pallas": dict(attn_impl="pallas"),
    "kv_quant": dict(attn_impl="pallas", kv_quant=True),
    "window_wrap": dict(attn_impl="pallas", sliding_window=8),
    "gqa_qk_norm": dict(attn_impl="pallas", num_kv_heads=2, qk_norm=True),
}


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_lm_logits_and_loss_match(variant):
    jcfg, tcfg = _pair(**VARIANTS[variant])
    jp, tp = _weights(jcfg)
    toks = _tokens(0, 2, 24, jcfg.vocab_size)
    jlog, _ = jlm.apply_lm(jp, jcfg, jnp.asarray(toks))
    tlog, aux = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(tlog, jlog)
    assert float(aux) == 0.0
    _close(tlm.lm_loss_mean(tlog, torch.from_numpy(toks), 8),
           jlm.lm_loss_mean(jlog, jnp.asarray(toks), 8))
    jh, _ = jlm.apply_lm(jp, jcfg, jnp.asarray(toks), return_hidden=True)
    th, _ = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks),
                         return_hidden=True)
    _close(th, jh)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_then_mixed_decode_matches(variant):
    """prefill, then decode steps whose (B,) positions differ per row;
    with a 16-slot cache the rows run past the ring and wrap."""
    jcfg, tcfg = _pair(**VARIANTS[variant])
    jp, tp = _weights(jcfg, seed=1)
    b, s, T, steps = 3, 8, 16, 12
    toks = _tokens(1, b, s + steps, jcfg.vocab_size)
    jlog, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks[:, :s]), T)
    tlog, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks[:, :s]), T)
    _close(tlog, jlog)
    # int8 KV: a value whose x/scale sits within ~1e-7 of a rounding tie
    # can quantize one step apart on the two sides (the reference's own
    # serving matrix self-references its int8 group for this reason);
    # one step of one cached value moves the logits by ~1e-4
    atol = 1e-3 if jcfg.kv_quant else ATOL
    base = np.asarray([s, s - 3, s - 1], np.int32)
    for t in range(steps):
        ci = base + t
        tok = toks[:, s + t:s + t + 1]
        jlog, jc = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.asarray(ci))
        tlog, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                   torch.from_numpy(ci))
        _close(tlog, jlog, atol)
    for name in jc["pos0"]:
        a, bb = np.asarray(jc["pos0"][name]), tc["pos0"][name].numpy()
        if a.dtype == np.int8:       # a rounding tie may land one step off
            diff = np.abs(a.astype(int) - bb.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            _close(bb, a)


def test_serve_api_matches_and_decoder_only():
    jcfg, tcfg = _pair(attn_impl="pallas")
    jp, tp = _weights(jcfg, seed=2)
    toks = _tokens(2, 2, 10, jcfg.vocab_size)
    jlog, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 12)
    tlog, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 12)
    _close(tlog, jlog)
    nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    jlog, _ = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(nxt)}, jc,
                              jnp.int32(10))
    tlog, _ = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)},
                              tc, 10)
    _close(tlog, jlog)
    loss, aux = tapi.forward_loss(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    jloss, _ = japi.forward_loss(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(loss, jloss)
    # the API now dispatches an encoder-decoder config (once refused):
    # it builds and computes (its parity is in test_torch_encdec.py)
    from repro_torch.models.config import EncoderConfig
    enc = tcfg.replace(encoder=EncoderConfig(1, 2, 8, 4))
    params = tapi.init_model(enc, device="cpu")
    assert {"src_proj", "enc", "dec"} <= set(params)
    frames = torch.randn(2, 4, 8)
    logits, _ = tapi.forward_logits(params, enc, {
        "tokens": torch.from_numpy(toks), "frames": frames})
    assert logits.shape == (2, 10, enc.vocab_size)
    assert torch.isfinite(logits).all()


def test_multi_token_ring_wrap_raises():
    _, tcfg = _pair()
    gen = torch.Generator().manual_seed(5)
    p = tl.init_attention(gen, tcfg)
    cache = {k: v[0] for k, v in
             tlm.init_decode_cache(tcfg, 1, 16, device="cpu")["pos0"].items()}
    x = torch.randn(1, 6, tcfg.d_model, generator=gen)
    pos = torch.arange(12, 18)[None, :]
    with pytest.raises(ValueError, match="wraps the ring"):
        tl.apply_attention(p, tcfg, x, positions=pos, cache=cache,
                           cache_index=12)
    with pytest.raises(ValueError, match="exceeds cache length"):
        tl.apply_attention(p, tcfg, torch.randn(1, 20, tcfg.d_model),
                           positions=torch.arange(20)[None, :], cache=cache,
                           cache_index=0)
    out, _ = tl.apply_attention(p, tcfg, x[:, :4], positions=pos[:, :4],
                                cache=cache, cache_index=12)
    assert out.shape == (1, 4, tcfg.d_model)


def test_moe_and_mamba_blocks_not_ported():
    """Every block and model kind the reference builds is ported now
    (the name is from when they were refused): MoE and Mamba blocks
    (parity in test_torch_moe_ssm*.py), the encoder-decoder
    (test_torch_encdec.py) and the VLM patch stub (test_torch_families.py)
    build and compute."""
    from repro_torch.models.config import (BlockSpec, EncoderConfig,
                                           VisionStubConfig)
    from repro_torch.configs import get_smoke_config
    _, tcfg = _pair()
    for spec in (BlockSpec("mamba", "dense"), BlockSpec("attn", "moe")):
        base = get_smoke_config("mamba2-1.3b" if spec.mixer == "mamba"
                                else "qwen2-moe-a2.7b")
        params = tapi.init_model(base.replace(pattern=(spec,), d_ff=64),
                                 device="cpu")
        assert set(params["blocks"]["pos0"]) == {"norm1", "mixer", "norm2",
                                                 "mlp"}
    enc = tcfg.replace(encoder=EncoderConfig(1, 2, 8, 4))
    params = tapi.init_model(enc, device="cpu")
    cache = tapi.init_serve_cache(enc, 1, 8, device="cpu")
    assert cache["k"].shape == (enc.num_layers, 1, 8, enc.num_kv_heads,
                                enc.head_dim)
    enc_out = torch.randn(1, 4, enc.d_model)
    logits, cache = tapi.serve_step(params, enc, {
        "tokens": torch.zeros((1, 1), dtype=torch.int32),
        "enc_out": enc_out}, cache, 0)
    assert logits.shape == (1, 1, enc.vocab_size)
    assert torch.isfinite(logits).all() and cache["k"][:, :, 0].any()
    vlm = tcfg.replace(vision=VisionStubConfig(4, 16))
    params = tapi.init_model(vlm, device="cpu")
    assert params["patch_proj"].shape == (16, vlm.d_model)
    toks = torch.zeros((2, 6), dtype=torch.int32)
    patches = torch.randn(2, 4, 16)
    with_patches, _ = tapi.forward_logits(params, vlm, {
        "tokens": toks, "patch_embeds": patches})
    text_only, _ = tapi.forward_logits(params, vlm, {"tokens": toks})
    assert torch.isfinite(with_patches).all()
    # the patches replace the first 4 positions; the causal rest sees them
    assert not torch.equal(with_patches[:, :4], text_only[:, :4])
    assert not torch.equal(with_patches[:, 4:], text_only[:, 4:])
