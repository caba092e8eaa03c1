"""gemma-2b, nemotron-4-340b and qwen3-moe-235b-a22b at their published
head geometry against the JAX package in fp32 on the CPU.  Their smoke
configs keep head_dim 64 and at most 3 query heads a KV head, so these
variants keep each family's mixer, MLP and 2 blocks but take its
published heads (gemma H8 KH1 D256; nemotron H12 KH1 D192, its 12 query
heads a KV head; qwen3-moe H16 KH1 D128), with d_model = H * D.  Both
packages run ``attn_impl="pallas"``: the reference's Pallas kernels in
interpret mode, the port's plain versions of its flash attention and
flash decode at those shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm

from test_torch_families import (  # noqa: F401 (an autouse fixture)
    _close, _one_torch_thread, _pair, _tokens, _weights)

# (family, query heads, KV heads, head_dim)
HEADS = [("gemma-2b", 8, 1, 256), ("nemotron-4-340b", 12, 1, 192),
         ("qwen3-moe-235b-a22b", 16, 1, 128)]


def _heads_pair(name, h, kh, d):
    return _pair(name, num_heads=h, num_kv_heads=kh, head_dim=d,
                 d_model=h * d, attn_impl="pallas")


@pytest.mark.parametrize("name,h,kh,d", HEADS)
def test_published_heads_apply_lm_matches(name, h, kh, d):
    """``apply_lm`` logits, aux loss and ``forward_loss`` within 1e-5."""
    jcfg, tcfg = _heads_pair(name, h, kh, d)
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim) == (h, kh, d)
    jp, tp = _weights(jcfg, seed=4)
    toks = _tokens(4, 2, 40, jcfg.vocab_size)
    jlog, jaux = jlm.apply_lm(jp, jcfg, jnp.asarray(toks))
    tlog, taux = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(tlog, jlog)
    _close(taux, jaux)
    loss, _ = tapi.forward_loss(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(loss, japi.forward_loss(jp, jcfg,
                                   {"tokens": jnp.asarray(toks)})[0])


@pytest.mark.parametrize("name,h,kh,d", HEADS)
def test_published_heads_prefill_then_greedy_decodes_match(name, h, kh, d):
    """prefill, then 4 greedy decode steps through flash decode at the
    family's (G, D), each fed the reference's argmax: the logits within
    1e-5 and the greedy tokens identical."""
    jcfg, tcfg = _heads_pair(name, h, kh, d)
    jp, tp = _weights(jcfg, seed=5)
    b, s, T = 2, 9, 16
    toks = _tokens(5, b, s, jcfg.vocab_size)
    jlog, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, T)
    tlog, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, T)
    _close(tlog, jlog)
    for t in range(4):
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tlog[:, -1], -1).numpy(), nxt)
        jlog, jc = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(
            nxt[:, None])}, jc, jnp.int32(s + t))
        tlog, tc = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(
            nxt[:, None])}, tc, s + t)
        _close(tlog, jlog)
    np.testing.assert_array_equal(torch.argmax(tlog[:, -1], -1).numpy(),
                                  np.array(jnp.argmax(jlog[:, -1], -1)))
