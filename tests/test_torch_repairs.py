"""Three faults the port's parity records listed, each held here: the
serve launcher's ``--continuous`` alias of ``--engine continuous`` (as
the reference's launcher reads it), ``DiPaCoTrainer.resume``'s message
naming the three backends that resume, and gemma-2b's vector trainer at
the other families' peak lr 2e-3 against the JAX trainer, inner step by
inner step, over 2 phases of tau 2."""
import jax
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_smoke_config as jsmoke
from repro.core.dipaco import DiPaCoTrainer as JTrainer
from repro.data import sharder as jsharder
from repro.models import api as japi
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.dipaco import DiPaCoTrainer
from repro_torch.data import sharder
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.training import make_trainer

# gemma-2b's published heads (8 query, 1 KV, head_dim 256) and embedding
# scale; d_model, d_ff and vocab narrowed (2048, 16384, 256000 published)
# and 2 of its 18 blocks, so that both packages train it on the CPU
GEMMA = dict(num_heads=8, num_kv_heads=1, head_dim=256, d_model=256,
             d_ff=512, vocab_size=512, num_layers=2, route_prefix_len=8,
             dtype="float32")
# each inner step's loss, f32 in both packages: the same products summed
# in another order, through four AdamW steps
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(argv, capsys) -> str:
    from repro_torch.launch.serve import main
    torch.manual_seed(0)
    main(["--device", "cpu", "--paths", "2", "--requests", "3",
          "--max-new", "4", "--slots", "2", "--rate", "1000", *argv])
    return capsys.readouterr().out


def test_serve_launcher_continuous_alias(capsys):
    """``--continuous`` serves through the continuous engine, as
    ``--engine continuous`` does (the same printed report), and the
    one-shot engine stays the default."""
    alias = _serve(["--continuous"], capsys)
    engine = _serve(["--engine", "continuous"], capsys)
    oneshot = _serve([], capsys)
    assert "decode dispatch" in alias or "p50" in alias, alias
    strip = [ln for ln in alias.splitlines() if "tok/s" not in ln
             and "latency" not in ln and "ttft" not in ln.lower()]
    assert strip == [ln for ln in engine.splitlines() if "tok/s" not in ln
                     and "latency" not in ln and "ttft" not in ln.lower()]
    assert oneshot.splitlines()[0] != alias.splitlines()[0]


def test_resume_message_names_every_resuming_backend():
    cfg = tsmoke("dipaco-150m")
    with pytest.raises(NotImplementedError) as mine:
        DiPaCoTrainer.resume(cfg, DiPaCoConfig(), None, ckpt_root=None)
    with pytest.raises(NotImplementedError) as theirs:
        JTrainer.resume(jsmoke("dipaco-150m"), JDiPaCoConfig(), None,
                        key=None, ckpt_root=None)
    assert str(mine.value) == str(theirs.value)
    assert "'barrier'|'service'|'mesh'" in str(mine.value)


def test_gemma_lr_2e3_losses_match_reference_step_by_step(tiny_docs):
    """2 phases of tau 2 at peak lr 2e-3, warmup 1, levels (1,): each of
    the 4 inner steps' losses against the JAX vector trainer's from the
    same f32 weights and batches."""
    docs, _ = tiny_docs
    jcfg = jsmoke("gemma-2b").replace(attn_impl="chunked", **GEMMA)
    tcfg = tsmoke("gemma-2b").replace(attn_impl="pallas", **GEMMA)
    assert jcfg.embed_scale and tcfg.embed_scale
    jp = japi.init_model(jax.random.PRNGKey(3), jcfg)[0]
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    dkw = dict(levels=(1,), inner_steps=2)
    common = dict(batch_size=4, peak_lr=2e-3, warmup=1, total_steps=4)
    one = np.zeros(len(docs), np.int64)
    jt = repro.make_trainer(jcfg, JDiPaCoConfig(**dkw),
                            jsharder.shard_documents(docs, one, 1),
                            backend="vector", key=jax.random.PRNGKey(0),
                            base_params=jp, **common)
    tt = make_trainer(tcfg, DiPaCoConfig(**dkw),
                      sharder.shard_documents(docs, one, 1),
                      backend="vector", device="cpu", base_params=tp,
                      **common)
    theirs, mine = [], []
    phase_fn, step_fn = jt._phase_fn, tt._step_fn

    def jphase(*args):
        out = phase_fn(*args)
        theirs.extend(np.asarray(out[2])[:, 0].tolist())
        return out

    def tstep(*args):
        out = step_fn(*args)
        mine.append(float(out[2]["loss"][0]))
        return out

    jt._phase_fn, tt._step_fn = jphase, tstep
    for _ in range(2):
        jm, tm = jt.run_phase(), tt.run_phase()
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss,
                                   rtol=LOSS_RTOL)
    assert len(mine) == len(theirs) == 4
    np.testing.assert_allclose(mine, theirs, rtol=LOSS_RTOL)
    print("gemma lr 2e-3 inner-step losses, port:", mine, "JAX:", theirs)
