"""Small cells for the CPU: the benchmark's cells cut to smoke widths,
the program on its plain CPU paths (f32, no kernels)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

SMOKE_MODEL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                   head_dim=32, d_ff=512, vocab_size=512, dtype="float32",
                   remat=False, attn_impl="chunked")
SMOKE_MIX = {
    "train": dict(docs=64, doc_len=64, batch=2, tau=2, kmeans_iters=5,
                  reference_rows=1),
    "serve": dict(prompt_lens=[32, 48], max_new=[4, 8], doc_len=48, slots=4,
                  cache_len=64, router_docs=64, check_tokens=40, rate=20.0),
}


def benchmark() -> dict:
    """``BENCHMARK.json`` with the serving cell's entries added
    (``serve-150m-chat.json`` here: the cell it leaves out for now)."""
    top = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((Path(__file__).parent
                        / "serve-150m-chat.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        top[key] = top[key] + extra[key]
    return top


def smoke_spec(cell: str, limits=None) -> harness.Spec:
    """The cell's spec with the model and the traffic cut to smoke sizes
    (the CPU's f32 program: the limits default to the cell's)."""
    spec = harness.load_spec(cell, benchmark())
    config = json.loads(json.dumps(spec.config))
    config["model"].update(SMOKE_MODEL)
    mix = {**spec.mix, **SMOKE_MIX[spec.mix["kind"]]}
    return harness.Spec(spec.cell, config, mix, limits or spec.limits,
                        spec.end_to_end, spec.per_layer)


@pytest.fixture
def smoke():
    return smoke_spec


@pytest.fixture(autouse=True)
def short_trace_slice(monkeypatch):
    """The traced slice and its warm-up cut to a fraction of a second."""
    from bench import devtrace
    from bench.drivers import serve
    monkeypatch.setattr(devtrace, "SLICE_S", 0.3)
    monkeypatch.setattr(serve, "SLICE_WARM_S", 0.2)
