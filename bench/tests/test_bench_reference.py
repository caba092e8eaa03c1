"""The plain reference against the port's CPU path at smoke widths, the
cells' runs on the CPU, and the control and every planted fault coming
out as not correct.  ``test_control_fails_at_the_cells_size`` runs the
same on the card at the cell's own size (marked ``cuda``)."""
import time

import numpy as np
import pytest
import torch

from bench import harness, weights
from bench.reference.model import build, precise
from bench.tools import faults

from .conftest import benchmark, smoke_spec

SEED = 2 ** 31 + 11
TRAIN = ("train-150m-2x2", "train-dense1b")
SERVE = ("serve-150m-chat",)
# on the CPU the program computes in f32, as the reference: its sound
# runs read 1e-6 or less; the float8 control reads 0.03-0.3
CPU_SERVE_LIMITS = {"logit_gap": 0.01, "route_gap": 0.1}


def run(spec, faults_=(), trace=False):
    return harness.execute(spec, SEED, 0.5, trace, "cpu",
                           time.perf_counter(), faults=faults_)


def test_reference_logits_match_the_port_at_smoke_widths():
    from repro_torch.models.lm import apply_lm

    from bench.drivers.train import program_config
    precise()
    spec = smoke_spec("train-150m-2x2")
    m = spec.model
    tree = weights.make_paths(m, SEED, 1, "cpu")[0]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, m["vocab_size"], (2, 40)))
    got, _ = apply_lm(tree, program_config(m), tokens)
    want = build(weights.flat(tree), m).logits(tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_cell_is_correct_on_the_cpu(cell):
    limits = CPU_SERVE_LIMITS if cell in SERVE else None
    out, correct, table = run(smoke_spec(cell, limits), trace=True)
    assert correct, table
    assert out.attempted > 0 and out.failed == 0
    assert out.e2e["setup_s"] > 0


CASES = [(c, f) for c in TRAIN for f in ("control",) + faults.TRAIN
         if not (c == "train-dense1b" and f == "no_exchange")] + \
    [(c, f) for c in SERVE for f in ("control",) + faults.SERVE]


@pytest.mark.parametrize("cell,fault", CASES)
def test_the_control_and_each_fault_come_out_not_correct(cell, fault):
    limits = CPU_SERVE_LIMITS if cell in SERVE else None
    _, correct, table = run(smoke_spec(cell, limits), (fault,))
    assert not correct, table


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", CASES)
def test_control_fails_at_the_cells_size(cell, fault):
    """The cell as committed, on the card, with the control or a fault
    planted: ``correct`` comes out false (as ``tools/control.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels")
    spec = harness.load_spec(cell, benchmark())
    _, correct, table = harness.execute(spec, SEED, 1.0, False, "cuda",
                                        time.perf_counter(),
                                        faults=(fault,))
    assert not correct, table
