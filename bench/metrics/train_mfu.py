"""The training step's share of the bf16 peak, in percent, over the
traced slice (whole phases: inner and outer steps): the forward and
backward FLOPs its tokens need (``bench/flops.py``: causal attention,
remat's recompute not counted), over the slice times 989 TFLOP/s."""
from bench import flops


def read(run):
    w = run.work
    if not w.get("traced_tokens") or not run.trace_window_s:
        return None
    need = flops.train_flops(run.spec.model, w["traced_tokens"], w["seq_len"])
    return 100.0 * need / (run.trace_window_s * flops.PEAK_BF16_FLOPS)
