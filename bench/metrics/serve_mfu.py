"""The serving window's share of the bf16 peak, in percent: the forward
FLOPs of the prompts prefilled and the tokens generated in the window
(``bench/flops.py``), over the window times 989 TFLOP/s."""
from bench import flops


def read(run):
    w = run.work
    if not w.get("tokens") or not run.window_s:
        return None
    need = flops.serve_flops(run.spec.model, w["tokens"], w["context"])
    return 100.0 * need / (run.window_s * flops.PEAK_BF16_FLOPS)
