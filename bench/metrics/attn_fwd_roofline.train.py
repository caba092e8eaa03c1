"""Share of its roofline that the attention forward with LSE rows
(``csrc/flash_attention.cu``, ``flash_fwd_*<D, true>``) reaches in the
traced slice: the least time of its calls by ``bench/flops.py``, over
their device time."""
from bench import flops


def is_lse_forward(name: str) -> bool:
    return ("flash_fwd_wgmma<" in name or "flash_fwd_kernel<" in name) \
        and ", true>" in name


def read(run):
    if run.trace is None:
        return None
    seconds, calls = run.trace.kernel_time(is_lse_forward)
    if not calls:
        return None
    m, w = run.spec.model, run.work
    bound = flops.attention_fwd_bound_s(w["batch"], w["seq_len"],
                                        m["num_heads"], m["num_kv_heads"],
                                        m["head_dim"])
    return 100.0 * calls * bound / seconds
