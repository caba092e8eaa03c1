"""Share of its roofline that the attention backward (dK/dV and dQ,
``csrc/flash_attention_bwd.cu``) reaches in the traced slice: the least
time of its calls by ``bench/flops.py``, over the device time of both
kernels.  A call launches one dQ kernel."""
from bench import flops

KERNELS = ("dkv_wgmma<", "dq_wgmma<", "dkv_kernel<", "dq_kernel<")
DQ = ("dq_wgmma<", "dq_kernel<")


def read(run):
    if run.trace is None:
        return None
    seconds, _ = run.trace.kernel_time(lambda n: any(k in n for k in KERNELS))
    _, calls = run.trace.kernel_time(lambda n: any(k in n for k in DQ))
    if not calls:
        return None
    m, w = run.spec.model, run.work
    bound = flops.attention_bwd_bound_s(w["batch"], w["seq_len"],
                                        m["num_heads"], m["num_kv_heads"],
                                        m["head_dim"])
    return 100.0 * calls * bound / seconds
