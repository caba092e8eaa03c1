#!/usr/bin/env python3
"""Time the port's ``flash_decode``, ``router_assign`` and ``ssd_scan``
kernels of one source tree on the card, eagerly and (the first two)
replayed from a CUDA graph, beside the PyTorch calls that compute the
same functions.

    python3 tools/kernel_timing.py --src SRC_DIR [--label NAME]

``SRC_DIR`` holds the ``repro_torch`` package to time (``src`` of a
checkout, or of an unpacked ``git archive`` of an older commit); its
kernels are built under that checkout's ``build/kernels``.  Run it for
two trees in one call on one card, in turns (old, new, new, old), to
compare them.  Prints one JSON line: bf16 flash decode at the serving
shape (B8 H16 D64, 80 slots) and at B64 over a wrapped ring of 2048
slots, with masked SDPA; over full rings of 2048 slots at 1, 4 and 8
query heads a KV head, with its bytes bound and (MHA) the rate of
copying the cache; f32 ``router_assign`` at k-means' N 2048 K 4 and at
N 65536 K 256 (D 896), with ``torch.cdist`` + ``argmin``; bf16
``ssd_scan`` at mamba2-1.3b's widths (H64 P64 G1 N128) at the routing
prefix (B8 S32 chunk 32) and a prefill (B8 S2048 chunk 256), with its
error against the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path



def h100_peaks():
    """The card's peaks from their one home, this checkout's
    ``src/repro_torch/launch/comm_analysis.py``, loaded by its path so
    that ``--src`` may name an older tree."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / \
        "src/repro_torch/launch/comm_analysis.py"
    spec = importlib.util.spec_from_file_location("_h100_peaks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn) -> float:
    """The call replayed from a CUDA graph: the device's time without the
    host's launch cost."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay)


def ssd_timings(torch, gen) -> dict:
    """bf16 ssd_scan of this tree at mamba2-1.3b's widths: x / 8, dt =
    softplus(z - 2), A = -(1..H), B and C scaled so that C.B is about 1."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    out = {}
    for name, b, s, chunk in (("B8 S32 chunk 32", 8, 32, 32),
                              ("B8 S2048 chunk 256", 8, 2048, 256)):
        h, p, g, n = 64, 64, 1, 128

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (randn(b, s, h, p) * 0.125).to(torch.bfloat16)
        dt = F.softplus(randn(b, s, h) - 2.0)
        a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
        bm, cm = ((randn(b, s, g, n) * n ** -0.25).to(torch.bfloat16)
                  for _ in range(2))
        y, state = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        py, pstate = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
        out[name] = {
            "max_abs_err": (y.float() - py.float()).abs().max().item(),
            "state_max_abs_err": (state - pstate).abs().max().item(),
            "ms": time_ms(torch, lambda: ssd_scan(x, dt, a, bm, cm,
                                                  chunk=chunk)),
            "device_ms_by_kernel": device_ms(
                torch, lambda: ssd_scan(x, dt, a, bm, cm, chunk=chunk))}
    return out


def device_ms(torch, fn, calls: int = 10) -> dict:
    """Device time per call of each kernel fn launches, from
    torch.profiler's raw trace, by the first 50 characters of its name."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            key = e.name()[:50]
            by_name[key] = by_name.get(key, 0.0) + e.duration_ns() / 1e6
    return {k: v / calls for k, v in by_name.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.router_assign import router_assign
    HBM_BYTES_PER_S = h100_peaks().HBM_BYTES_PER_S

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    out = {"label": args.label or args.src, "card": card}

    out["ssd_scan"] = ssd_timings(torch, gen)
    decode = {}
    full = [4095]                  # every slot of a 2048-slot ring valid
    for name, b, h, kh, T, ci in (
            ("B8 H16 D64 T80", 8, 16, 16, 80, [79] * 8),
            ("B64 H16 D64 T2048", 64, 16, 16, 2048,
             rng.integers(0, 3 * 2048, 64).tolist()),
            ("B64 H16 D64 T2048 full", 64, 16, 16, 2048, full * 64),
            ("B256 H16 KH4 D64 T2048 full", 256, 16, 4, 2048, full * 256),
            ("B1024 H8 KH1 D64 T2048 full", 1024, 8, 1, 2048, full * 1024)):
        q = torch.randn((b, h, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kc, vc = (torch.randn((b, T, kh, 64), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
        pos = ref.ring_positions(cit, T)
        valid = (pos >= 0) & (pos <= cit.long()[:, None])
        # bytes read and written once: the valid K and V rows, q, out
        bound_ms = (2 * int(valid.sum()) * kh * 64 * 2 + 2 * q.numel() * 2
                    ) / HBM_BYTES_PER_S * 1e3
        err = (flash_decode(q, kc, vc, cit).float() - ref.flash_decode_ref(
            q, kc, vc, cit).float()).abs().max().item()
        row = decode[name] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: flash_decode(q, kc, vc, cit)),
            "graph_ms": graph_ms(torch, lambda: flash_decode(q, kc, vc, cit)),
            "bound_ms": bound_ms}
        row["bound_share_graph"] = bound_ms / row["graph_ms"]
        if kh == h:
            mask = valid[:, None, None, :]
            qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            row["sdpa_graph_ms"] = graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask))
        if name == "B64 H16 D64 T2048 full":
            # the practical roof: the rate of copying the cache
            dst = torch.empty_like(kc)
            ms = time_ms(torch, lambda: dst.copy_(kc))
            row["copy_gb_per_s"] = 2 * kc.numel() * 2 / (ms * 1e-3) / 1e9
            row["copy_share_of_peak"] = row["copy_gb_per_s"] * 1e9 \
                / HBM_BYTES_PER_S
    out["flash_decode"] = decode

    assign = {}
    for name, n, k in (("N2048 D896 K4", 2048, 4),
                       ("N65536 D896 K256", 65536, 256)):
        z = torch.randn((n, 896), generator=gen, device="cuda")
        c = torch.randn((k, 896), generator=gen, device="cuda")
        a, d2 = router_assign(z, c)
        pa, pd2 = ref.router_assign_ref(z, c)
        assign[name] = {
            "mind2_max_abs_err": (d2 - pd2).abs().max().item(),
            "ms": time_ms(torch, lambda: router_assign(z, c)),
            "graph_ms": graph_ms(torch, lambda: router_assign(z, c)),
            "cdist_argmin_ms": time_ms(
                torch, lambda: torch.cdist(z, c).argmin(-1))}
    out["router_assign"] = assign
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
