#!/usr/bin/env python3
"""Time the port's ``flash_decode`` at the last three families' query
groups with one and with two query heads a block (the kernel's
instantiations; ``decode_attention.MAX_GROUP`` picks two), on the card.

    PYTHONPATH=src python3 tools/decode_groups.py

For each shape (bf16, B8 over phase 3's 80-slot cache at its last step
and over a wrapped 2048-slot ring: G 16 D 128, G 12 D 192, G 8 D 256,
and G 8 D 128) and each head-group size, the call is replayed from a
CUDA graph in turns (sizes in order, then in reverse) and checked
against the plain version.  Prints one JSON line with the card's name
and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import decode_attention, ref  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402

# (B, H, KH, D)
SHAPES = [(8, 64, 4, 128), (8, 96, 8, 192), (8, 8, 1, 256), (8, 32, 4, 128)]


def graph_ms(fn, iters: int = 100) -> float:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_groups: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    default = decode_attention.MAX_GROUP
    out = {"card": card, "rows": []}
    for b, h, kh, d in SHAPES:
        for T, ci in ((80, [79] * b),
                      (2048, rng.integers(0, 3 * 2048, b).tolist())):
            q = torch.randn((b, h, d), generator=gen,
                            device="cuda").bfloat16()
            kc, vc = (torch.randn((b, T, kh, d), generator=gen,
                                  device="cuda").bfloat16() for _ in range(2))
            cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
            plain = ref.flash_decode_ref(q, kc, vc, cit).float()
            caps = list(range(1, default + 1))
            times = {c: [] for c in caps}
            errs = {}
            for order in (caps, caps[::-1]):
                for cap in order:
                    decode_attention.MAX_GROUP = cap
                    err = (flash_decode(q, kc, vc, cit).float()
                           - plain).abs().max().item()
                    assert err <= 2e-2, (b, h, kh, d, T, cap, err)
                    errs[cap] = err
                    times[cap].append(graph_ms(
                        lambda: flash_decode(q, kc, vc, cit)))
            decode_attention.MAX_GROUP = default
            out["rows"].append({"shape": [b, h, kh, d, T],
                                "graph_ms": times, "max_abs_err": errs})
            print(f"[decode_groups] {out['rows'][-1]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
