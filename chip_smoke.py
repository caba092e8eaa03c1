#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. Card and build: prints the card's name and power limit, builds every
   CUDA kernel of the serving path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time.
2. Kernels against their plain PyTorch versions on the card, in bf16 and
   f32, at the serving path's shapes and at larger ones; times each
   kernel, its plain version and one PyTorch call as a yardstick, and
   prints one ``{"kernels": [...]}`` line.
3. The slice at full width: ``dipaco-150m`` (12 blocks, d 896, vocab
   32000) in bf16 with ``attn_impl="pallas"``, 4 random paths and a
   discriminative router; ``PathServingEngine.generate`` serves 8 corpus
   prompts, once plain and once with re-routing, and must launch both
   kernels.  ``prefill`` + decode through the kernels is compared with
   the same calls through the plain attention.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.routing import (DiscriminativeRouter,  # noqa: E402
                                      prefix_features)
from repro_torch.data import SyntheticCorpus  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import EngineOptions, PathServingEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# the rate for each input type (bf16 on the tensor cores, f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the same inputs: both accumulate in f32, so
# f32 differs only by summation order; a bf16 output may differ by one
# bf16 rounding of values below 4 (2^-7 at most)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PROMPT_LEN, MAX_NEW, NUM_PATHS, REQUESTS, REROUTE_EVERY = 64, 16, 4, 8, 4
CACHE_LEN = PROMPT_LEN + MAX_NEW


def time_ms(fn, iters: int = 50) -> float:
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_pairs(s: int, causal: bool, window) -> int:
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum())


def check_flash_attention(gen) -> dict:
    # (B, S, H, KH, D, window): the routing features' shape, a long
    # sequence, a ragged S with a window under GQA, and the other head dims
    cases = [(8, 32, 16, 16, 64, None), (2, 2048, 16, 16, 64, None),
             (2, 1000, 16, 4, 64, 256), (1, 333, 8, 8, 128, None),
             (2, 77, 4, 2, 32, 16)]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, kh, d, w in cases:
            q = randn(gen, b, s, h, d, dtype=dtype)
            k = randn(gen, b, s, kh, d, dtype=dtype)
            v = randn(gen, b, s, kh, d, dtype=dtype)
            out = flash_attention(q, k, v, causal=True, window=w)
            torch.cuda.synchronize()
            plain = ref.flash_attention_ref(q, k, v, causal=True, window=w)
            err = (out.float() - plain.float()).abs().max().item()
            row = {"shape": [b, s, h, kh, d], "window": w,
                   "dtype": str(dtype), "max_abs_err": err,
                   "tol": TOL[dtype]}
            rows.append(row)
            print(f"[flash_attention] {row}")
            assert err <= TOL[dtype], row
    # timings in bf16 at the serving path's shape (routing features) and
    # at a long sequence, where device work outweighs the launch
    main = fa_timings(gen, 8, 32, 16, 64)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": None, **main,
        "library_call": "F.scaled_dot_product_attention(is_causal=True)",
        "long": fa_timings(gen, 2, 2048, 16, 64), "cases": rows}


def fa_timings(gen, b, s, h, d) -> dict:
    dtype = torch.bfloat16
    q, k, v = (randn(gen, b, s, h, d, dtype=dtype) for _ in range(3))
    err = (flash_attention(q, k, v).float()
           - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound_ms, bound_by = bound(nbytes(q, k, v, q),
                               4 * d * h * b * attention_pairs(s, True, None),
                               dtype)
    return {
        "shape": [b, s, h, h, d], "dtype": "bf16",
        "max_abs_err": err, "max_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))}


def quantize(x):
    scale = torch.clamp_min(x.float().abs().amax(-1) / 127.0, 1e-8)
    qx = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127)
    return qx.to(torch.int8), scale


def decode_work(ci, T, kh, d, window, h, elem) -> tuple:
    """(bytes, ops) that one decode call needs: the valid slots of K and
    V (and their scales when elem == 1), q and the output."""
    pos = ref.ring_positions(ci, T)
    valid = (pos >= 0) & (pos <= ci.long()[:, None])
    if window is not None:
        valid &= pos > ci.long()[:, None] - window
    n_valid = int(valid.sum())
    b = ci.shape[0]
    kv = 2 * n_valid * kh * (d * elem + (4 if elem == 1 else 0))
    return kv + 2 * b * h * d * 2 + 4 * b, 4.0 * d * h * n_valid


def check_flash_decode(gen) -> dict:
    # (B, H, KH, D, T, window, cache_index): the path's cache at its last
    # step and mid-prompt, a large batch over a long cache with ring
    # wrap, GQA with a window over a wrapped ring, and the other head dims
    rng = np.random.default_rng(0)
    cases = [(8, 16, 16, 64, CACHE_LEN, None, [CACHE_LEN - 1] * 8),
             (8, 16, 16, 64, CACHE_LEN, None, list(range(0, 80, 10))),
             (64, 16, 16, 64, 2048, None,
              rng.integers(0, 3 * 2048, 64).tolist()),
             (8, 16, 4, 64, 512, 128, rng.integers(0, 2000, 8).tolist()),
             (3, 8, 1, 128, 100, None, [0, 99, 250]),
             (2, 4, 2, 32, 40, 12, [7, 90])]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for int8 in (False, True):
            for b, h, kh, d, T, w, ci in cases:
                q = randn(gen, b, h, d, dtype=dtype)
                kc = randn(gen, b, T, kh, d, dtype=dtype)
                vc = randn(gen, b, T, kh, d, dtype=dtype)
                cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
                ks = vs = None
                if int8:
                    (kc, ks), (vc, vs) = quantize(kc), quantize(vc)
                out = flash_decode(q, kc, vc, cit, window=w, k_scale=ks,
                                   v_scale=vs)
                torch.cuda.synchronize()
                plain = ref.flash_decode_ref(q, kc, vc, cit, window=w,
                                             k_scale=ks, v_scale=vs)
                err = (out.float() - plain.float()).abs().max().item()
                row = {"shape": [b, h, kh, d, T], "window": w,
                       "dtype": str(dtype), "int8": int8,
                       "max_abs_err": err, "tol": TOL[dtype]}
                rows.append(row)
                print(f"[flash_decode] {row}")
                assert err <= TOL[dtype], row
    # timings in bf16 at the serving path's shape (all 8 requests, last
    # step) and at a large batch over a long, wrapped ring
    main = fd_timings(gen, 8, 16, 64, CACHE_LEN, [CACHE_LEN - 1] * 8)
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:103",
        "launches": None, **main,
        "library_call": "F.scaled_dot_product_attention(attn_mask=ring mask)",
        "long": fd_timings(gen, 64, 16, 64, 2048,
                           rng.integers(0, 3 * 2048, 64).tolist()),
        "cases": rows}


def fd_timings(gen, b, h, d, T, ci) -> dict:
    dtype = torch.bfloat16
    q = randn(gen, b, h, d, dtype=dtype)
    kc, vc = (randn(gen, b, T, h, d, dtype=dtype) for _ in range(2))
    cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
    err = (flash_decode(q, kc, vc, cit).float()
           - ref.flash_decode_ref(q, kc, vc, cit).float()).abs().max().item()
    n_bytes, n_ops = decode_work(cit, T, h, d, None, h, kc.element_size())
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    pos = ref.ring_positions(cit, T)
    mask = ((pos >= 0) & (pos <= cit.long()[:, None]))[:, None, None, :]
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    return {
        "shape": [b, h, h, d, T], "dtype": "bf16",
        "max_abs_err": err, "max_err": err,
        "ms": time_ms(lambda: flash_decode(q, kc, vc, cit)),
        "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, kc, vc, cit)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))}


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------
class CheckedEngine(PathServingEngine):
    """The one-shot engine, keeping a device-side flag of whether every
    decode step's logits were finite (read once, after generate)."""

    def _decode(self, params, tok, cache, idx):
        logits, cache = super()._decode(params, tok, cache, idx)
        self.finite = self.finite & torch.isfinite(logits).all()
        return logits, cache


def reset_counts():
    flash_attention.launches = 0
    flash_decode.launches = 0


def counts() -> dict:
    return {"flash_attention": flash_attention.launches,
            "flash_decode": flash_decode.launches}


def serve(cfg) -> dict:
    paths = [api.init_model(cfg, seed=p, device="cuda")
             for p in range(NUM_PATHS)]
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=PROMPT_LEN, seed=0)
    # router from generated weights over the first path's prefix features
    feats = prefix_features(paths[0], cfg, corpus.sample_documents(64,
                                                                   seed=1))
    gen = torch.Generator(device="cuda").manual_seed(1234)
    router = DiscriminativeRouter(
        w=torch.randn((cfg.d_model, NUM_PATHS), generator=gen,
                      device="cuda"),
        b=torch.zeros(NUM_PATHS, device="cuda"), mu=feats.mean(0),
        sigma=torch.clamp_min(feats.std(0), 1e-6))
    prompts = corpus.sample_documents(REQUESTS, seed=2)
    eng = CheckedEngine(cfg, paths, options=EngineOptions(
        router=router, cache_len=CACHE_LEN))
    eng.finite = torch.ones((), dtype=torch.bool, device="cuda")
    eng.generate(prompts, max_new=2)          # warm-up: cuBLAS handles etc.
    torch.cuda.synchronize()
    runs = {}
    for name, every in (("plain", 0), ("reroute", REROUTE_EVERY)):
        reset_counts()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new=MAX_NEW, reroute_every=every)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = counts()
        new = res.tokens[:, PROMPT_LEN:]
        assert res.tokens.shape == (REQUESTS, PROMPT_LEN + MAX_NEW)
        assert ((new >= 0) & (new < cfg.vocab_size)).all(), new
        assert all(n > 0 for n in launched.values()), launched
        runs[name] = {"paths": res.paths.tolist(), "switches": res.switches,
                      "tokens_per_s": REQUESTS * MAX_NEW / dt,
                      "seconds": dt, "launches": launched}
        print(f"[serve] {name}: routed paths {res.paths.tolist()}, "
              f"switches {res.switches}, "
              f"{REQUESTS * MAX_NEW / dt:.1f} tok/s ({dt:.3f} s), "
              f"launches {launched}")
    assert bool(eng.finite), "non-finite logits during generate"
    runs["device_busy_share"] = device_busy_share(eng, prompts)
    return runs


def device_busy_share(eng, prompts) -> dict:
    """Device kernel time over wall time for one short generate, from
    torch.profiler; None where the profiler saw no device time."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new=4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    out = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
           "busy_share": device_us / wall_us if device_us else None,
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}
    print(f"[profile] {out}")
    return out


def prefill_decode_parity(cfg, dtype: str, tol: float) -> float:
    """prefill + decode steps through the kernels vs the same calls
    through the plain attention (attn_impl="full"), same weights."""
    cfg_k = cfg.replace(dtype=dtype)
    cfg_p = cfg_k.replace(attn_impl="full")
    params = api.init_model(cfg_k, seed=7, device="cuda")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=PROMPT_LEN, seed=3)
    toks = torch.as_tensor(corpus.sample_documents(REQUESTS),
                           device="cuda")
    s = PROMPT_LEN - MAX_NEW
    worst = 0.0
    with torch.inference_mode():
        lg_k, cache_k = api.prefill(params, cfg_k, {"tokens": toks[:, :s]},
                                    CACHE_LEN)
        lg_p, cache_p = api.prefill(params, cfg_p, {"tokens": toks[:, :s]},
                                    CACHE_LEN)
        for t in range(MAX_NEW):
            assert torch.isfinite(lg_k).all()
            worst = max(worst, (lg_k.float() - lg_p.float()).abs().max()
                        .item())
            tok = toks[:, s + t:s + t + 1]
            ci = torch.full((REQUESTS,), s + t, dtype=torch.int32,
                            device="cuda")
            lg_k, cache_k = api.serve_step(params, cfg_k, {"tokens": tok},
                                           cache_k, ci)
            lg_p, cache_p = api.serve_step(params, cfg_p, {"tokens": tok},
                                           cache_p, ci)
    print(f"[prefill+decode] {dtype}: kernels vs plain max |dlogit| "
          f"{worst:.3e} (tol {tol})")
    assert worst <= tol, (dtype, worst, tol)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{list(build.SOURCES)}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_flash_attention(gen), check_flash_decode(gen)]

    cfg = get_config("dipaco-150m").replace(attn_impl="pallas",
                                            dtype="bfloat16")
    runs = serve(cfg)
    for k in kernels:
        k["launches"] = runs["plain"]["launches"][k["name"]]
        k["launches_reroute"] = runs["reroute"]["launches"][k["name"]]
    # f32: summation order only, over 12 blocks; bf16: one bf16 rounding
    # of each block's attention output, carried through 12 blocks
    parity = {"float32": prefill_decode_parity(cfg, "float32", 1e-3),
              "bfloat16": prefill_decode_parity(cfg, "bfloat16", 0.25)}

    summary = {"kernels": kernels}
    print(json.dumps({"serve": runs, "prefill_decode_max_dlogit": parity}))
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
