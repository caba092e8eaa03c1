"""Flash-decode: wrapper of the CUDA kernels ``csrc/decode_attention.cu``
(replaces the TPU kernel ``repro/kernels/decode_attention.py:103
flash_decode``).

Single-token GQA attention over the ring KV cache in one kernel launch
a call, at any number of query heads a KV head (in groups of at most
``MAX_GROUP``, one block each): split-K over the cache length, the last
split of each row combining the others.  Nothing is read back to the
host, so a decode step can be captured in a CUDA graph.  Takes CUDA
tensors only; ``ops.decode_attention`` sends CPU tensors to the plain
version (``ref.flash_decode_ref``).  ``flash_decode.launches`` counts
the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_Q_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (32, 64, 128, 192, 256)
# query heads a block holds in registers: at 80 slots, B8, two a block
# were faster than four or eight at every query group and head dim the
# families serve (PERF.md section 6)
MAX_GROUP = 2


def _lib():
    fn = build.load("decode_attention").flash_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(head_dim: int, kv_dtype: torch.dtype, group: int) -> int:
    """The dynamic shared memory a block of the kernel takes (builds the
    library if it is missing)."""
    fn = build.load("decode_attention").flash_decode_smem
    fn.restype = ctypes.c_int
    n = fn(head_dim, _KV_DTYPE[kv_dtype], group)
    if n < 0:
        raise ValueError(f"no instantiation at head_dim {head_dim}, "
                         f"{kv_dtype}, {group} query heads a block")
    return n


_sm_count: dict = {}     # device index -> multiprocessors
_counters: dict = {}     # device index -> the kernel's arrival counters


def head_groups(group: int) -> int:
    """The blocks that share the ``group`` query heads of a KV head, each
    holding MAX_GROUP of them (the last may hold fewer)."""
    return -(-group // MAX_GROUP)


def num_splits(rows: int, cache_len: int, device: torch.device) -> int:
    """Splits of the cache length for ``rows`` (b, kh, head group) rows:
    about two blocks per SM in all, and at least 64 slots per split."""
    sms = _sm_count.get(device.index)
    if sms is None:
        sms = _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = -(-2 * sms // rows)
    return max(1, min(want, cache_len // 64))


def arrival_counters(device: torch.device, rows: int) -> torch.Tensor:
    """The kernel's int32 arrival counters, one per (b, kh, head group)
    row, zero at rest (the last block of a row resets its own).  One
    buffer per device, made once, so a captured CUDA graph keeps a valid
    pointer: splits > 1 only while the rows are fewer than 2 * SMs, so it
    holds 2 * SMs rows."""
    buf = _counters.get(device.index)
    if buf is None:
        buf = _counters[device.index] = torch.zeros(
            2 * _sm_count[device.index], dtype=torch.int32, device=device)
    if rows > buf.numel():
        raise ValueError(f"{rows} rows exceed the {buf.numel()} arrival "
                         f"counters")
    return buf


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_index: torch.Tensor, *,
                 window: Optional[int] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, D); caches (B, T, KH, D) f32 / bf16, or int8 with
    ``k_scale`` / ``v_scale`` (B, T, KH) f32; cache_index (B,) int32 on
    the device.  Returns (B, H, D) in q's dtype."""
    dev = q.device
    tensors = [q, k_cache, v_cache, cache_index]
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if quantized:
        tensors += [k_scale, v_scale]
    if not q.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError("flash_decode kernel takes CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _Q_DTYPE or k_cache.dtype not in _KV_DTYPE \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"bad dtypes q {q.dtype}, cache {k_cache.dtype} / "
                        f"{v_cache.dtype}")
    if quantized != (k_cache.dtype == torch.int8):
        raise TypeError("an int8 cache needs scales, and only an int8 "
                        "cache takes them")
    if k_cache.dtype != torch.int8 and k_cache.dtype != q.dtype:
        raise TypeError(f"cache dtype {k_cache.dtype} != q dtype {q.dtype}")
    if cache_index.dtype != torch.int32:
        raise TypeError(f"cache_index must be int32, got {cache_index.dtype}")
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    b, h, d = q.shape
    T, kh = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kh:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if tuple(cache_index.shape) != (b,):
        raise ValueError(f"cache_index must be ({b},), got "
                         f"{tuple(cache_index.shape)}")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32
                      or tuple(k_scale.shape) != (b, T, kh)
                      or v_scale.shape != k_scale.shape):
        raise ValueError("scales must be f32 of shape (B, T, KH)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode needs 16-byte aligned q and caches")
    groups = head_groups(h // kh)
    rows = b * kh * groups
    splits = num_splits(rows, T, dev)
    out = torch.empty_like(q)
    part = counters = None
    if splits > 1:
        # the splits' (m, l, acc) partials, one f32 workspace
        part = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                           device=dev)
        counters = arrival_counters(dev, rows)
    ks = k_scale.data_ptr() if quantized else None
    vs = v_scale.data_ptr() if quantized else None
    rc = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ks, vs,
                cache_index.data_ptr(),
                None if part is None else part.data_ptr(),
                None if counters is None else counters.data_ptr(),
                out.data_ptr(), b, T, h, kh, d, window or 0, splits, groups,
                _Q_DTYPE[q.dtype],
                _KV_DTYPE[k_cache.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    build.check_rc(rc, "flash_decode")
    build.count_launch(flash_decode)
    return out


flash_decode.launches = 0
