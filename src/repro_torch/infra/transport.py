"""Delta transport backends for the training service; the port of
``repro/infra/transport.py``.

The service's workers hand their outer-delta wire payloads to the
executors through a ``Transport``.  Two backends, both in one process:

``InProcessTransport``
    The dequantized fp32 wire tree is passed by reference, bytes are
    *simulated* from the fragment layout (``core.fragments._wire_bytes``).
    Zero copies.

``MeshTransport``
    The wire is the *encoded* representation
    (``core.fragments.encode_wire``: int8 ``q`` buffers + per-leaf
    scales, nibble-packed for int4).  ``ship`` moves the payload to the
    reporting shard's device, then to the executors' device (a real
    copy between cards where there are several), with *measured* payload
    bytes, and decodes it there.  ``decode_wire . encode_wire`` is
    bitwise ``fake_quantize``, so the executors fold the same values as
    with the in-process backend and resume stays bit-exact; only the
    bytes become real.

Either backend can be wrapped in a ``RetryingTransport``, which adds a
retry/exponential-backoff policy, receiver-side crc32 checksum
validation, and a deterministic seedable ``FaultInjector`` (drop,
duplicate, delay, corrupt-then-checksum-reject).  Failed attempts are
retried with the *same* payload, duplicate deliveries are surfaced to
the caller (the executors' fold dedup makes them no-ops), and retry
exhaustion raises a typed :class:`TransportError`; none of it perturbs
the delivered values, so chaos runs stay bit-exact with calm ones.

Resume replay never goes through a transport: ``_restore_from_db``
folds the persisted fp32 wire rows directly.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.core.fragments import (decode_wire, payload_checksum,
                                        payload_nbytes)
from repro_torch.obs import as_telemetry

TRANSPORTS = ("inproc", "mesh")


def make_transport(name: str, *, comm_dtype="fp32", devices=None,
                   retries: int = 0, faults=None, sleep=None,
                   telemetry=None):
    """Build a transport backend; ``retries > 0`` or a ``faults`` spec
    wraps it in a :class:`RetryingTransport`.  ``faults`` is a mapping
    of :class:`FaultInjector` kwargs (``seed``/``drop``/``dup``/
    ``delay``/``corrupt``/``delay_s``).  ``devices`` are the mesh
    transport's (default: every visible CUDA device).  ``telemetry``
    (repro_torch.obs) records ``transport.ship`` spans (mesh) and
    ``transport.retry`` instants (retry layer)."""
    if name == "inproc":
        base = InProcessTransport()
    elif name == "mesh":
        base = MeshTransport(comm_dtype, devices=devices,
                             telemetry=telemetry)
    else:
        raise ValueError(f"transport {name!r} not in {TRANSPORTS}")
    if retries or faults:
        injector = FaultInjector(**dict(faults)) if faults else None
        return RetryingTransport(
            base, policy=RetryPolicy(retries=int(retries)),
            injector=injector, comm_dtype=comm_dtype,
            telemetry=telemetry,
            **({"sleep": sleep} if sleep is not None else {}))
    return base


class InProcessTransport:
    """Identity hand-off: the wire tree the worker computed IS what the
    executors fold.  Byte accounting stays with the service's simulated
    ``comm_stats``."""

    name = "inproc"

    def __init__(self):
        self.stats = {"sends": 0, "payload_bytes": 0}

    def ship(self, shard: int, wire, payload, *, phase=None):
        self.stats["sends"] += 1
        return wire


class MeshTransport:
    """Encoded-payload transfer between devices, in one process.

    The worker-side encoder (``quantize_with_feedback(...,
    return_payload=True)``) produced ``payload``; ``ship`` moves it to
    the shard's home device (round-robin over ``devices``), then to the
    executors' device (``devices[0]``, where the module store lives; a
    real copy between cards where there are several), decodes it there
    and waits for the copies and the decode to finish before it returns,
    so the measured send is complete before the executors fold it.  With
    one device every hop stays on it and the backend keeps the
    in-process semantics.
    """

    name = "mesh"

    def __init__(self, comm_dtype, *, devices=None, telemetry=None):
        self.comm_dtype = comm_dtype
        if devices:
            self.devices = [torch.device(d) for d in devices]
        else:
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        if not self.devices:
            raise RuntimeError(
                "MeshTransport needs a device: no CUDA device is available; "
                "pass devices=[torch.device('cpu')] to run on the CPU")
        self.exec_device = self.devices[0]
        self.tel = as_telemetry(telemetry)
        self._lock = threading.Lock()
        self.stats = {"sends": 0, "payload_bytes": 0, "device_hops": 0}

    def worker_device(self, shard: int) -> torch.device:
        return self.devices[shard % len(self.devices)]

    def ship(self, shard: int, wire, payload, *, phase=None):
        with self.tel.span("transport.ship", shard=shard, phase=phase):
            return self._ship(shard, wire, payload)

    def _ship(self, shard: int, wire, payload):
        src = self.worker_device(shard)
        # the payload originates on the worker's device ...
        payload = pytree.tree_map(lambda x: x.to(src), payload)
        # ... and this copy IS the wire transfer
        moved = pytree.tree_map(lambda x: x.to(self.exec_device), payload)
        nbytes = payload_nbytes(moved, self.comm_dtype)
        decoded = decode_wire(moved, self.comm_dtype, like=wire)
        for dev in {src, self.exec_device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with self._lock:
            self.stats["sends"] += 1
            self.stats["payload_bytes"] += int(nbytes)
            self.stats["device_hops"] += int(src != self.exec_device)
        return decoded


# ---------------------------------------------------------------------
# chaos layer: typed errors, retry policy, deterministic fault injection
# ---------------------------------------------------------------------

class TransportError(RuntimeError):
    """A send failed permanently: every retry of the policy was spent
    on drops/corruptions.  Carries enough context for the fleet layer
    to attribute the failure to a worker."""

    def __init__(self, msg: str, *, shard: int, phase=None,
                 attempts: int = 0, reason: str = "unknown"):
        super().__init__(msg)
        self.shard = int(shard)
        self.phase = phase
        self.attempts = int(attempts)
        self.reason = reason


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: attempt ``k`` (0-based) sleeps
    ``min(base * factor**k, max_delay)`` before retrying.  ``retries``
    is the number of *re*-sends after the first attempt."""

    retries: int = 3
    base: float = 0.01
    factor: float = 2.0
    max_delay: float = 0.5

    def backoff(self, attempt: int) -> float:
        return min(self.base * self.factor ** attempt, self.max_delay)


_FAULT_ACTIONS = ("drop", "dup", "delay", "corrupt")


class FaultInjector:
    """Deterministic, seedable fault schedule for transport sends.

    The action for a send attempt is a pure function of ``(seed,
    shard, phase, send_idx, attempt)`` where ``send_idx`` counts the
    sends of that (shard, phase) in order — so the same chaos schedule
    replays bit-exactly run-over-run, while a *retry* of the same send
    (``attempt`` bumps) re-rolls instead of failing forever.  Rates
    are independent probabilities partitioning [0, 1): drop wins over
    dup over delay over corrupt."""

    def __init__(self, seed: int = 0, *, drop: float = 0.0,
                 dup: float = 0.0, delay: float = 0.0,
                 corrupt: float = 0.0, delay_s: float = 0.0):
        self.seed = int(seed)
        self.rates = {"drop": float(drop), "dup": float(dup),
                      "delay": float(delay), "corrupt": float(corrupt)}
        if sum(self.rates.values()) > 1.0:
            raise ValueError("fault rates sum past 1.0")
        self.delay_s = float(delay_s)
        self._counters: dict = {}
        self._lock = threading.Lock()

    def next_send_idx(self, shard: int, phase) -> int:
        with self._lock:
            c = self._counters.get((shard, phase), 0)
            self._counters[(shard, phase)] = c + 1
            return c

    def _uniform(self, shard: int, phase, send_idx: int,
                 attempt: int) -> float:
        key = repr((self.seed, shard, phase, send_idx, attempt))
        h = hashlib.blake2b(key.encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") / 2 ** 64

    def action(self, shard: int, phase, send_idx: int,
               attempt: int) -> str:
        u = self._uniform(shard, phase, send_idx, attempt)
        edge = 0.0
        for name in _FAULT_ACTIONS:
            edge += self.rates[name]
            if u < edge:
                return name
        return "ok"

    def corrupt_payload(self, payload, shard: int, phase,
                        send_idx: int, attempt: int):
        """Bit-flip one byte of one leaf — a *copy*; the sender's
        buffer is untouched so the retry ships the pristine payload."""
        leaves, treedef = pytree.flatten(payload)
        u = self._uniform(shard, phase, send_idx, 1_000_000 + attempt)
        idx = int(u * len(leaves)) % len(leaves)
        x = leaves[idx]
        a = (x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor)
             else np.array(np.asarray(x)))   # owned copy
        # flatten *before* the byte view: 0-d leaves (per-leaf quant
        # scales) reject a dtype-changing view but reshape fine
        raw = a.reshape(-1).view(np.uint8)
        if raw.size:
            raw[int(u * raw.size) % raw.size] ^= 0xFF
        out = list(leaves)
        out[idx] = a
        return treedef.unflatten(out)


class RetryingTransport:
    """Retry/backoff + checksum validation around any base transport.

    Every delivery is checksum-verified against the sender's crc32
    (:func:`core.fragments.payload_checksum`); a mismatch (injected
    corruption, or a real bit flip) is dropped and retried with the
    same payload.  ``last`` exposes the most recent send's outcome —
    the service reads it under its commit lock to replay duplicate
    deliveries into the executors (whose fold dedup makes the second
    copy a no-op).  Stats separate goodput (the inner transport's
    ``sends``/``payload_bytes``) from chaos overhead (``retries``,
    ``retry_bytes``, per-action counters)."""

    name = "retry"

    def __init__(self, inner, *, policy: RetryPolicy | None = None,
                 injector: FaultInjector | None = None,
                 comm_dtype="fp32", sleep=time.sleep, telemetry=None):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.injector = injector
        self.comm_dtype = comm_dtype
        self.tel = as_telemetry(telemetry)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._stats = {"retries": 0, "retry_bytes": 0, "drops": 0,
                       "dups": 0, "delays": 0, "corruptions": 0,
                       "checksum_rejects": 0}
        self.last = {"actions": (), "retries": 0, "dup": False}

    @property
    def stats(self) -> dict:
        s = dict(self.inner.stats)
        with self._lock:
            s.update(self._stats)
        return s

    def ship(self, shard: int, wire, payload, *, phase=None):
        inj = self.injector
        send_idx = inj.next_send_idx(shard, phase) if inj else 0
        ref_crc = payload_checksum(payload)
        nbytes = payload_nbytes(payload, self.comm_dtype)
        actions: list = []
        attempt = 0
        dup = False
        while True:
            act = (inj.action(shard, phase, send_idx, attempt)
                   if inj else "ok")
            actions.append(act)
            if act == "delay":
                self._bump("delays")
                if inj.delay_s:
                    self._sleep(inj.delay_s)
            elif act == "drop":
                self._bump("drops")
                self._retry_or_raise(shard, phase, attempt, "drop",
                                     actions)
                attempt += 1
                continue
            elif act == "corrupt":
                # the corrupted copy burned wire bytes before the
                # receiver's checksum rejected it
                bad = inj.corrupt_payload(payload, shard, phase,
                                          send_idx, attempt)
                self._bump("corruptions")
                self._bump("retry_bytes", nbytes)
                if payload_checksum(bad) != ref_crc:
                    self._bump("checksum_rejects")
                self._retry_or_raise(shard, phase, attempt, "corrupt",
                                     actions)
                attempt += 1
                continue
            elif act == "dup":
                dup = True
                self._bump("dups")
            # delivery: receiver re-validates the checksum before decode
            if payload_checksum(payload) != ref_crc:  # pragma: no cover
                self._bump("checksum_rejects")
                self._retry_or_raise(shard, phase, attempt, "checksum",
                                     actions)
                attempt += 1
                continue
            out = self.inner.ship(shard, wire, payload, phase=phase)
            break
        with self._lock:
            self.last = {"actions": tuple(actions), "retries": attempt,
                         "dup": dup}
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def _retry_or_raise(self, shard: int, phase, attempt: int,
                        reason: str, actions) -> None:
        if attempt >= self.policy.retries:
            with self._lock:
                self.last = {"actions": tuple(actions),
                             "retries": attempt, "dup": False}
            raise TransportError(
                f"send to executor failed after {attempt + 1} attempts "
                f"(shard={shard}, phase={phase}, reason={reason})",
                shard=shard, phase=phase, attempts=attempt + 1,
                reason=reason)
        with self._lock:
            self._stats["retries"] += 1
        b = self.policy.backoff(attempt)
        self.tel.instant("transport.retry", shard=shard, phase=phase,
                         attempt=attempt, reason=reason, backoff_s=b)
        if b:
            self._sleep(b)
