"""Runtime companion to the static lock pass (test-only); the port's
copy of ``repro/analysis/lock_tracer.py``.

``LockTracer.install()`` monkeypatches ``threading.Lock`` / ``RLock``
/ ``Condition`` so every lock *created from project code* is wrapped
in a recording proxy.  Each thread keeps a held-lock stack; every
acquisition while other locks are held records a runtime ordering
edge.  ``check()`` then asserts that the union of the statically
inferred acquisition-order graph (``LockPass.order_graph``) and the
runtime-observed edges is acyclic — a dynamic witness that the static
graph did not miss a deadlock-capable ordering.

Armed by tests (``tests/test_torch_analysis.py``) around the port's
threaded paths.  Not imported by library code; importing it has no side
effects until ``install()`` is called.
"""
from __future__ import annotations

import os
import sys
import threading
from pathlib import Path

from . import Project, repo_root_default
from .locks import LockPass


class _TracedLock:
    """Proxy over a real lock that reports (re)acquisition order."""

    def __init__(self, inner, node: str, tracer: "LockTracer"):
        self._inner = inner
        self._node = node
        self._tracer = tracer

    # all project code uses ``with lock:`` -- acquire/release kept for
    # completeness (e.g. tests poking at locks directly)
    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._tracer._note_acquire(self._node)
        return got

    def release(self):
        self._inner.release()
        self._tracer._note_release(self._node)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _TracedCondition(_TracedLock):
    """Condition proxy: wait/notify delegate; ordering tracked on the
    outer acquire/release only (wait's internal release-and-reacquire
    cannot introduce a new cross-thread ordering edge)."""

    def wait(self, timeout=None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


class LockTracer:
    """Singleton-ish recorder; use :meth:`install` / :meth:`uninstall`."""

    def __init__(self, root: Path | None = None):
        self.root = Path(root).resolve() if root else repo_root_default()
        lp = LockPass(Project(self.root))
        lp.run()
        self.registry = lp.lock_registry()      # (rel, line) -> node id
        self.static_edges = lp.order_graph()    # (src, dst) -> (rel, line)
        self.runtime_edges: dict[tuple, tuple] = {}
        self._tls = threading.local()
        self._real = {}
        # bookkeeping must use an *unpatched* primitive
        self._meta_lock = threading.Lock()
        self._installed = False

    # -- patching -------------------------------------------------------
    @classmethod
    def install(cls, root: Path | None = None) -> "LockTracer":
        tracer = cls(root)
        tracer._real = {"Lock": threading.Lock, "RLock": threading.RLock,
                        "Condition": threading.Condition}
        threading.Lock = tracer._factory("Lock")        # type: ignore
        threading.RLock = tracer._factory("RLock")      # type: ignore
        threading.Condition = tracer._factory("Condition")  # type: ignore
        tracer._installed = True
        return tracer

    def uninstall(self) -> None:
        if self._installed:
            threading.Lock = self._real["Lock"]          # type: ignore
            threading.RLock = self._real["RLock"]        # type: ignore
            threading.Condition = self._real["Condition"]  # type: ignore
            self._installed = False

    def _factory(self, kind: str):
        real = self._real[kind]
        src_prefix = (self.root / "src" / "repro_torch").as_posix()

        def make(*args, **kwargs):
            frame = sys._getframe(1)
            # normalised: a sys.path entry such as tests/../src puts
            # ".." into the code's file names
            fn = Path(os.path.normpath(frame.f_code.co_filename)).as_posix()
            # only trace locks constructed *directly* by project code;
            # stdlib internals (queue, executors, Condition's own
            # RLock) keep the real primitives
            if not fn.startswith(src_prefix) or "/analysis/" in fn:
                return real(*args, **kwargs)
            rel = Path(fn).relative_to(self.root).as_posix()
            node = self.registry.get((rel, frame.f_lineno),
                                     f"{rel}:{frame.f_lineno}")
            if kind == "Condition":
                return _TracedCondition(real(*args, **kwargs), node, self)
            return _TracedLock(real(*args, **kwargs), node, self)

        return make

    # -- per-thread held stack -----------------------------------------
    def _held(self) -> list:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    def _note_acquire(self, node: str) -> None:
        held = self._held()
        if any(n == node for n, _ in held):       # RLock re-entry
            for i, (n, c) in enumerate(held):
                if n == node:
                    held[i] = (n, c + 1)
                    return
        frame = sys._getframe(1)
        while frame and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        site = ((Path(frame.f_code.co_filename).name, frame.f_lineno)
                if frame else ("?", 0))
        with self._meta_lock:
            for n, _ in held:
                if n != node:
                    self.runtime_edges.setdefault((n, node), site)
        held.append((node, 1))

    def _note_release(self, node: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            n, c = held[i]
            if n == node:
                if c > 1:
                    held[i] = (n, c - 1)
                else:
                    del held[i]
                return

    # -- verdict --------------------------------------------------------
    def check(self) -> None:
        """Assert static ∪ runtime ordering is acyclic."""
        graph: dict[str, set] = {}
        prov: dict[tuple, str] = {}
        for (a, b), (rel, line) in self.static_edges.items():
            graph.setdefault(a, set()).add(b)
            prov[(a, b)] = f"static {rel}:{line}"
        with self._meta_lock:
            runtime = dict(self.runtime_edges)
        for (a, b), (fname, line) in runtime.items():
            graph.setdefault(a, set()).add(b)
            prov.setdefault((a, b), f"runtime {fname}:{line}")
        cycle = _find_cycle(graph)
        if cycle:
            edges = list(zip(cycle, cycle[1:]))
            detail = "; ".join(
                f"{a} -> {b} ({prov.get((a, b), '?')})" for a, b in edges)
            raise AssertionError(
                f"lock-order cycle (static+runtime): {detail}")


def _find_cycle(graph: dict[str, set]) -> list | None:
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: list = []

    def dfs(n):
        color[n] = GRAY
        stack.append(n)
        for m in graph.get(n, ()):
            if color.get(m, WHITE) == GRAY:
                return stack[stack.index(m):] + [m]
            if color.get(m, WHITE) == WHITE:
                got = dfs(m)
                if got:
                    return got
        stack.pop()
        color[n] = BLACK
        return None

    for n in list(graph):
        if color[n] == WHITE:
            got = dfs(n)
            if got:
                return got
    return None
