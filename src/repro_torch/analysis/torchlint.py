"""Capture-discipline pass (TORCH1xx): the port's counterpart of
``repro/analysis/jaxlint.py``.

Finds the *captured set*: the bodies of ``with torch.cuda.graph(...)``
blocks, functions passed to ``torch.compile`` (or decorated with it) or
to ``torch.cuda.make_graphed_callables``, and anything annotated
``# analysis: captured``; then propagates reachability through
in-project calls.  Code in a CUDA graph runs once at capture and never
again on replay, and the device cannot wait for the host inside one.
Inside captured bodies it flags

* **TORCH101** Python side effects: ``print``/``open``, ``time.*``,
  stdlib ``random.*`` / ``np.random.*``, ``global``/``nonlocal``
  statements: they run at capture only;
* **TORCH102** host syncs: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize()``, ``float()/int()/bool()``
  of a tensor, and ``if``/``while``/``assert`` on one;
* **TORCH103** ``np.*`` calls on tensor values;

and over the whole tree

* **TORCH104** a ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``
  or ``torch.compile(...)`` built inside a ``for``/``while`` body;
* **TORCH105** (``tools/`` and ``chip_smoke.py`` only) a function that
  reads the host clock twice or more with neither
  ``torch.cuda.synchronize()`` (directly, or through an in-project
  function that calls it) nor CUDA events between the first read and
  the last: it times the launches, not the device's work.

Taint is origin-based: values born from ``torch.*`` calls (``torch``
and its submodules under any import alias) and everything derived from
them.  Bare parameters are *not* tainted.  ``.shape``/``.dtype``/
``.device``/``.ndim`` and ``.size()``/``.dim()``/``.numel()`` are host
values and drop taint, as do ``len``/``isinstance``; ``is``/``is not``
comparisons read no data.

``src/repro_torch/kernels`` is skipped wholesale: the kernel wrappers
do host arithmetic on shapes and pointers by design.
"""
from __future__ import annotations

import ast

from . import Finding, Project, SourceModule, attr_chain

SHAPE_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
               "requires_grad", "name"}
SHAPE_METHODS = {"size", "dim", "numel", "element_size", "stride",
                 "is_contiguous", "data_ptr", "get_device"}
CONCRETE_CALLS = {"isinstance", "len", "type", "hasattr", "getattr", "id",
                  "callable"}
SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
CLOCKS = {"time", "perf_counter", "monotonic", "process_time",
          "perf_counter_ns", "time_ns", "monotonic_ns"}


def _is_graph_ctx(node: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``)."""
    ch = attr_chain(node.func) if isinstance(node, ast.Call) else None
    return bool(ch) and ch[-2:] == ["cuda", "graph"]


def _capture_fn(func: ast.AST) -> str | None:
    """The capturing call a function is handed to, if ``func`` is one."""
    ch = attr_chain(func)
    if not ch:
        return None
    if ch == ["torch", "compile"]:
        return "compile"
    if ch[-1] == "make_graphed_callables" and "cuda" in ch:
        return "graphed"
    return None


def _builds_graph(node: ast.Call) -> bool:
    ch = attr_chain(node.func)
    return bool(ch) and (ch == ["torch", "compile"]
                         or ch[-2:] in (["cuda", "CUDAGraph"],
                                        ["cuda", "graph"]))


class TorchLint:
    def __init__(self, project: Project):
        self.project = project
        self.findings: list[Finding] = []
        # captured worklist entries: (module, body-node, qualname)
        self.captured: dict[int, tuple] = {}
        self.scanned: set[int] = set()

    # -- seeds ----------------------------------------------------------
    def _skip(self, m: SourceModule) -> bool:
        return m.rel.startswith("src/repro_torch/kernels")

    def _torch_alias(self, m: SourceModule, name: str) -> bool:
        if name == "torch":
            return True
        tgt = self.project.imports.get(m.rel, {}).get(name)
        if not tgt:
            return False
        mod = tgt[1] if tgt[0] == "mod" else f"{tgt[1]}.{tgt[2]}"
        return mod == "torch" or mod.startswith("torch.")

    def _seed_module(self, m: SourceModule) -> None:
        local_defs = self._local_defs(m)
        for node in ast.walk(m.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    base = dec.func if isinstance(dec, ast.Call) else dec
                    if _capture_fn(base) == "compile":
                        self._mark(m, node, self._qual(m, node))
                if m.has_directive(node.lineno, "captured"):
                    self._mark(m, node, self._qual(m, node))
            elif isinstance(node, ast.With):
                if any(_is_graph_ctx(it.context_expr) for it in node.items):
                    self._mark(m, node, self._enclosing(m, node))
            elif isinstance(node, ast.Call) and _capture_fn(node.func):
                for a in list(node.args) + [k.value for k in node.keywords]:
                    self._mark_callable(m, a, local_defs)

    def _qual(self, m: SourceModule, node: ast.AST) -> str:
        for (rel, qual), fi in self.project.functions.items():
            if rel == m.rel and fi.node is node:
                return qual
        return getattr(node, "name", "<module>")

    def _local_defs(self, m: SourceModule) -> dict[str, tuple]:
        defs: dict[str, tuple] = {}
        for node in ast.walk(m.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, (m, node))
        return defs

    def _mark_callable(self, m: SourceModule, a: ast.AST,
                       local_defs: dict) -> None:
        if isinstance(a, ast.Lambda):
            self._mark(m, a, "<lambda>")
        elif isinstance(a, ast.Name):
            fi = self.project.resolve_name(m, a.id)
            if fi is not None and not self._skip(fi.module):
                self._mark(fi.module, fi.node, fi.qualname)
            else:
                hit = local_defs.get(a.id)
                if hit is not None:
                    self._mark(hit[0], hit[1], self._qual(hit[0], hit[1]))
        elif isinstance(a, ast.Attribute):
            ch = attr_chain(a)
            if ch and ch[0] == "self" and len(ch) == 2:
                for (rel, qual), fi in self.project.functions.items():
                    if rel == m.rel and qual.endswith("." + ch[1]):
                        self._mark(fi.module, fi.node, fi.qualname)

    def _mark(self, m: SourceModule, node: ast.AST, qual: str) -> None:
        if self._skip(m) or id(node) in self.captured:
            return
        self.captured[id(node)] = (m, node, qual)

    # -- propagation + scanning -----------------------------------------
    def run(self) -> list[Finding]:
        mods = [m for m in self.project.modules if not self._skip(m)]
        for m in mods:
            self._seed_module(m)
        # fixpoint: scanning a captured body may mark new functions
        while True:
            todo = [v for k, v in self.captured.items()
                    if k not in self.scanned]
            if not todo:
                break
            for m, node, qual in todo:
                self.scanned.add(id(node))
                self._scan_captured(m, node, qual)
        for m in mods:
            self._graph_in_loop(m)
            if m.rel.startswith("tools/") or m.rel == "chip_smoke.py":
                self._unsynced_clocks(m)
        out = []
        for f in self.findings:
            mod = self.project.module_for(f.path)
            if mod is not None and mod.is_suppressed(f):
                continue
            out.append(f)
        return out

    # -- captured-body scan ----------------------------------------------
    def _scan_captured(self, m: SourceModule, fn: ast.AST,
                       qual: str) -> None:
        taint: set[str] = set()
        local_defs = self._local_defs(m)

        def tainted(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in taint
            if isinstance(e, ast.Attribute):
                if e.attr in SHAPE_ATTRS:
                    return False
                return tainted(e.value)
            if isinstance(e, ast.Call):
                ch = attr_chain(e.func)
                if ch and len(ch) == 1 and ch[0] in CONCRETE_CALLS:
                    return False
                if isinstance(e.func, ast.Attribute) and \
                        e.func.attr in SHAPE_METHODS:
                    return False
                if ch and len(ch) > 1 and self._torch_alias(m, ch[0]):
                    return True
                if isinstance(e.func, ast.Attribute) and \
                        tainted(e.func.value):
                    return True
                return any(tainted(a) for a in e.args) or any(
                    tainted(k.value) for k in e.keywords)
            if isinstance(e, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False
            if isinstance(e, (ast.BinOp, ast.BoolOp, ast.UnaryOp,
                              ast.Compare, ast.IfExp, ast.Tuple,
                              ast.List, ast.Set, ast.Starred,
                              ast.Subscript, ast.JoinedStr,
                              ast.FormattedValue)):
                return any(tainted(c) for c in ast.iter_child_nodes(e)
                           if isinstance(c, ast.expr))
            return False

        def assign_names(t: ast.AST, on: bool) -> None:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    (taint.add if on else taint.discard)(n.id)

        def emit(rule: str, node: ast.AST, detail: str, msg: str) -> None:
            self.findings.append(
                Finding(rule, m.rel, node.lineno, qual, detail, msg))

        def check_call(node: ast.Call) -> None:
            ch = attr_chain(node.func)
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in SYNC_METHODS and not node.args:
                emit("TORCH102", node, f".{node.func.attr}()",
                     f"`.{node.func.attr}()` inside a captured body waits "
                     f"for the device: a host sync in the graph")
            if ch:
                head, last = ch[0], ch[-1]
                if head in ("np", "numpy") and len(ch) >= 2 and \
                        ch[1] == "random":
                    emit("TORCH101", node, ".".join(ch),
                         f"`{'.'.join(ch)}` inside a captured body is "
                         f"drawn once, at capture")
                elif head in ("np", "numpy") and (
                        any(tainted(a) for a in node.args)
                        or any(tainted(k.value) for k in node.keywords)):
                    emit("TORCH103", node, ".".join(ch),
                         f"`{'.'.join(ch)}` on a tensor inside a captured "
                         f"body copies it to the host")
                elif head == "time" and len(ch) == 2:
                    emit("TORCH101", node, f"time.{last}",
                         f"`time.{last}` inside a captured body runs at "
                         f"capture only")
                elif head == "random" and len(ch) >= 2:
                    emit("TORCH101", node, ".".join(ch),
                         f"stdlib `{'.'.join(ch)}` inside a captured body "
                         f"is drawn once, at capture")
                elif len(ch) == 1 and last in ("print", "open"):
                    emit("TORCH101", node, last,
                         f"`{last}()` inside a captured body runs at "
                         f"capture only")
                elif len(ch) == 1 and last in ("float", "int", "bool"):
                    if any(tainted(a) for a in node.args):
                        emit("TORCH102", node, last,
                             f"`{last}()` of a tensor inside a captured "
                             f"body reads it back to the host")
                elif last == "synchronize" and "cuda" in ch:
                    emit("TORCH102", node, "synchronize",
                         "`torch.cuda.synchronize()` inside a captured "
                         "body")
            # in-project propagation
            fi = None
            if ch and len(ch) == 1:
                fi = self.project.resolve_name(m, ch[0])
                if fi is None:
                    hit = local_defs.get(ch[0])
                    if hit is not None:
                        self._mark(hit[0], hit[1],
                                   self._qual(hit[0], hit[1]))
            elif ch and ch[0] == "self" and len(ch) == 2:
                cls = qual.split(".")[0] if "." in qual else None
                for (rel, q), f2 in self.project.functions.items():
                    if rel == m.rel and cls and q == f"{cls}.{ch[1]}":
                        fi = f2
                        break
            elif ch and len(ch) == 2:
                tgt = self.project.imports.get(m.rel, {}).get(ch[0])
                if tgt:
                    dotted = tgt[1] if tgt[0] == "mod" \
                        else f"{tgt[1]}.{tgt[2]}"
                    src = self.project.mod_by_dotted.get(dotted)
                    if src is not None:
                        fi = self.project.functions.get((src.rel, ch[1]))
            if fi is not None and not self._skip(fi.module):
                self._mark(fi.module, fi.node, fi.qualname)

        def walk(stmts) -> None:
            for st in stmts:
                if isinstance(st, (ast.Global, ast.Nonlocal)):
                    emit("TORCH101", st, "nonlocal"
                         if isinstance(st, ast.Nonlocal) else "global",
                         "rebinding outer names inside a captured body "
                         "happens at capture, never on replay")
                elif isinstance(st, ast.Assign):
                    on = tainted(st.value)
                    for t in st.targets:
                        assign_names(t, on)
                    visit_exprs(st)
                elif isinstance(st, ast.AnnAssign):
                    if st.value is not None:
                        assign_names(st.target, tainted(st.value))
                    visit_exprs(st)
                elif isinstance(st, ast.AugAssign):
                    if tainted(st.value) or tainted(st.target):
                        assign_names(st.target, True)
                    visit_exprs(st)
                elif isinstance(st, (ast.If, ast.While)):
                    kind = "if" if isinstance(st, ast.If) else "while"
                    if tainted(st.test):
                        emit("TORCH102", st, kind,
                             f"`{kind}` on a tensor inside a captured body "
                             f"reads it back to the host; use torch.where")
                    visit_expr(st.test)
                    walk(st.body)
                    walk(st.orelse)
                elif isinstance(st, ast.Assert):
                    if tainted(st.test):
                        emit("TORCH102", st, "assert",
                             "`assert` on a tensor inside a captured body "
                             "reads it back to the host")
                    visit_expr(st.test)
                elif isinstance(st, ast.For):
                    assign_names(st.target, tainted(st.iter))
                    visit_expr(st.iter)
                    walk(st.body)
                    walk(st.orelse)
                elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(st.body)   # nested def: captured too
                elif isinstance(st, ast.With):
                    for it in st.items:
                        visit_expr(it.context_expr)
                    walk(st.body)
                elif isinstance(st, ast.Try):
                    walk(st.body)
                    for h in st.handlers:
                        walk(h.body)
                    walk(st.orelse)
                    walk(st.finalbody)
                elif isinstance(st, ast.Return) and st.value is not None:
                    visit_expr(st.value)
                else:
                    visit_exprs(st)

        def visit_expr(e: ast.AST) -> None:
            for node in ast.walk(e):
                if isinstance(node, ast.Call):
                    check_call(node)

        def visit_exprs(st: ast.AST) -> None:
            for e in ast.iter_child_nodes(st):
                if isinstance(e, ast.expr):
                    visit_expr(e)

        body = fn.body if isinstance(fn.body, list) else [
            ast.Return(value=fn.body, lineno=fn.lineno, col_offset=0)]
        walk(body)

    # -- TORCH104: a graph or compiled function built inside a loop ------
    def _graph_in_loop(self, m: SourceModule) -> None:
        seen: set[int] = set()
        for loop in ast.walk(m.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if isinstance(node, ast.Call) and _builds_graph(node) \
                        and id(node) not in seen:
                    seen.add(id(node))
                    what = ".".join(attr_chain(node.func))
                    self.findings.append(Finding(
                        "TORCH104", m.rel, node.lineno,
                        self._enclosing(m, node), what,
                        f"`{what}` inside a loop captures or compiles "
                        f"again every iteration; hoist it out"))

    # -- TORCH105: host clocks without a CUDA sync ------------------------
    def _syncs(self, m: SourceModule, node: ast.Call, depth: int = 0) -> bool:
        """A call that synchronizes the device with the host, or records
        or reads CUDA events: directly, or through an in-project function
        whose body does (one level down)."""
        ch = attr_chain(node.func)
        if not ch:
            return False
        if ch[-1] in ("synchronize", "elapsed_time", "Event", "record"):
            return True
        if depth == 0 and len(ch) == 1:
            fi = self.project.resolve_name(m, ch[0])
            if fi is not None:
                return any(isinstance(n, ast.Call)
                           and self._syncs(fi.module, n, 1)
                           for n in ast.walk(fi.node))
        return False

    def _unsynced_clocks(self, m: SourceModule) -> None:
        for fn in ast.walk(m.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            clocks, syncs = [], []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                cch = attr_chain(node.func)
                pos = (node.lineno, node.col_offset)
                if cch and cch[0] == "time" and cch[-1] in CLOCKS:
                    clocks.append(pos)
                elif self._syncs(m, node):
                    syncs.append(pos)
            if len(clocks) < 2:
                continue
            lo, hi = min(clocks), max(clocks)
            if not any(lo < s < hi for s in syncs):
                self.findings.append(Finding(
                    "TORCH105", m.rel, fn.lineno, self._qual(m, fn),
                    "unsynced-clock",
                    f"{len(clocks)} host clock reads with no "
                    f"torch.cuda.synchronize() or CUDA events between "
                    f"them: times the launches, not the device's work"))

    def _enclosing(self, m: SourceModule, node: ast.AST) -> str:
        best = "<module>"
        for parent in ast.walk(m.tree):
            if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if parent.lineno <= node.lineno <= (
                        parent.end_lineno or parent.lineno):
                    best = self._qual(m, parent)
        return best


def run(project: Project) -> list[Finding]:
    return TorchLint(project).run()
