"""Lock-discipline pass (LCK1xx/2xx/3xx); the port's copy of
``repro/analysis/locks.py``.

For every class that creates a ``threading.Lock/RLock/Condition`` in
``__init__`` this pass

* infers the *guarded attribute set*: attributes mutated only while a
  lock is held (lexically inside ``with self._lock:`` / a
  ``*_locked``-suffixed method) outside of init-time code;
* flags reads or mutations of guarded attributes from plain context
  (**LCK101**);
* builds a static lock-acquisition-order graph — nodes are
  ``Class.attr`` lock sites, edges mean "acquired while holding" — and
  reports cycles (**LCK201**, error);
* flags blocking calls (``join``, ``queue.get``/``fetch``,
  ``time.sleep``, ``wait_for``, ``block_until_ready``, ``flush``) made
  while a lock is held (**LCK301**), exempting a condition waiting on
  itself.  ``flush`` covers the telemetry plane: draining a trace
  buffer is file IO and must happen after the subsystem lock is
  released (emission itself is a lock-free deque append).

Cross-object discipline is tracked two ways: ``self.attr`` types come
from ``__init__`` (constructor calls and annotated-parameter
assignment), and a local alias ``svc = self._svc`` groups ``svc.x``
accesses per ``(module, source-attr)`` so modules like ``infra/fleet``
that guard *another* object's state under *its* lock are analyzed too.

Deliberately lock-free code is suppressed inline with
``# analysis: lockfree(<reason>)`` — suppressed accesses are excluded
from inference entirely, so one documented lock-free write does not
un-guard an otherwise disciplined attribute.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from collections import defaultdict

from . import Finding, FuncInfo, Project, SourceModule, attr_chain

LOCK_CTORS = {"Lock", "RLock", "Condition"}
LOCKISH_RE = re.compile(r"lock|_cv$|cond", re.I)
MUTATORS = {"append", "add", "update", "pop", "remove", "discard", "clear",
            "extend", "insert", "setdefault", "appendleft", "popleft"}
BLOCKING_ATTRS = {"wait_for", "block_until_ready", "fetch", "flush"}
THREADISH_RE = re.compile(r"thread|worker|proc|monitor|^t$|^th$", re.I)
EXEMPT_METHODS = {"__init__", "__post_init__", "__del__", "__repr__"}


@dataclasses.dataclass(frozen=True)
class LockSite:
    node_id: str             # "Class.attr"
    cls: str
    attr: str
    kind: str                # Lock | RLock | Condition
    rel: str
    line: int


@dataclasses.dataclass
class Access:
    group: tuple             # ("self", rel, Class) | ("foreign", rel, src)
    attr: str
    is_mut: bool
    line: int
    held: tuple              # lock node ids held at the access
    func: str                # qualname
    locked_ctx: bool         # inside a *_locked-suffixed method
    exempt: bool             # init-only method or suppressed line


@dataclasses.dataclass
class FuncFacts:
    qualname: str
    module: SourceModule
    cls: str | None
    acquires: set = dataclasses.field(default_factory=set)
    callees: set = dataclasses.field(default_factory=set)   # resolved keys
    callee_names: set = dataclasses.field(default_factory=set)  # fallback
    blocking: bool = False


class LockPass:
    def __init__(self, project: Project):
        self.project = project
        self.locks: dict[str, LockSite] = {}          # node_id -> site
        self.locks_by_attr: dict[str, list[LockSite]] = defaultdict(list)
        self.attr_types: dict[tuple[str, str], dict[str, tuple]] = {}
        self.accesses: list[Access] = []
        self.edges: dict[tuple[str, str], tuple[str, int]] = {}
        self.facts: dict[tuple[str, str], FuncFacts] = {}
        self.blocking_sites: list[tuple] = []
        self.findings: list[Finding] = []

    # -- public ---------------------------------------------------------
    def run(self) -> list[Finding]:
        for m in self.project.modules:
            if not m.rel.startswith("src/"):
                continue
            self._collect_locks_and_types(m)
        for m in self.project.modules:
            if not m.rel.startswith("src/"):
                continue
            self._walk_module(m)
        self._interprocedural_edges()
        self._infer_and_flag()
        self._cycles()
        self._blocking()
        out = []
        for f in self.findings:
            mod = self.project.module_for(f.path)
            if mod is not None and mod.is_suppressed(f):
                continue
            out.append(f)
        return out

    def order_graph(self) -> dict[tuple[str, str], tuple[str, int]]:
        """edge (src, dst) -> (rel, line) provenance — consumed by the
        runtime ``lock_tracer`` companion."""
        return dict(self.edges)

    def lock_registry(self) -> dict[tuple[str, int], str]:
        """(rel, creation line) -> node id — lets the runtime tracer
        name the locks it sees being constructed."""
        return {(s.rel, s.line): s.node_id for s in self.locks.values()}

    # -- phase 1: lock sites + attribute types --------------------------
    def _collect_locks_and_types(self, m: SourceModule) -> None:
        for cls in [n for n in m.tree.body if isinstance(n, ast.ClassDef)]:
            types: dict[str, tuple] = {}
            init = next((n for n in cls.body
                         if isinstance(n, ast.FunctionDef)
                         and n.name == "__init__"), None)
            ann: dict[str, str] = {}
            if init is not None:
                for a in init.args.args + init.args.kwonlyargs:
                    t = a.annotation
                    if isinstance(t, ast.Name):
                        ann[a.arg] = t.id
                    elif isinstance(t, ast.Constant) and isinstance(
                            t.value, str):
                        ann[a.arg] = t.value
            for fn in [n for n in cls.body
                       if isinstance(n, ast.FunctionDef)]:
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        if not (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            continue
                        val = node.value
                        chain = attr_chain(val.func) if isinstance(
                            val, ast.Call) else None
                        if chain and chain[-1] in LOCK_CTORS and (
                                len(chain) == 1 or chain[0] in
                                ("threading", "th")):
                            site = LockSite(f"{cls.name}.{tgt.attr}",
                                            cls.name, tgt.attr, chain[-1],
                                            m.rel, node.lineno)
                            self.locks[site.node_id] = site
                            self.locks_by_attr[tgt.attr].append(site)
                        elif chain and len(chain) <= 2:
                            key = self.project.resolve_class(m, chain[-1])
                            if key is not None:
                                types[tgt.attr] = key
                        elif isinstance(val, ast.Name) and val.id in ann:
                            key = self.project.resolve_class(m, ann[val.id])
                            if key is not None:
                                types[tgt.attr] = key
            self.attr_types[(m.rel, cls.name)] = types

    # -- phase 2: per-function context walk -----------------------------
    def _walk_module(self, m: SourceModule) -> None:
        for node in m.tree.body:
            if isinstance(node, ast.ClassDef):
                init_only = self._init_only_methods(node)
                for fn in [n for n in node.body
                           if isinstance(n, ast.FunctionDef)]:
                    self._walk_function(m, fn, node.name,
                                        fn.name in init_only)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_function(m, node, None, False)

    def _init_only_methods(self, cls: ast.ClassDef) -> set:
        """Methods reachable *only* from ``__init__`` (helpers like
        ``_restore_from_db``) run before any other thread can hold a
        reference, so their accesses are exempt from inference."""
        callers: dict[str, set] = defaultdict(set)
        for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
            for node in ast.walk(fn):
                ch = attr_chain(node.func) if isinstance(
                    node, ast.Call) else None
                if ch and len(ch) == 2 and ch[0] == "self":
                    callers[ch[1]].add(fn.name)
        out = set(EXEMPT_METHODS)
        changed = True
        while changed:
            changed = False
            for meth, who in callers.items():
                if meth not in out and who and who <= out:
                    out.add(meth)
                    changed = True
        return out

    def _classify_lock(self, m: SourceModule, cls: str | None,
                       aliases: dict, expr: ast.AST) -> str | None:
        """Map a ``with <expr>:`` operand (or a call base) to a lock
        node id, or None if it isn't lock-shaped."""
        ch = attr_chain(expr)
        if not ch or len(ch) < 2:
            return None
        attr = ch[-1]
        owner_cls: str | None = None
        if ch[0] == "self" and len(ch) == 2:
            owner_cls = cls
        elif ch[0] == "self" and len(ch) == 3 and cls is not None:
            t = self.attr_types.get((m.rel, cls), {}).get(ch[1])
            owner_cls = t[1] if t else None
        elif ch[0] in aliases and len(ch) == 2:
            src_attr = aliases[ch[0]]
            t = self.attr_types.get((m.rel, cls), {}).get(src_attr) \
                if cls is not None else None
            owner_cls = t[1] if t else None
        if owner_cls is not None and f"{owner_cls}.{attr}" in self.locks:
            return f"{owner_cls}.{attr}"
        if not LOCKISH_RE.search(attr):
            return None
        sites = self.locks_by_attr.get(attr, ())
        if len(sites) == 1:
            return sites[0].node_id
        return f"?.{attr}" if sites or LOCKISH_RE.search(attr) else None

    def _walk_function(self, m: SourceModule, fn: ast.FunctionDef,
                       cls: str | None, init_only: bool) -> None:
        qual = f"{cls}.{fn.name}" if cls else fn.name
        facts = FuncFacts(qual, m, cls)
        self.facts[(m.rel, qual)] = facts
        locked_ctx = fn.name.endswith("_locked")
        aliases: dict[str, str] = {}   # local var -> source self-attr
        lock_attr_names = ({s.attr for s in self.locks.values()
                            if s.cls == cls} if cls else set())
        consumed: set[int] = set()

        def suppressed(line: int) -> bool:
            return m.has_directive(line, "lockfree")

        def base_attr_target(t: ast.AST):
            """self.X / alias.X base of an assignment-target chain."""
            while isinstance(t, (ast.Subscript, ast.Starred)):
                t = t.value
            if isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name):
                if t.value.id == "self" and cls is not None:
                    return ("self", m.rel, cls), t.attr, t
                if t.value.id in aliases:
                    return (("foreign", m.rel, aliases[t.value.id]),
                            t.attr, t)
            return None

        def record(group, attr, is_mut, line, held):
            if group[0] == "self" and attr in lock_attr_names:
                return
            self.accesses.append(Access(
                group, attr, is_mut, line, tuple(held), qual, locked_ctx,
                init_only or suppressed(line)))

        def visit_expr(e: ast.AST, held: tuple) -> None:
            for node in ast.walk(e):
                if id(node) in consumed:
                    continue
                if isinstance(node, ast.Call):
                    self._visit_call(m, cls, qual, facts, aliases, node,
                                     held, consumed)
                    # mutator method on self.X / alias.X (possibly
                    # through a subscript: self.X[k].append(v))
                    if isinstance(node.func, ast.Attribute) and \
                            node.func.attr in MUTATORS:
                        base = node.func.value
                        while isinstance(base, ast.Subscript):
                            base = base.value
                        if isinstance(base, ast.Attribute) and \
                                isinstance(base.value, ast.Name):
                            if base.value.id == "self" and \
                                    cls is not None:
                                consumed.add(id(base))
                                record(("self", m.rel, cls), base.attr,
                                       True, node.lineno, held)
                            elif base.value.id in aliases:
                                consumed.add(id(base))
                                record(("foreign", m.rel,
                                        aliases[base.value.id]),
                                       base.attr, True, node.lineno,
                                       held)
                elif isinstance(node, ast.Attribute) and isinstance(
                        node.value, ast.Name):
                    if node.value.id == "self" and cls is not None:
                        record(("self", m.rel, cls), node.attr, False,
                               node.lineno, held)
                    elif node.value.id in aliases:
                        record(("foreign", m.rel, aliases[node.value.id]),
                               node.attr, False, node.lineno, held)

        def visit_stmts(stmts, held: tuple) -> None:
            for st in stmts:
                if isinstance(st, ast.With):
                    inner = list(held)
                    rest_exprs = []
                    for item in st.items:
                        lid = self._classify_lock(m, cls, aliases,
                                                  item.context_expr)
                        if lid is not None:
                            for h in inner:
                                if h != lid:
                                    self._add_edge(h, lid, m.rel,
                                                   st.lineno)
                            facts.acquires.add(lid)
                            inner.append(lid)
                        else:
                            rest_exprs.append(item.context_expr)
                    for e in rest_exprs:
                        visit_expr(e, tuple(inner))
                    visit_stmts(st.body, tuple(inner))
                elif isinstance(st, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # nested def (listener/closure): runs later under
                    # unknown locks -> analyze with no held context
                    visit_stmts(st.body, ())
                elif isinstance(st, ast.Assign):
                    # alias tracking: svc = self._svc
                    if (len(st.targets) == 1
                            and isinstance(st.targets[0], ast.Name)):
                        ch = attr_chain(st.value)
                        if ch and len(ch) == 2 and ch[0] == "self":
                            aliases[st.targets[0].id] = ch[1]
                    for t in st.targets:
                        hit = base_attr_target(t)
                        if hit is not None:
                            group, attr, nd = hit
                            consumed.add(id(nd))
                            record(group, attr, True, t.lineno, held)
                        visit_expr(t, held)
                    visit_expr(st.value, held)
                elif isinstance(st, ast.AugAssign):
                    hit = base_attr_target(st.target)
                    if hit is not None:
                        group, attr, nd = hit
                        consumed.add(id(nd))
                        record(group, attr, True, st.lineno, held)
                    visit_expr(st.target, held)
                    visit_expr(st.value, held)
                elif isinstance(st, (ast.Delete,)):
                    for t in st.targets:
                        hit = base_attr_target(t)
                        if hit is not None:
                            group, attr, nd = hit
                            consumed.add(id(nd))
                            record(group, attr, True, st.lineno, held)
                        visit_expr(t, held)
                elif isinstance(st, (ast.If, ast.While)):
                    visit_expr(st.test, held)
                    visit_stmts(st.body, held)
                    visit_stmts(st.orelse, held)
                elif isinstance(st, ast.For):
                    visit_expr(st.iter, held)
                    hit = base_attr_target(st.target)
                    if hit is not None:
                        group, attr, nd = hit
                        consumed.add(id(nd))
                        record(group, attr, True, st.lineno, held)
                    visit_stmts(st.body, held)
                    visit_stmts(st.orelse, held)
                elif isinstance(st, ast.Try):
                    visit_stmts(st.body, held)
                    for h in st.handlers:
                        visit_stmts(h.body, held)
                    visit_stmts(st.orelse, held)
                    visit_stmts(st.finalbody, held)
                elif isinstance(st, ast.ClassDef):
                    pass
                else:
                    for e in ast.iter_child_nodes(st):
                        if isinstance(e, ast.expr):
                            visit_expr(e, held)

        visit_stmts(fn.body, ())

    def _visit_call(self, m, cls, qual, facts, aliases, node: ast.Call,
                    held: tuple, consumed: set) -> None:
        if id(node) in consumed:
            return
        consumed.add(id(node))
        ch = attr_chain(node.func)
        # blocking primitives ------------------------------------------
        blocking = None
        if ch:
            last = ch[-1]
            if last == "sleep" and ch[0] == "time":
                blocking = "time.sleep"
            elif last in BLOCKING_ATTRS and len(ch) >= 2:
                blocking = ".".join(ch)
            elif last == "join" and len(ch) >= 2 and (
                    THREADISH_RE.search(ch[-2])
                    or any(k.arg == "timeout" for k in node.keywords)):
                # thread join only — str.join / os.path.join are pure
                blocking = ".".join(ch)
            elif last == "get" and len(ch) >= 2 and \
                    "queue" in ch[-2].lower():
                blocking = ".".join(ch)
            elif last == "wait" and len(ch) >= 2:
                base_id = self._classify_lock(
                    m, cls, aliases,
                    node.func.value if isinstance(node.func, ast.Attribute)
                    else node.func)
                if base_id is None or base_id not in held:
                    blocking = ".".join(ch)
        if blocking is not None:
            facts.blocking = True
            if held:
                self.blocking_sites.append(
                    (m.rel, qual, node.lineno, tuple(held), blocking))
        # callee resolution for interprocedural edges ------------------
        key = self._resolve_callee(m, cls, aliases, node)
        if key is not None:
            facts.callees.add(key)
            if held:
                self.blocking_sites.append(
                    (m.rel, qual, node.lineno, tuple(held), key))
        elif ch:
            facts.callee_names.add(ch[-1])
            if held:
                self.blocking_sites.append(
                    (m.rel, qual, node.lineno, tuple(held),
                     ("name", ch[-1])))

    def _resolve_callee(self, m, cls, aliases,
                        node: ast.Call) -> tuple | None:
        ch = attr_chain(node.func)
        if not ch:
            return None
        if len(ch) == 1:
            fi = self.project.resolve_name(m, ch[0])
            return (fi.module.rel, fi.qualname) if fi else None
        if ch[0] == "self" and cls is not None:
            if len(ch) == 2:
                fi = self.project.method_of((m.rel, cls), ch[1])
                return (fi.module.rel, fi.qualname) if fi else None
            if len(ch) == 3:
                t = self.attr_types.get((m.rel, cls), {}).get(ch[1])
                if t:
                    fi = self.project.method_of(t, ch[2])
                    return (fi.module.rel, fi.qualname) if fi else None
        if ch[0] in aliases and len(ch) == 2 and cls is not None:
            t = self.attr_types.get((m.rel, cls), {}).get(aliases[ch[0]])
            if t:
                fi = self.project.method_of(t, ch[1])
                return (fi.module.rel, fi.qualname) if fi else None
        return None

    # -- phase 3: interprocedural summaries -----------------------------
    def _summary(self, key: tuple, memo: dict, stack: set) -> tuple:
        if key in memo:
            return memo[key]
        if key in stack:
            return (frozenset(), False)
        facts = self.facts.get(key)
        if facts is None:
            return (frozenset(), False)
        stack.add(key)
        locks = set(facts.acquires)
        blocking = facts.blocking
        for cal in facts.callees:
            sl, sb = self._summary(cal, memo, stack)
            locks |= sl
            blocking = blocking or sb
        for name in facts.callee_names:
            # name fallback only when the project has exactly ONE
            # function by that name (common names like `start`/`stop`
            # would otherwise leak one class's summary into another)
            cand = [fi for fi in self.project.by_name.get(name, ())
                    if (fi.module.rel, fi.qualname) != key]
            if len(cand) == 1:
                fi = cand[0]
                sl, sb = self._summary((fi.module.rel, fi.qualname),
                                       memo, stack)
                locks |= sl
                blocking = blocking or sb
        stack.discard(key)
        memo[key] = (frozenset(locks), blocking)
        return memo[key]

    def _interprocedural_edges(self) -> None:
        self._memo: dict = {}
        for rel, qual, line, held, callee in list(self.blocking_sites):
            if isinstance(callee, str):
                continue
            if isinstance(callee, tuple) and callee and \
                    callee[0] == "name":
                cand = list(self.project.by_name.get(callee[1], ()))
                if len(cand) != 1:
                    continue
                key = (cand[0].module.rel, cand[0].qualname)
            else:
                key = callee
            locks, _ = self._summary(key, self._memo, set())
            for h in held:
                for dst in locks:
                    if h != dst:
                        self._add_edge(h, dst, rel, line)

    def _add_edge(self, src: str, dst: str, rel: str, line: int) -> None:
        if src.startswith("?") or dst.startswith("?"):
            return
        self.edges.setdefault((src, dst), (rel, line))

    # -- phase 4: guarded inference + LCK101 ----------------------------
    def _infer_and_flag(self) -> None:
        by_key: dict[tuple, list[Access]] = defaultdict(list)
        for a in self.accesses:
            by_key[(a.group, a.attr)].append(a)
        for (group, attr), accs in sorted(
                by_key.items(), key=lambda kv: (kv[0][0][1], kv[0][1])):
            live = [a for a in accs if not a.exempt]
            locked_mut = [a for a in live if a.is_mut and a.held]
            ctx_mut = [a for a in live if a.is_mut and not a.held
                       and a.locked_ctx]
            plain_mut = [a for a in live if a.is_mut and not a.held
                         and not a.locked_ctx]
            # majority rule: the locked mutation sites define the
            # discipline; a minority of plain writes are the defect,
            # not evidence the attr is lock-free.  An even split is
            # ambiguous -- stay silent rather than guess.
            if not (locked_mut or ctx_mut):
                continue
            if len(plain_mut) >= len(locked_mut) + len(ctx_mut):
                continue
            guard: frozenset | None = None
            if locked_mut:
                guard = frozenset(locked_mut[0].held)
                for a in locked_mut[1:]:
                    guard &= frozenset(a.held)
                if not guard:
                    guard = None
            rel = group[1]
            label = (f"{group[2]}.{attr}" if group[0] == "self"
                     else f"{group[2]}->{attr}")
            for a in live:
                if a.locked_ctx:
                    continue
                if a.is_mut and a.held:
                    continue
                if guard is None:
                    if a.held:
                        continue        # holds *a* lock; guard unknown
                elif set(a.held) & guard:
                    continue
                gtxt = ("/".join(sorted(guard)) if guard
                        else "a lock (held only in *_locked contexts)")
                verb = "mutated" if a.is_mut else "read"
                self.findings.append(Finding(
                    "LCK101", rel, a.line, a.func, label,
                    f"`{label}` is {verb} without holding {gtxt} "
                    f"(guarded at "
                    f"{len(locked_mut) + len(ctx_mut)} mutation sites)"))

    # -- phase 5: cycles ------------------------------------------------
    def _cycles(self) -> None:
        adj: dict[str, list[str]] = defaultdict(list)
        for (s, d) in self.edges:
            adj[s].append(d)
        seen: set = set()
        reported: set = set()

        def dfs(n, stack, on_stack):
            seen.add(n)
            on_stack.add(n)
            stack.append(n)
            for nb in adj.get(n, ()):
                if nb in on_stack:
                    cyc = tuple(stack[stack.index(nb):]) + (nb,)
                    key = frozenset(cyc)
                    if key not in reported:
                        reported.add(key)
                        rel, line = self.edges[(n, nb)]
                        self.findings.append(Finding(
                            "LCK201", rel, line, "<lock-order>",
                            "->".join(sorted(set(cyc))),
                            "lock-order cycle (deadlock hazard): "
                            + " -> ".join(cyc)))
                elif nb not in seen:
                    dfs(nb, stack, on_stack)
            stack.pop()
            on_stack.discard(n)

        for n in sorted(adj):
            if n not in seen:
                dfs(n, [], set())

    # -- phase 6: blocking-under-lock -----------------------------------
    def _blocking(self) -> None:
        memo = getattr(self, "_memo", {})
        emitted: set = set()
        for rel, qual, line, held, callee in self.blocking_sites:
            if isinstance(callee, str):
                label = callee
            else:
                if isinstance(callee, tuple) and callee and \
                        callee[0] == "name":
                    continue   # unresolved name: too weak to flag
                _, blocking = self._summary(callee, memo, set())
                if not blocking:
                    continue
                label = callee[1]
            if (rel, line) in emitted:
                continue       # primitive + resolved callee at one call
            emitted.add((rel, line))
            self.findings.append(Finding(
                "LCK301", rel, line, qual, label,
                f"blocking call `{label}` while holding "
                f"{'/'.join(sorted(set(held)))}"))


def run(project: Project) -> list[Finding]:
    return LockPass(project).run()
