"""Checkpoint-row schema exhaustiveness pass (CKPT2xx); the port's copy
of ``repro/analysis/ckpt_schema.py``.

Bit-exact kill-and-resume replays the CheckpointDB row order; a
``CkptRow`` kind that is emitted but never dispatched on restore is
state that silently vanishes across a resume, and a restore branch for
a kind nothing emits is dead (usually a renamed kind).

*Emissions* are ``CkptRow(kind="x")`` constructions and keyword-style
``.write(...)`` calls: any ``kind="x"`` keyword counts, and a ``.write``
call whose keywords include ``path_id`` (the CheckpointDB signature)
with *no* ``kind`` emits the dataclass default ``"train"`` — plain
file ``.write(text)`` calls don't match.

*Handlers* are string literals compared (``==``/``!=``/``in``) against
a ``.kind`` attribute, or ``rows(kind="x")`` selections, inside any
function whose name matches ``restore|resume|replay``.

**CKPT201** (error): kind emitted, no handler.
**CKPT202** (error): handler for a kind nothing emits.
"""
from __future__ import annotations

import ast
import re
from collections import defaultdict

from . import Finding, Project, attr_chain

HANDLER_RE = re.compile(r"restore|resume|replay", re.I)


def collect(project: Project):
    """-> (emitted, handled): kind -> [(rel, line, scope)]."""
    emitted: dict[str, list] = defaultdict(list)
    handled: dict[str, list] = defaultdict(list)
    for m in project.modules:
        if not m.rel.startswith("src/"):
            continue
        # walk functions so we know the enclosing scope + handler-ness
        stack: list[tuple[str, bool]] = []

        def scope() -> str:
            return stack[-1][0] if stack else "<module>"

        def in_handler() -> bool:
            return any(h for _, h in stack)

        def visit(node: ast.AST, cls: str | None) -> None:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    visit(sub, node.name)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{cls}.{node.name}" if cls else node.name
                stack.append((qual, bool(HANDLER_RE.search(node.name))))
                for sub in node.body:
                    visit(sub, cls)
                stack.pop()
                return
            for sub in ast.iter_child_nodes(node):
                visit(sub, cls)
            if isinstance(node, ast.Call):
                ch = attr_chain(node.func)
                kws = {k.arg: k.value for k in node.keywords if k.arg}
                kind = kws.get("kind")
                k = kind.value if isinstance(kind, ast.Constant) and \
                    isinstance(kind.value, str) else None
                if ch and ch[-1] == "write":
                    if k is not None:
                        emitted[k].append((m.rel, node.lineno, scope()))
                    elif "path_id" in kws:
                        emitted["train"].append(
                            (m.rel, node.lineno, scope()))
                elif ch and ch[-1] == "CkptRow" and k is not None:
                    emitted[k].append((m.rel, node.lineno, scope()))
                elif ch and ch[-1] == "rows" and k is not None and \
                        in_handler():
                    handled[k].append((m.rel, node.lineno, scope()))
            elif isinstance(node, ast.Compare) and in_handler():
                sides = [node.left] + list(node.comparators)
                has_kind = any(
                    isinstance(s, ast.Attribute) and s.attr == "kind"
                    for s in sides)
                if not has_kind:
                    return
                for s in sides:
                    if isinstance(s, ast.Constant) and isinstance(
                            s.value, str):
                        handled[s.value].append(
                            (m.rel, node.lineno, scope()))
                    elif isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                        for el in s.elts:
                            if isinstance(el, ast.Constant) and \
                                    isinstance(el.value, str):
                                handled[el.value].append(
                                    (m.rel, node.lineno, scope()))

        for top in m.tree.body:
            visit(top, None)
    return emitted, handled


def run(project: Project) -> list[Finding]:
    emitted, handled = collect(project)
    findings: list[Finding] = []
    for kind in sorted(set(emitted) - set(handled)):
        rel, line, scope = emitted[kind][0]
        findings.append(Finding(
            "CKPT201", rel, line, scope, kind,
            f'CkptRow kind="{kind}" is emitted here but no '
            f"restore/resume/replay handler dispatches on it — this "
            f"state is lost across kill-and-resume"))
    for kind in sorted(set(handled) - set(emitted)):
        rel, line, scope = handled[kind][0]
        findings.append(Finding(
            "CKPT202", rel, line, scope, kind,
            f'restore handler dispatches on kind="{kind}" but nothing '
            f"emits it — dead branch (renamed kind?)"))
    out = []
    for f in findings:
        mod = project.module_for(f.path)
        if mod is not None and mod.is_suppressed(f):
            continue
        out.append(f)
    return out
