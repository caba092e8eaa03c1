"""Project-native static analysis of the PyTorch port; the port's own
copy of ``repro/analysis``.

Three AST passes guard the invariants the test suite can't see:

``locks``        lock-discipline: guarded-attribute inference, a static
                 lock-acquisition-order graph with cycle detection, and
                 locks held across blocking calls.
``torchlint``    capture discipline: side effects / host syncs /
                 ``np.*`` inside CUDA-graph captures and
                 ``torch.compile`` bodies, graphs or compiled functions
                 built in loops, host clocks read with no
                 ``torch.cuda.synchronize`` or CUDA events between.
``ckpt_schema``  checkpoint-row exhaustiveness: every emitted
                 ``CkptRow`` kind must have a restore handler (and
                 every handler a live emitter) or bit-exact resume
                 silently drops state.

Run ``python -m repro_torch.analysis`` (see ``__main__``).  Suppression
is inline (``# analysis: lockfree(reason)`` / ``# analysis:
ignore[RULE](reason)``) or via the committed
``analysis/baseline_torch.json`` fingerprint file; ``# analysis:
captured`` marks a function as part of the captured set of the
torchlint pass even when no capture site is visible in-tree.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from collections import defaultdict
from pathlib import Path

# rules not listed here default to "warning"
SEVERITY = {
    "LCK201": "error",   # lock-order cycle == deadlock hazard
    "CKPT201": "error",  # emitted row kind with no restore handler
    "CKPT202": "error",  # restore handler with no live emitter
}

RULE_CATALOG = {
    "LCK101": "guarded attribute accessed outside its lock",
    "LCK201": "cycle in the static lock-acquisition-order graph",
    "LCK301": "blocking call while holding a lock",
    "TORCH101": "Python side effect inside a captured body",
    "TORCH102": "host sync inside a captured body",
    "TORCH103": "np.* call on a tensor inside a captured body",
    "TORCH104": "CUDA graph or torch.compile built inside a loop",
    "TORCH105": "host clock reads without a CUDA sync or events",
    "CKPT201": "CkptRow kind emitted but never restored",
    "CKPT202": "CkptRow kind handled on restore but never emitted",
}


def severity_of(rule: str) -> str:
    return SEVERITY.get(rule, "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    scope: str     # Class.method, function name, or <module>
    detail: str    # stable discriminator (attr name, kind, callee)
    message: str

    @property
    def severity(self) -> str:
        return severity_of(self.rule)

    @property
    def fingerprint(self) -> str:
        # deliberately line-free: survives unrelated edits to the file
        return f"{self.rule}:{self.path}:{self.scope}:{self.detail}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "scope": self.scope,
                "detail": self.detail, "message": self.message,
                "fingerprint": self.fingerprint}


_DIRECTIVE_RE = re.compile(
    r"#\s*analysis:\s*"
    r"(?P<kind>lockfree|captured|ignore\[(?P<rules>[A-Za-z0-9_*,\s]+)\])"
    r"\s*(?:\((?P<reason>[^)]*)\))?")


@dataclasses.dataclass(frozen=True)
class Directive:
    kind: str                # "lockfree" | "captured" | "ignore"
    rules: tuple             # for "ignore": rule prefixes; else ()
    reason: str
    line: int


class SourceModule:
    """One parsed source file plus its suppression directives."""

    def __init__(self, root: Path, path: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        self.directives: dict[int, list[Directive]] = defaultdict(list)
        for i, ln in enumerate(self.lines, 1):
            m = _DIRECTIVE_RE.search(ln)
            if not m:
                continue
            kind = m.group("kind")
            rules = ()
            if kind.startswith("ignore"):
                rules = tuple(r.strip() for r in
                              (m.group("rules") or "").split(",") if r.strip())
                kind = "ignore"
            d = Directive(kind, rules, (m.group("reason") or "").strip(), i)
            self.directives[i].append(d)
            # a directive on a standalone comment line covers the next
            # code line (for statements too long to carry it inline)
            if not ln.split("#", 1)[0].strip():
                for j in range(i + 1, len(self.lines) + 1):
                    nxt = self.lines[j - 1].strip()
                    if nxt and not nxt.startswith("#"):
                        self.directives[j].append(d)
                        break
        # a directive sitting on a ``def`` line covers the whole function
        self._def_spans: list[tuple[int, int, int]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for ln in range(node.lineno,
                                (node.body[0].lineno if node.body
                                 else node.lineno)):
                    if ln in self.directives:
                        self._def_spans.append(
                            (node.lineno, node.end_lineno or node.lineno, ln))

    @property
    def dotted(self) -> str:
        rel = self.rel
        if rel.startswith("src/"):
            rel = rel[4:]
        rel = rel[:-3] if rel.endswith(".py") else rel
        if rel.endswith("/__init__"):
            rel = rel[: -len("/__init__")]
        return rel.replace("/", ".")

    def directives_at(self, line: int) -> list[Directive]:
        out = list(self.directives.get(line, ()))
        for start, end, dln in self._def_spans:
            if start <= line <= end and dln != line:
                out.extend(self.directives[dln])
        return out

    def has_directive(self, line: int, kind: str, rule: str = "") -> bool:
        for d in self.directives_at(line):
            if d.kind != kind:
                continue
            if kind != "ignore":
                return True
            if any(rule.startswith(r.rstrip("*")) for r in d.rules):
                return True
        return False

    def is_suppressed(self, finding: Finding) -> bool:
        for d in self.directives_at(finding.line):
            if d.kind == "lockfree" and finding.rule.startswith("LCK"):
                return True
            if d.kind == "ignore" and any(
                    finding.rule.startswith(r.rstrip("*")) for r in d.rules):
                return True
        return False


@dataclasses.dataclass
class FuncInfo:
    module: SourceModule
    node: ast.FunctionDef
    qualname: str            # "Class.method" or "func"
    cls: str | None = None


class Project:
    """All analyzable sources plus a cross-module symbol table."""

    DEFAULT_DIRS = ("src/repro_torch", "tools", "chip_smoke.py")

    def __init__(self, root: Path, dirs=DEFAULT_DIRS):
        """``dirs``: directories (walked for ``*.py``) and single files,
        relative to ``root``."""
        self.root = Path(root)
        self.modules: list[SourceModule] = []
        for d in dirs:
            base = self.root / d
            if base.is_file():
                self.modules.append(SourceModule(self.root, base))
                continue
            if not base.is_dir():
                continue
            for p in sorted(base.rglob("*.py")):
                if "__pycache__" in p.parts:
                    continue
                self.modules.append(SourceModule(self.root, p))
        self.mod_by_dotted = {m.dotted: m for m in self.modules}
        # (rel, qualname) -> FuncInfo;  name -> [FuncInfo]
        self.functions: dict[tuple[str, str], FuncInfo] = {}
        self.by_name: dict[str, list[FuncInfo]] = defaultdict(list)
        # (rel, ClassName) -> {method: FuncInfo};  ClassName -> [rel]
        self.classes: dict[tuple[str, str], dict[str, FuncInfo]] = {}
        self.class_modules: dict[str, list[str]] = defaultdict(list)
        # rel -> {alias: ("mod", dotted) | ("sym", dotted, name)}
        self.imports: dict[str, dict[str, tuple]] = {}
        for m in self.modules:
            self._index_module(m)

    def _index_module(self, m: SourceModule) -> None:
        imp: dict[str, tuple] = {}
        pkg = m.dotted if m.path.name == "__init__.py" \
            else m.dotted.rsplit(".", 1)[0] if "." in m.dotted else ""
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imp[a.asname or a.name.split(".")[0]] = \
                        ("mod", a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = pkg.split(".") if pkg else []
                    parts = parts[: len(parts) - (node.level - 1)]
                    base = ".".join(parts + ([node.module]
                                             if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    imp[a.asname or a.name] = ("sym", base, a.name)
        self.imports[m.rel] = imp
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FuncInfo(m, node, node.name)
                self.functions[(m.rel, node.name)] = fi
                self.by_name[node.name].append(fi)
            elif isinstance(node, ast.ClassDef):
                meths: dict[str, FuncInfo] = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fi = FuncInfo(m, sub, f"{node.name}.{sub.name}",
                                      node.name)
                        meths[sub.name] = fi
                        self.functions[(m.rel, fi.qualname)] = fi
                        self.by_name[sub.name].append(fi)
                self.classes[(m.rel, node.name)] = meths
                self.class_modules[node.name].append(m.rel)

    # -- resolution -----------------------------------------------------
    def resolve_name(self, module: SourceModule,
                     name: str) -> FuncInfo | None:
        """A bare ``name(...)`` call: module-level def or imported
        symbol from an in-project module."""
        fi = self.functions.get((module.rel, name))
        if fi is not None and fi.cls is None:
            return fi
        tgt = self.imports.get(module.rel, {}).get(name)
        if tgt and tgt[0] == "sym":
            src = self.mod_by_dotted.get(tgt[1])
            if src is not None:
                got = self.functions.get((src.rel, tgt[2]))
                if got is not None and got.cls is None:
                    return got
        return None

    def resolve_class(self, module: SourceModule,
                      name: str) -> tuple[str, str] | None:
        """Resolve a class *name* used in ``module`` to a
        ``(rel, ClassName)`` key, through imports if needed."""
        if (module.rel, name) in self.classes:
            return (module.rel, name)
        tgt = self.imports.get(module.rel, {}).get(name)
        if tgt and tgt[0] == "sym":
            src = self.mod_by_dotted.get(tgt[1])
            if src is not None and (src.rel, tgt[2]) in self.classes:
                return (src.rel, tgt[2])
        if len(self.class_modules.get(name, ())) == 1:
            return (self.class_modules[name][0], name)
        return None

    def method_of(self, cls_key: tuple[str, str],
                  meth: str) -> FuncInfo | None:
        return self.classes.get(cls_key, {}).get(meth)

    def module_for(self, finding_or_rel) -> SourceModule | None:
        rel = getattr(finding_or_rel, "path", finding_or_rel)
        for m in self.modules:
            if m.rel == rel:
                return m
        return None


def attr_chain(node: ast.AST) -> list[str] | None:
    """``a.b.c`` -> ["a","b","c"]; None if not a pure name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def repo_root_default() -> Path:
    # .../src/repro_torch/analysis/__init__.py -> repo root three levels up
    return Path(__file__).resolve().parents[3]
