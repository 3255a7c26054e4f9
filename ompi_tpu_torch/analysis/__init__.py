"""otpu-lint — invariant-encoding static analysis for the runtime hot paths.

Copy of ``ompi_tpu/analysis/__init__.py``: the analyzer is stdlib only, so
it comes over with its imports re-pointed; the passes, their rule names,
messages and descriptions are the reference's, letter for letter (tools
and baselines key on them).

Every review pass so far has caught the same bug families by hand: borrowed
views escaping their btl.send call, staging acquire/release pairs broken on
one path, guarded structures mutated outside their lock, show_help keys
nobody registered.  These are *encodable* invariants — this package encodes
them as AST passes (stdlib ``ast``, no new deps) the way the reference OMPI
leans on valgrind/memchecker wiring rather than vigilance in review.

Architecture:

- :class:`Module` / :class:`Package` — parsed source units.  ASTs are
  parsed once per (path, mtime, size) and shared by every pass
  (the module-level cache is what keeps a whole-package run under the
  tier-1 budget).
- :class:`AnalysisPass` — one invariant family; registered via
  :func:`register_pass`, enumerated by :func:`all_passes` (the CLI and
  ``otpu_info --lint`` both read the registry).
- :class:`Suppressions` — the checked-in baseline: grandfathered findings
  live in a reviewable file, one justified entry per line.
- :func:`lint` — front door: load, run, partition into kept/suppressed.

Annotation conventions the passes understand (see README "static
analysis & sanitizer"):

- ``_guarded_by = {"attr": "lock_attr"}`` on a class (or module-level
  ``_GUARDED_BY``) declares which lock serializes mutations of a
  structure; methods whose name ends in ``_locked`` are assumed called
  with the lock already held.
- ``@hot_path`` (``ompi_tpu_torch.runtime.hotpath``) tags allocation-budgeted
  functions; the decorator itself is identity at runtime.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Iterator, Optional

__all__ = [
    "AnalysisPass", "Finding", "Module", "Package", "Suppressions",
    "all_passes", "get_pass", "lint", "load_package", "register_pass",
    "walk",
]


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str          # path as given to the linter (repo-relative in CI)
    line: int
    col: int
    message: str
    symbol: str = ""   # enclosing function/class qualname, "" at module level

    def format(self, parsable: bool = False) -> str:
        if parsable:
            return (f"{self.path}:{self.line}:{self.col}:{self.rule}:"
                    f"{self.symbol}:{self.message}")
        where = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}]{where} {self.message}")


class Module:
    """One parsed source file plus the derived tables passes share."""

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        self.source = source
        self.tree = tree
        self._qualnames: Optional[dict[int, str]] = None
        self._functions: Optional[list] = None

    def functions(self) -> Iterator[tuple[ast.AST, str]]:
        """Yield every (Function/AsyncFunctionDef, qualname), nested ones
        included (``Class.method``, ``outer.<locals>.inner``).

        The list is built once per parse and shared by every pass (the
        reference walks the whole tree again on each call)."""
        if self._functions is None:
            self._qualnames = {}
            self._walk_quals(self.tree, "")
            self._functions = [
                (node, self._qualnames.get(id(node), node.name))
                for node in walk(self.tree)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return iter(self._functions)

    def _walk_quals(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self._qualnames[id(child)] = qual
                self._walk_quals(child, f"{qual}.<locals>.")
            elif isinstance(child, ast.ClassDef):
                self._walk_quals(child, f"{prefix}{child.name}.")
            else:
                self._walk_quals(child, prefix)

    def classes(self) -> Iterator[ast.ClassDef]:
        for node in walk(self.tree):
            if isinstance(node, ast.ClassDef):
                yield node


class Package:
    """The whole lint target: every module, plus parse errors."""

    def __init__(self) -> None:
        self.modules: list[Module] = []
        self.errors: list[Finding] = []

    def find(self, suffix: str) -> Optional[Module]:
        """Module whose (slash-normalized) path ends with ``suffix``."""
        for mod in self.modules:
            if mod.path.replace(os.sep, "/").endswith(suffix):
                return mod
        return None


# AST cache: abspath -> (mtime_ns, size, Module).  Every pass in a run —
# and repeated runs in one process (tests) — reuse the same parse.
_ast_cache: dict[str, tuple[int, int, Module]] = {}


def _load_file(path: str, pkg: Package) -> None:
    apath = os.path.abspath(path)
    try:
        st = os.stat(apath)
    except OSError as exc:
        pkg.errors.append(Finding("parse-error", path, 0, 0, str(exc)))
        return
    hit = _ast_cache.get(apath)
    if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
        mod = hit[2]
        if mod.path != path:   # same file reached via a different CWD
            mod = Module(path, mod.source, mod.tree)
            _ast_cache[apath] = (st.st_mtime_ns, st.st_size, mod)
        pkg.modules.append(mod)
        return
    try:
        with open(apath, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as exc:
        pkg.errors.append(Finding(
            "parse-error", path, getattr(exc, "lineno", 0) or 0, 0,
            f"cannot parse: {exc}"))
        return
    mod = Module(path, source, tree)
    _ast_cache[apath] = (st.st_mtime_ns, st.st_size, mod)
    pkg.modules.append(mod)


def load_package(paths) -> Package:
    """Parse ``paths`` (files or directories, recursively) into a Package."""
    pkg = Package()
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for fname in sorted(files):
                    if fname.endswith(".py"):
                        _load_file(os.path.join(root, fname), pkg)
        else:
            _load_file(p, pkg)
    return pkg


# ---------------------------------------------------------------------------
# shared AST helpers (passes import these)
# ---------------------------------------------------------------------------

def walk(node: ast.AST) -> list:
    """``ast.walk(node)`` as a list, in its order, built once per node and
    kept on it: the passes walk the same functions again and again, and
    the parsed trees are shared and never changed (the reference calls
    ``ast.walk`` each time)."""
    nodes = node.__dict__.get("_otpu_walk")
    if nodes is None:
        nodes = list(ast.walk(node))
        node._otpu_walk = nodes
    return nodes


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str:
    """Dotted name of a call target ("" when not a plain name chain)."""
    return dotted(call.func) or ""


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# pass registry
# ---------------------------------------------------------------------------

class AnalysisPass:
    """One invariant family.  Subclasses set ``name``/``description`` and
    implement :meth:`run` over the whole package (cross-file invariants —
    help-key registration, lock-order graphs — need the package view; a
    per-file pass just iterates ``pkg.modules``)."""

    name = ""
    description = ""

    def run(self, pkg: Package) -> list[Finding]:
        raise NotImplementedError


_registry: dict[str, AnalysisPass] = {}


def register_pass(cls):
    inst = cls()
    _registry[inst.name] = inst
    return cls


def _load_builtin() -> None:
    from ompi_tpu_torch.analysis import passes  # noqa: F401  (registration side effect)


def all_passes() -> list[AnalysisPass]:
    _load_builtin()
    return list(_registry.values())


def get_pass(name: str) -> AnalysisPass:
    _load_builtin()
    return _registry[name]


# ---------------------------------------------------------------------------
# suppressions (the checked-in baseline)
# ---------------------------------------------------------------------------

@dataclass
class _Entry:
    rule: str
    path: str            # suffix-matched against finding paths
    symbol: str          # "" matches any symbol
    line_no: int         # line in the suppressions file (diagnostics)
    used: int = 0


@dataclass
class Suppressions:
    """Baseline file: ``<rule> <path>[:<symbol>]  # why`` per line.

    Matching is by rule + path suffix + (optional) enclosing symbol —
    deliberately NOT by line number, so unrelated edits above a
    grandfathered site don't invalidate the baseline.
    """

    entries: list = field(default_factory=list)
    path: str = ""

    @classmethod
    def parse(cls, text: str, path: str = "<string>") -> "Suppressions":
        sup = cls(path=path)
        for i, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{i}: bad suppression {raw!r} "
                    "(want: <rule> <path>[:<symbol>])")
            rule, target = parts
            fpath, _, symbol = target.partition(":")
            sup.entries.append(_Entry(rule, fpath, symbol, i))
        return sup

    @classmethod
    def load(cls, path: str) -> "Suppressions":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            return cls.parse(f.read(), path)

    def match(self, f: Finding) -> bool:
        fpath = f.path.replace(os.sep, "/")
        for e in self.entries:
            if (e.rule == f.rule and fpath.endswith(e.path)
                    and (not e.symbol or e.symbol == f.symbol)):
                e.used += 1
                return True
        return False

    def unused(self) -> list:
        return [e for e in self.entries if not e.used]

    @staticmethod
    def render(findings) -> str:
        """Baseline text for ``findings`` (the --write-suppressions path;
        every generated entry still needs a human justification comment)."""
        lines = ["# otpu-lint suppressions — one justified entry per line:",
                 "#   <rule> <path>[:<symbol>]  # why this is deliberate"]
        seen = set()
        for f in findings:
            key = (f.rule, f.path, f.symbol)
            if key in seen:
                continue
            seen.add(key)
            target = f.path.replace(os.sep, "/")
            if f.symbol:
                target += f":{f.symbol}"
            lines.append(f"{f.rule} {target}  # TODO justify: {f.message}")
        return "\n".join(lines) + "\n"


@dataclass
class LintResult:
    findings: list          # kept (unsuppressed) findings, sorted
    suppressed: list        # findings matched by the baseline
    errors: list            # parse errors (never suppressible)
    files: int = 0
    passes: int = 0
    pass_names: list = field(default_factory=list)
    linted_paths: list = field(default_factory=list)   # slash-normalized
    timings: list = field(default_factory=list)        # (pass, seconds)

    def format_timings(self) -> str:
        """Per-pass wall-clock breakdown (the CI gate prints this when
        the run blows its budget, so the slow pass names itself)."""
        total = sum(t for _n, t in self.timings)
        rows = [f"  {n + ':':<22} {t * 1e3:8.1f} ms"
                for n, t in sorted(self.timings,
                                   key=lambda x: -x[1])]
        return "\n".join(rows + [f"  {'total:':<22} {total * 1e3:8.1f} ms"])

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors

    def unused_suppressions(self, sup: "Suppressions") -> list:
        """Baseline entries this run PROVED stale: never matched, their
        rule ran, and their file was among the linted paths.  A partial
        run (subset paths or --select) cannot prove anything about
        entries outside its scope, so those are not reported."""
        return [e for e in sup.unused()
                if e.rule in self.pass_names
                and any(p.endswith(e.path) for p in self.linted_paths)]


def lint(paths, select=None, suppressions: Optional[Suppressions] = None,
         ) -> LintResult:
    """Run ``select`` passes (default: all) over ``paths``."""
    pkg = load_package(paths)
    passes = all_passes()
    if select:
        want = set(select)
        unknown = want - {p.name for p in passes}
        if unknown:
            raise KeyError(f"unknown pass(es): {', '.join(sorted(unknown))}")
        passes = [p for p in passes if p.name in want]
    import time

    findings: list[Finding] = []
    timings: list[tuple] = []
    for p in passes:
        t0 = time.monotonic()
        findings.extend(p.run(pkg))
        timings.append((p.name, time.monotonic() - t0))
    findings = sorted(set(findings),
                      key=lambda f: (f.path, f.line, f.col, f.rule))
    kept, shed = [], []
    for f in findings:
        (shed if suppressions is not None and suppressions.match(f)
         else kept).append(f)
    return LintResult(
        kept, shed, list(pkg.errors),
        files=len(pkg.modules), passes=len(passes),
        pass_names=[p.name for p in passes],
        linted_paths=[m.path.replace(os.sep, "/") for m in pkg.modules],
        timings=timings)
