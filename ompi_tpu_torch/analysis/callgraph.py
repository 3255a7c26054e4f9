"""Package-wide call graph + symbol resolver for the otpu-verify passes.

Copy of ``ompi_tpu/analysis/callgraph.py``, with one change:
:func:`module_name` starts a dotted name at the port's own root
(``ompi_tpu_torch``) as well as the JAX package's, where the reference
knows only ``ompi_tpu`` and keys every file of the port by its bare stem.

The per-file passes are strictly intraprocedural: a borrowed view escaping
through a helper return, a request started in one method and leaked in
another, or a pop/re-register pair split across ``_checkout`` were all
invisible.  This module gives every pass the same whole-program view:

- :class:`SymbolTable` — module names, imports, top-level functions,
  classes with their methods and (package-local) base classes.
- :class:`CallGraph` — resolves a call expression inside a function to
  the package function(s) it names.  Resolution is deliberately
  *under*-approximate (a call we cannot resolve resolves to nothing):
  passes built on it stay precise, they just don't see through dynamic
  dispatch.  Resolved forms:

  * ``f(...)``              — same-module function or from-import
  * ``Cls(...)``            — ``Cls.__init__`` (constructor edge)
  * ``self.m(...)``         — enclosing class's method, walking
    package-local bases (single inheritance chain, name-based)
  * ``mod.f(...)``/``pkg.sub.f(...)`` — imported module's function
  * ``obj.m(...)``          — when ``obj`` is a local assigned from
    ``Cls(...)`` in the same function, or a ``self._x`` attribute
    assigned from ``Cls(...)`` in the class's ``__init__``

Shared by all passes through :meth:`Package.callgraph`-style caching in
the lint run (built once per run; the AST cache already makes
re-parsing free, this makes re-resolving free too).
"""
from __future__ import annotations

import ast
import os
from typing import Optional

from ompi_tpu_torch.analysis import Module, Package, dotted, walk

__all__ = ["CallGraph", "FuncInfo", "build"]


#: package roots a dotted module name starts at: the port's own, and the
#: JAX package's (so the port's analyzer keys that tree as its own does)
PACKAGE_ROOTS = ("ompi_tpu_torch", "ompi_tpu")


def module_name(path: str) -> str:
    """Dotted module name for a source path (``ompi_tpu_torch.mca.btl.tcp``).

    Files outside a recognizable package root key by their stem, so
    fixture trees still resolve same-directory imports."""
    norm = path.replace(os.sep, "/")
    if norm.endswith(".py"):
        norm = norm[:-3]
    parts = norm.split("/")
    # the innermost root: a checkout's own directory may carry the name
    roots = [i for i, part in enumerate(parts) if part in PACKAGE_ROOTS]
    parts = parts[roots[-1]:] if roots else parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class FuncInfo:
    """One package function/method: its AST, location, and parameters."""

    __slots__ = ("mod", "qual", "node", "params", "cls")

    def __init__(self, mod: Module, qual: str, node, cls: Optional[str]):
        self.mod = mod
        self.qual = qual            # "f" or "Cls.m" (module-local)
        self.node = node
        self.cls = cls              # enclosing class name or None
        a = node.args
        self.params = [p.arg for p in a.posonlyargs + a.args]

    @property
    def key(self) -> tuple:
        return (self.mod.path, self.qual)


class _ModTable:
    """Per-module symbol info the resolver consults."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.name = module_name(mod.path)
        self.functions: dict[str, FuncInfo] = {}    # local qual -> info
        self.classes: dict[str, dict] = {}          # Cls -> {methods, bases}
        self.imports: dict[str, str] = {}           # alias -> dotted target
        self._scan()

    def _scan(self) -> None:
        for stmt in self.mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[stmt.name] = FuncInfo(
                    self.mod, stmt.name, stmt, None)
            elif isinstance(stmt, ast.ClassDef):
                methods = {}
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        qual = f"{stmt.name}.{sub.name}"
                        info = FuncInfo(self.mod, qual, sub, stmt.name)
                        methods[sub.name] = info
                        self.functions[qual] = info
                bases = [dotted(b) for b in stmt.bases]
                self.classes[stmt.name] = {
                    "methods": methods,
                    "bases": [b for b in bases if b],
                }
            elif isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    if alias.asname:
                        self.imports[alias.asname] = alias.name
                    else:
                        # ``import a.b`` binds ``a``; attribute chains
                        # walk from there
                        self.imports[alias.name.split(".")[0]] = \
                            alias.name.split(".")[0]
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level:      # relative: resolve against this module
                    base = self.name.split(".")
                    base = base[:len(base) - stmt.level]
                    prefix = ".".join(base + ([stmt.module]
                                              if stmt.module else []))
                else:
                    prefix = stmt.module or ""
                for alias in stmt.names:
                    if alias.name == "*":
                        continue
                    self.imports[alias.asname or alias.name] = \
                        f"{prefix}.{alias.name}" if prefix else alias.name


class CallGraph:
    """Whole-package resolver.  Build once with :func:`build`."""

    def __init__(self, pkg: Package):
        self.pkg = pkg
        self.tables: dict[str, _ModTable] = {}      # module name -> table
        self.by_path: dict[str, _ModTable] = {}
        for mod in pkg.modules:
            t = _ModTable(mod)
            # first one wins on duplicate names (fixture trees may shadow
            # package modules; the package loads first in a normal run)
            self.tables.setdefault(t.name, t)
            self.by_path[mod.path] = t
        #: (mod.path, qual) -> FuncInfo for direct lookups
        self.functions: dict[tuple, FuncInfo] = {}
        for t in self.tables.values():
            for info in t.functions.values():
                self.functions[info.key] = info
        # local-variable / self-attr class types, lazily built per module
        self._attr_types: dict[str, dict] = {}
        self._local_type_cache: dict[tuple, dict] = {}

    # -- symbol lookup ----------------------------------------------------
    def _module(self, name: str) -> Optional[_ModTable]:
        t = self.tables.get(name)
        if t is not None:
            return t
        # ``a.b`` may be a package whose symbols live in a/b/__init__.py;
        # module_name already folded __init__ away, so plain get covers it
        return None

    def _lookup_dotted(self, target: str,
                       _seen: Optional[set] = None) -> Optional[FuncInfo]:
        """Resolve a fully-dotted ``a.b.c`` to a function/Cls.__init__."""
        # longest module prefix wins: a.b.c = module a.b, symbol c,
        # or module a.b.c itself (not callable), or module a, Cls .b, m .c
        if _seen is None:
            _seen = set()
        if target in _seen:     # circular re-export (compat shims):
            return None         # unresolvable, not a crash
        _seen.add(target)
        parts = target.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            t = self._module(".".join(parts[:cut]))
            if t is None:
                continue
            rest = parts[cut:]
            if len(rest) == 1:
                sym = rest[0]
                info = t.functions.get(sym)
                if info is not None:
                    return info
                if sym in t.classes:
                    return t.classes[sym]["methods"].get("__init__")
                # re-exported: follow the from-import hop (cycle-safe)
                tgt = t.imports.get(sym)
                if tgt is not None and tgt != target:
                    return self._lookup_dotted(tgt, _seen)
            elif len(rest) == 2 and rest[0] in t.classes:
                return self._method(t, rest[0], rest[1])
        return None

    def _method(self, table: _ModTable, cls: str,
                name: str) -> Optional[FuncInfo]:
        """Method lookup walking package-local bases."""
        seen = set()
        queue = [(table, cls)]
        while queue:
            t, c = queue.pop(0)
            if (t.name, c) in seen or c not in t.classes:
                continue
            seen.add((t.name, c))
            info = t.classes[c]["methods"].get(name)
            if info is not None:
                return info
            for base in t.classes[c]["bases"]:
                bt, bc = self._resolve_class(t, base)
                if bt is not None:
                    queue.append((bt, bc))
        return None

    def _resolve_class(self, table: _ModTable,
                       name: str) -> tuple[Optional[_ModTable], str]:
        """(_ModTable, ClassName) for a possibly-imported class name."""
        if name in table.classes:
            return table, name
        head, _, rest = name.partition(".")
        tgt = table.imports.get(head)
        if tgt is None:
            return None, name
        full = f"{tgt}.{rest}" if rest else tgt
        parts = full.split(".")
        for cut in range(len(parts), 0, -1):
            t = self._module(".".join(parts[:cut]))
            if t is not None and len(parts) - cut == 1 \
                    and parts[cut] in t.classes:
                return t, parts[cut]
        return None, name

    # -- per-function local type environments -----------------------------
    def _self_attr_types(self, table: _ModTable, cls: str) -> dict:
        """attr -> (table, Cls) learned from ``self._x = Cls(...)`` in
        __init__ (and other methods of the same class)."""
        key = f"{table.name}:{cls}"
        hit = self._attr_types.get(key)
        if hit is not None:
            return hit
        out: dict[str, tuple] = {}
        meta = table.classes.get(cls)
        if meta:
            for info in meta["methods"].values():
                for node in walk(info.node):
                    if not (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)):
                        continue
                    ctor = dotted(node.value.func)
                    if ctor is None:
                        continue
                    ct, cn = self._resolve_class(table, ctor)
                    if ct is None:
                        continue
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            out[tgt.attr] = (ct, cn)
        self._attr_types[key] = out
        return out

    def _local_types(self, info: FuncInfo) -> dict:
        """local name -> (table, Cls) from ``x = Cls(...)`` assigns."""
        hit = self._local_type_cache.get(info.key)
        if hit is not None:
            return hit
        table = self.by_path[info.mod.path]
        out: dict[str, tuple] = {}
        for node in walk(info.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and node.targets
                    and isinstance(node.targets[0], ast.Name)):
                continue
            ctor = dotted(node.value.func)
            if ctor is None:
                continue
            ct, cn = self._resolve_class(table, ctor)
            if ct is not None:
                out[node.targets[0].id] = (ct, cn)
        self._local_type_cache[info.key] = out
        return out

    # -- the resolver ------------------------------------------------------
    def resolve_call(self, info: FuncInfo,
                     call: ast.Call) -> Optional[FuncInfo]:
        """The package function ``call`` inside ``info`` names, or None."""
        table = self.by_path.get(info.mod.path)
        if table is None:
            return None
        f = call.func
        name = dotted(f)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        if not rest:
            # bare name: local function, local class ctor, or from-import
            local = table.functions.get(name)
            if local is not None and local.cls is None:
                return local
            if name in table.classes:
                return table.classes[name]["methods"].get("__init__")
            tgt = table.imports.get(name)
            return self._lookup_dotted(tgt) if tgt else None
        if head == "self" and info.cls is not None:
            parts = rest.split(".")
            if len(parts) == 1:
                return self._method(table, info.cls, parts[0])
            # self._x.m(): typed attribute hop
            attrs = self._self_attr_types(table, info.cls)
            hop = attrs.get(parts[0])
            if hop is not None and len(parts) == 2:
                return self._method(hop[0], hop[1], parts[1])
            return None
        # imported module/class chain
        tgt = table.imports.get(head)
        if tgt is not None:
            return self._lookup_dotted(f"{tgt}.{rest}")
        # typed local: x = Cls(...); x.m()
        parts = rest.split(".")
        if len(parts) == 1:
            hop = self._local_types(info).get(head)
            if hop is not None:
                return self._method(hop[0], hop[1], parts[0])
        # same-module class: Cls.m(...) static style
        if head in table.classes and len(parts) == 1:
            return self._method(table, head, parts[0])
        return None

    def function_at(self, mod: Module, qual: str) -> Optional[FuncInfo]:
        return self.functions.get((mod.path, qual))


_graphs: dict[int, CallGraph] = {}


def build(pkg: Package) -> CallGraph:
    """Build (or reuse) the call graph for ``pkg``.  Keyed on the Package
    object: every pass in one lint run shares one resolver."""
    g = _graphs.get(id(pkg))
    if g is None or g.pkg is not pkg:
        g = CallGraph(pkg)
        _graphs.clear()         # one live package at a time is plenty
        _graphs[id(pkg)] = g
    return g
