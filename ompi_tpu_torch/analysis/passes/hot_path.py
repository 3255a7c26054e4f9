"""hot-path — functions tagged ``@hot_path`` keep their allocation budget.

The ``@hot_path`` decorator (``ompi_tpu_torch.runtime.hotpath``) is identity at
runtime; its value is this pass.  Tagged functions — progress-loop drain,
btl send/recv, convertor pack, coll dispatch — run per message or per
progress tick, so per-call allocation sugar is a measurable tax:

- ``pickle.dumps``/``loads`` (serialize on the data path — the fast
  header exists so the common frames never pay this),
- f-strings / ``str.format`` / ``"%" % args`` (string building),
- list-literal concatenation (``x + [y]`` allocates twice).

Error paths are cold: nodes inside ``raise`` statements and ``except``
handler bodies are exempt.  Separately, a tagged function must not
``raise struct.error`` — wire-framing failures go through the loud
``show_help`` guard (the frame-too-large convention), not a bare struct
exception the caller cannot attribute.
"""
from __future__ import annotations

import ast

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, register_pass, walk)


def _is_hot(fn) -> bool:
    for dec in fn.decorator_list:
        name = dec.id if isinstance(dec, ast.Name) else \
            dec.attr if isinstance(dec, ast.Attribute) else None
        if name == "hot_path":
            return True
    return False


def _cold_nodes(fn) -> set:
    """ids of nodes inside raise statements, except handler bodies, and
    ``sanitizer.fail(...)`` calls (fail raises by contract)."""
    cold: set[int] = set()
    for node in walk(fn):
        if isinstance(node, (ast.Raise, ast.ExceptHandler)) or (
                isinstance(node, ast.Call)
                and call_name(node) == "sanitizer.fail"):
            for sub in walk(node):
                cold.add(id(sub))
    return cold


@register_pass
class HotPathPass(AnalysisPass):
    name = "hot-path"
    description = ("@hot_path functions may not allocate via pickle / "
                   "format-string / list-concat, nor raise bare "
                   "struct.error instead of the show_help guard")

    def run(self, pkg: Package) -> list[Finding]:
        out: list[Finding] = []
        for mod in pkg.modules:
            for fn, qual in mod.functions():
                if _is_hot(fn):
                    out.extend(self._check(mod, fn, qual))
        return out

    def _check(self, mod, fn, qual) -> list[Finding]:
        cold = _cold_nodes(fn)
        out = []

        def flag(node, what):
            out.append(Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"@hot_path function allocates via {what} — this runs "
                "per message/tick; hoist it, use the fast-header/"
                "preallocated path, or drop the @hot_path tag", qual))

        for node in walk(fn):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                name = call_name(exc) if isinstance(exc, ast.Call) \
                    else (exc.attr if isinstance(exc, ast.Attribute)
                          else getattr(exc, "id", ""))
                if name and (name == "struct.error"
                             or name.endswith(".error") and
                             name.split(".")[0] == "struct"):
                    out.append(Finding(
                        self.name, mod.path, node.lineno, node.col_offset,
                        "@hot_path function raises bare struct.error — "
                        "route wire-framing failures through the "
                        "show_help guard so the user sees an "
                        "attributable diagnostic", qual))
                continue
            if id(node) in cold:
                continue
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name.startswith("pickle."):
                    flag(node, f"{name}()")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "format" \
                        and isinstance(node.func.value, ast.Constant) \
                        and isinstance(node.func.value.value, str):
                    flag(node, "str.format()")
            elif isinstance(node, ast.JoinedStr):
                flag(node, "an f-string")
            elif isinstance(node, ast.BinOp):
                if isinstance(node.op, ast.Mod) \
                        and isinstance(node.left, ast.Constant) \
                        and isinstance(node.left.value, str):
                    flag(node, "'%'-formatting")
                elif isinstance(node.op, ast.Add) \
                        and (isinstance(node.left, ast.List)
                             or isinstance(node.right, ast.List)):
                    flag(node, "list concatenation")
        return out
