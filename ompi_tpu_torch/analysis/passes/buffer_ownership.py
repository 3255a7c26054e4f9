"""buffer-ownership — borrowed views must not escape; staging pairs close.

The invariant family behind the worst staging-pool review bugs:

1. A borrowed view (``Convertor.pack_borrow``'s zero-copy slice of the
   user buffer, ``_Ring.pop_frame``'s view of reused ring scratch) is
   valid only within the call that produced it.  Storing it on ``self``,
   a parameter's attribute, or a global — or returning it — without an
   explicit owning copy (``bytes()``/``bytearray()``/``.tobytes()``/
   ``np.array(x, copy=True)``/``.toreadonly()``) aliases transient
   memory.  Passing it onward as a *call argument* is allowed: the
   callee inherits the same contract (that is how pack_borrow's chunks
   legitimately ride into ``btl.send``).

2. ``staging_acquire``/``staging_release`` must pair on all paths: an
   acquired buffer that is neither released, returned, nor stored (an
   ownership transfer) leaks pool accounting; a ``return`` between
   acquire and release skips the release on that path (the fix is a
   ``try/finally``, exactly like ``algorithms.allreduce_ring``).
"""
from __future__ import annotations

import ast

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, dotted, register_pass, walk)

#: call attr names that produce a borrowed view
BORROW_PRODUCERS = {"pack_borrow", "pop_frame"}

#: call names whose result is an owned copy of their argument
OWNING_WRAPPERS = {"bytes", "bytearray"}
OWNING_METHODS = {"tobytes", "toreadonly"}

MUTATORS = {"append", "appendleft", "extend", "insert", "add", "push",
            "setdefault", "update"}


def _is_owned_use(parents: dict, node: ast.Name) -> bool:
    """True when ``node`` is consumed by an owning copy wrapper."""
    parent = parents.get(id(node))
    if isinstance(parent, ast.Call):
        if call_name(parent) in OWNING_WRAPPERS and parent.args \
                and parent.args[0] is node:
            return True
        fn = parent.func
        if isinstance(fn, ast.Attribute) and fn.attr == "array" \
                and parent.args and parent.args[0] is node:
            return True        # np.array(x, ...)
    if isinstance(parent, ast.Attribute) and parent.attr in OWNING_METHODS:
        return True            # x.tobytes() / x.toreadonly()
    return False


def _parent_map(fn: ast.AST) -> dict:
    parents: dict[int, ast.AST] = {}
    for node in walk(fn):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def _root_name(node: ast.AST):
    """Leftmost Name of an attribute/subscript/call chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _names_in(node: ast.AST) -> set:
    return {n.id for n in walk(node) if isinstance(n, ast.Name)}


def _is_staging_acquire(call: ast.Call) -> bool:
    name = call_name(call)
    return name.endswith("staging_acquire") or name.endswith("staging.acquire")


def _is_staging_release(call: ast.Call) -> bool:
    name = call_name(call)
    return name.endswith("staging_release") or name.endswith("staging.release")


@register_pass
class BufferOwnershipPass(AnalysisPass):
    name = "buffer-ownership"
    description = ("borrowed pack_borrow/pop_frame views must not escape "
                   "without an owning copy; staging acquire/release pair "
                   "on all paths")

    def run(self, pkg: Package) -> list[Finding]:
        out: list[Finding] = []
        for mod in pkg.modules:
            for fn, qual in mod.functions():
                out.extend(self._check_borrows(mod, fn, qual))
                out.extend(self._check_staging(mod, fn, qual))
        return out

    # -- borrowed-view escapes -------------------------------------------
    def _borrowed_names(self, fn) -> dict[str, int]:
        borrowed: dict[str, int] = {}
        for node in walk(fn):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            f = node.value.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in BORROW_PRODUCERS):
                continue
            tgt = node.targets[0]
            if isinstance(tgt, ast.Tuple) and tgt.elts \
                    and isinstance(tgt.elts[0], ast.Name):
                # data, borrowed = conv.pack_borrow(...)
                borrowed[tgt.elts[0].id] = node.lineno
            elif isinstance(tgt, ast.Name):
                borrowed[tgt.id] = node.lineno
        return borrowed

    def _check_borrows(self, mod, fn, qual) -> list[Finding]:
        borrowed = self._borrowed_names(fn)
        if not borrowed:
            return []
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs
                  + fn.args.posonlyargs}
        params.discard("self")
        parents = _parent_map(fn)
        out = []

        def escapes(name_node: ast.Name, how: str, node) -> None:
            out.append(Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"borrowed view '{name_node.id}' (line "
                f"{borrowed[name_node.id]}) {how} without an owning "
                "copy (bytes()/.tobytes()/np.array(copy=True)); borrowed "
                "views die with the producing call", qual))

        for node in walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                for n in walk(node.value):
                    if isinstance(n, ast.Name) and n.id in borrowed \
                            and not _is_owned_use(parents, n):
                        escapes(n, "is returned", node)
            elif isinstance(node, ast.Assign):
                vals = [n for n in walk(node.value)
                        if isinstance(n, ast.Name) and n.id in borrowed
                        and not _is_owned_use(parents, n)]
                if not vals:
                    continue
                for tgt in node.targets:
                    root = _root_name(tgt)
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)) \
                            and (root == "self" or root in params):
                        escapes(vals[0], f"is stored on '{root}'", node)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
                    root = _root_name(f.value)
                    if root != "self" and root not in params:
                        continue
                    for arg in node.args:
                        for n in walk(arg):
                            if isinstance(n, ast.Name) and n.id in borrowed \
                                    and not _is_owned_use(parents, n):
                                escapes(n, "is queued on "
                                        f"'{dotted(f.value) or root}'", node)
        return out

    # -- staging acquire/release pairing ---------------------------------
    def _check_staging(self, mod, fn, qual) -> list[Finding]:
        acquires: dict[str, ast.Assign] = {}
        releases: dict[str, ast.Call] = {}
        for node in walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and _is_staging_acquire(node.value) \
                    and isinstance(node.targets[0], ast.Name):
                acquires[node.targets[0].id] = node
            elif isinstance(node, ast.Call) and _is_staging_release(node):
                for arg in node.args:
                    for n in _names_in(arg):
                        releases.setdefault(n, node)
        if not acquires:
            return []
        out = []
        for name, acq in acquires.items():
            rel = releases.get(name)
            if rel is None:
                if self._ownership_transferred(fn, name):
                    continue
                out.append(Finding(
                    self.name, mod.path, acq.lineno, acq.col_offset,
                    f"staging buffer '{name}' is acquired but never "
                    "released, returned, or stored — pool accounting "
                    "leaks on every call", qual))
                continue
            # early return strictly between acquire and release skips
            # the release on that path — pair them with try/finally
            for node in walk(fn):
                if isinstance(node, ast.Return) \
                        and acq.lineno < node.lineno < rel.lineno \
                        and not self._release_in_finally(fn, rel):
                    out.append(Finding(
                        self.name, mod.path, node.lineno, node.col_offset,
                        f"return between staging_acquire('{name}', line "
                        f"{acq.lineno}) and its release (line "
                        f"{rel.lineno}) skips the release on this path — "
                        "use try/finally", qual))
                    break
        return out

    @staticmethod
    def _ownership_transferred(fn, name: str) -> bool:
        """Returned or stored on self = ownership moved out of the frame."""
        for node in walk(fn):
            if isinstance(node, ast.Return) and node.value is not None \
                    and name in _names_in(node.value):
                return True
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == name:
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)) \
                            and _root_name(tgt) == "self":
                        return True
        return False

    @staticmethod
    def _release_in_finally(fn, rel: ast.Call) -> bool:
        for node in walk(fn):
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in walk(stmt):
                        if sub is rel:
                            return True
        return False
