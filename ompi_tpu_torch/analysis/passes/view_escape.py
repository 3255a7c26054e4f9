"""view-escape — interprocedural borrowed-view escape analysis.

The buffer-ownership pass is strictly intraprocedural: it sees
``data, _ = conv.pack_borrow(...)`` stored on ``self`` in the SAME
function, and nothing else.  Three whole bug families slip through:

1. **Helper returns**: ``def _head(self): return self.conv.pack_borrow
   (buf)[0]`` — the helper returns a borrowed view with no name bound,
   so the old pass is silent in the helper AND in every caller that
   stores the "owned-looking" result.
2. **Stored fields / escaping parameters**: passing a borrowed view as
   a call argument is legal (the callee inherits the contract) — unless
   the callee STORES its parameter on ``self`` or queues it on a
   container that outlives the call.  Only a per-function escape
   summary, composed over the call graph, can tell the two apart.
3. **Callback captures**: a borrowed view captured by a lambda or
   nested ``def`` that is registered somewhere (``req.on_complete(...)``,
   stored, returned) executes after the borrow died.

This pass computes per-function summaries over
:mod:`ompi_tpu_torch.analysis.callgraph` —

- ``returns_borrowed``: some return value may be a borrowed
  ``pack_borrow``/``pop_frame`` view (directly or through callees),
- ``returns_staging``: returns a live ``staging_acquire`` checkout
  (an ownership transfer: the caller owns the release),
- ``param_escapes[p]``: parameter ``p`` is stored on ``self``/a global/
  an outliving container (directly or through callees),
- ``param_released[p]``: parameter ``p`` is staging-released on some
  path (so handing a checkout to this callee pairs the acquire),

with a worklist fixpoint, then reports: escapes of helper-returned
borrowed views, borrowed arguments to escaping parameters, borrowed
captures by deferred callbacks, borrowed views returned straight from
the producing call, and helper-acquired staging checkouts that leak.

Findings the intraprocedural buffer-ownership pass already reports
(direct borrow stored/returned/queued in one function) are NOT
duplicated here: this pass only fires where the evidence crosses a
function boundary.
"""
from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, dotted, register_pass, walk)
from ompi_tpu_torch.analysis.passes.buffer_ownership import (
    BORROW_PRODUCERS, MUTATORS, OWNING_METHODS, OWNING_WRAPPERS,
    _is_staging_acquire, _is_staging_release, _root_name)

#: callables that run a passed lambda synchronously — capturing a
#: borrow in their key-function is not a deferred escape
SYNC_CONSUMERS = {"sorted", "min", "max", "map", "filter", "any", "all",
                  "sum", "next"}


def _is_owning_call(call: ast.Call) -> bool:
    name = call_name(call)
    if name in OWNING_WRAPPERS:
        return True
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in OWNING_METHODS:
        return True
    if isinstance(f, ast.Attribute) and f.attr == "array":
        return True          # np.array(x, copy=...)
    return False


class _Summary:
    __slots__ = ("returns_borrowed", "returns_staging", "param_escapes",
                 "param_released")

    def __init__(self):
        self.returns_borrowed: Optional[str] = None   # producing call name
        self.returns_staging = False
        self.param_escapes: dict[str, str] = {}       # param -> where
        self.param_released: set[str] = set()

    def state(self):
        return (self.returns_borrowed, self.returns_staging,
                tuple(sorted(self.param_escapes)),
                tuple(sorted(self.param_released)))


class _Facts:
    """One function's relevant nodes, nested-def bodies excluded (their
    locals are a different frame; they are analyzed separately and
    consulted here only as capture sites)."""

    def __init__(self, info, graph):
        self.info = info
        self.assigns: list = []          # Assign nodes
        self.returns: list = []          # Return nodes
        self.calls: list = []            # (Call, resolved FuncInfo|None)
        self.nested: list = []           # FunctionDef/Lambda nodes
        self.callee_keys: set = set()
        self._walk(info.node, top=True)

    def _walk(self, node, top=False) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                self.nested.append(child)
                continue                 # don't descend: separate frame
            if isinstance(child, ast.Assign):
                self.assigns.append(child)
            elif isinstance(child, ast.Return):
                self.returns.append(child)
            elif isinstance(child, ast.Call):
                self.calls.append((child, None))
            self._walk(child)

    def resolve(self, graph) -> None:
        self.calls = [(c, graph.resolve_call(self.info, c))
                      for c, _ in self.calls]
        # AFTER resolution (the callee slots are None before): these
        # edges drive the fixpoint worklist — a summary change at a
        # callee re-queues every caller
        self.callee_keys = {callee.key for _c, callee in self.calls
                            if callee is not None}


def _argmap(call: ast.Call, callee) -> list:
    """(arg expression, callee param name) pairs for a resolved call."""
    params = list(callee.params)
    if callee.cls is not None and params and params[0] in ("self", "cls"):
        params = params[1:]
    out = []
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(params):
            out.append((arg, params[i]))
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in callee.params:
            out.append((kw.value, kw.arg))
    return out


@register_pass
class ViewEscapePass(AnalysisPass):
    name = "view-escape"
    description = ("interprocedural escape analysis: borrowed views "
                   "tracked through helper returns, stored fields, and "
                   "callback captures; staging checkouts tracked through "
                   "acquire/release helpers")

    # -- the run over the package -----------------------------------------
    def run(self, pkg: Package) -> list[Finding]:
        from ompi_tpu_torch.analysis import callgraph

        graph = callgraph.build(pkg)
        facts: dict[tuple, _Facts] = {}
        for mod in pkg.modules:
            for fn, qual in mod.functions():
                info = graph.function_at(mod, qual)
                if info is None:         # nested def: summarize standalone
                    from ompi_tpu_torch.analysis.callgraph import FuncInfo

                    info = FuncInfo(mod, qual, fn, None)
                f = _Facts(info, graph)
                f.resolve(graph)
                facts[(mod.path, qual)] = f

        summaries = self._fixpoint(facts)
        out: list[Finding] = []
        for key, f in facts.items():
            out.extend(self._check(f, summaries))
        return out

    # -- summaries --------------------------------------------------------
    def _fixpoint(self, facts) -> dict:
        summaries = {k: _Summary() for k in facts}
        # reverse edges: whose summary depends on whom
        dependents: dict[tuple, set] = {}
        for key, f in facts.items():
            for ck in f.callee_keys:
                dependents.setdefault(ck, set()).add(key)
        work = list(facts)
        rounds = 0
        while work and rounds < 20000:
            key = work.pop()
            rounds += 1
            f = facts[key]
            s = summaries[key]
            before = s.state()
            self._summarize(f, s, summaries)
            if s.state() != before:
                work.extend(k for k in dependents.get(key, ())
                            if k not in work)
        return summaries

    def _summarize(self, f: _Facts, s: _Summary, summaries) -> None:
        borrowed = self._borrowed_names(f, summaries)
        staging = self._staging_names(f, summaries)
        params = [p for p in f.info.params if p not in ("self", "cls")]
        for ret in f.returns:
            if ret.value is None:
                continue
            origin = self._borrow_origin(ret.value, borrowed, f, summaries)
            if origin is not None:
                s.returns_borrowed = origin[1]
            if self._staging_origin(ret.value, staging, f, summaries):
                s.returns_staging = True
        # parameter escapes: aliases of params count
        alias: dict[str, str] = {p: p for p in params}
        for a in f.assigns:
            if isinstance(a.value, ast.Name) and a.value.id in alias:
                for t in a.targets:
                    if isinstance(t, ast.Name):
                        alias[t.id] = alias[a.value.id]
        for a in f.assigns:
            names = {alias[n.id] for n in walk(a.value)
                     if isinstance(n, ast.Name) and n.id in alias}
            if not names:
                continue
            for t in a.targets:
                root = _root_name(t)
                if isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and root == "self":
                    for p in names:
                        s.param_escapes.setdefault(
                            p, f"stored on '{dotted(t) or 'self'}'")
        for call, callee in f.calls:
            fattr = call.func
            if isinstance(fattr, ast.Attribute) and fattr.attr in MUTATORS:
                root = _root_name(fattr.value)
                if root == "self":
                    for arg in call.args:
                        for n in walk(arg):
                            if isinstance(n, ast.Name) and n.id in alias:
                                s.param_escapes.setdefault(
                                    alias[n.id],
                                    f"queued on "
                                    f"'{dotted(fattr.value) or root}'")
            if _is_staging_release(call):
                for arg in call.args:
                    for n in walk(arg):
                        if isinstance(n, ast.Name) and n.id in alias:
                            s.param_released.add(alias[n.id])
            if callee is not None:
                cs = summaries.get(callee.key)
                if cs is None:
                    continue
                for arg, pname in _argmap(call, callee):
                    anames = {alias[n.id] for n in walk(arg)
                              if isinstance(n, ast.Name)
                              and n.id in alias}
                    for p in anames:
                        if pname in cs.param_escapes:
                            s.param_escapes.setdefault(
                                p, f"escapes via {callee.qual}() "
                                   f"({cs.param_escapes[pname]})")
                        if pname in cs.param_released:
                            s.param_released.add(p)

    # -- borrow/staging dataflow within one function ----------------------
    def _borrowed_names(self, f: _Facts, summaries) -> dict:
        """name -> ("direct"|"helper", producing call name)."""
        out: dict[str, tuple] = {}
        for _ in range(4):
            changed = False
            for a in f.assigns:
                origin = self._borrow_origin(a.value, out, f, summaries)
                if origin is None:
                    continue
                tgt = a.targets[0]
                names = []
                if isinstance(tgt, ast.Name):
                    names = [tgt.id]
                elif isinstance(tgt, ast.Tuple) and tgt.elts \
                        and isinstance(tgt.elts[0], ast.Name):
                    names = [tgt.elts[0].id]    # data, flag = pack_borrow
                for n in names:
                    if n not in out:
                        out[n] = origin
                        changed = True
            if not changed:
                break
        return out

    def _borrow_origin(self, e, borrowed, f: _Facts,
                       summaries) -> Optional[tuple]:
        while isinstance(e, (ast.Subscript, ast.Starred)):
            e = e.value
        if isinstance(e, ast.Call):
            if _is_owning_call(e):
                return None
            fn = e.func
            if isinstance(fn, ast.Attribute) and fn.attr in BORROW_PRODUCERS:
                return ("direct", fn.attr)
            callee = self._callee_of(e, f)
            if callee is not None:
                cs = summaries.get(callee.key)
                if cs is not None and cs.returns_borrowed is not None:
                    return ("helper", callee.qual)
            return None
        if isinstance(e, ast.Name):
            return borrowed.get(e.id)
        if isinstance(e, ast.Attribute):
            return self._borrow_origin(e.value, borrowed, f, summaries)
        if isinstance(e, ast.Tuple):
            for elt in e.elts:
                o = self._borrow_origin(elt, borrowed, f, summaries)
                if o is not None:
                    return o
        if isinstance(e, ast.IfExp):
            return (self._borrow_origin(e.body, borrowed, f, summaries)
                    or self._borrow_origin(e.orelse, borrowed, f,
                                           summaries))
        return None

    def _staging_names(self, f: _Facts, summaries) -> dict:
        """name -> ("direct"|"helper", producing call description).
        Direct acquires feed the summary only — their local pairing is
        the buffer-ownership pass's job; leak findings here are for
        helper-acquired checkouts."""
        out: dict[str, tuple] = {}
        for a in f.assigns:
            if not isinstance(a.value, ast.Call) \
                    or not isinstance(a.targets[0], ast.Name):
                continue
            if _is_staging_acquire(a.value):
                out[a.targets[0].id] = ("direct", "staging_acquire")
                continue
            callee = self._callee_of(a.value, f)
            if callee is None:
                continue
            cs = summaries.get(callee.key)
            if cs is not None and cs.returns_staging:
                out[a.targets[0].id] = ("helper", callee.qual)
        return out

    def _staging_origin(self, e, staging, f: _Facts, summaries) -> bool:
        while isinstance(e, (ast.Subscript, ast.Starred)):
            e = e.value
        if isinstance(e, ast.Call):
            if _is_staging_acquire(e):
                return True
            callee = self._callee_of(e, f)
            if callee is not None:
                cs = summaries.get(callee.key)
                return cs is not None and cs.returns_staging
            return False
        if isinstance(e, ast.Name):
            return e.id in staging
        if isinstance(e, ast.Tuple):
            return any(self._staging_origin(x, staging, f, summaries)
                       for x in e.elts)
        return False

    def _callee_of(self, call: ast.Call, f: _Facts):
        for c, callee in f.calls:
            if c is call:
                return callee
        return None

    # -- findings ---------------------------------------------------------
    def _check(self, f: _Facts, summaries) -> list:
        out: list[Finding] = []
        mod, qual = f.info.mod, f.info.qual
        borrowed = self._borrowed_names(f, summaries)
        staging = self._staging_names(f, summaries)
        helper_borrowed = {n: o for n, o in borrowed.items()
                           if o[0] == "helper"}
        seen: set = set()

        def flag(node, msg):
            mark = (node.lineno, node.col_offset, msg[:40])
            if mark in seen:
                return
            seen.add(mark)
            out.append(Finding(self.name, mod.path, node.lineno,
                               node.col_offset, msg, qual))

        params = set(f.info.params) - {"self", "cls"}

        # 1. escapes of helper-returned borrowed views (the shapes the
        #    intraprocedural pass checks, for names it cannot see)
        for ret in f.returns:
            if ret.value is None:
                continue
            e = ret.value
            while isinstance(e, (ast.Subscript, ast.Starred)):
                e = e.value
            if isinstance(e, ast.Call) and not _is_owning_call(e):
                fn = e.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in BORROW_PRODUCERS:
                    flag(ret, f"returns a borrowed view straight from "
                              f"'{fn.attr}()' — the view dies with this "
                              "call; copy (bytes()/.tobytes()) or keep "
                              "the consumption inside this function")
                    continue
            for n in walk(ret.value):
                if isinstance(n, ast.Name) and n.id in helper_borrowed \
                        and not self._owned_in(ret.value, n):
                    flag(ret, f"borrowed view '{n.id}' (from "
                              f"{helper_borrowed[n.id][1]}()) is "
                              "returned without an owning copy — the "
                              "helper's borrow contract rides through "
                              "this return")
        for a in f.assigns:
            vals = [n for n in walk(a.value)
                    if isinstance(n, ast.Name) and n.id in helper_borrowed
                    and not self._owned_in(a.value, n)]
            if vals:
                for t in a.targets:
                    root = _root_name(t)
                    if isinstance(t, (ast.Attribute, ast.Subscript)) \
                            and (root == "self" or root in params):
                        flag(a, f"borrowed view '{vals[0].id}' (from "
                                f"{helper_borrowed[vals[0].id][1]}()) is "
                                f"stored on '{root}' without an owning "
                                "copy")
        for call, callee in f.calls:
            fattr = call.func
            if isinstance(fattr, ast.Attribute) and fattr.attr in MUTATORS:
                root = _root_name(fattr.value)
                if root == "self" or root in params:
                    for arg in call.args:
                        for n in walk(arg):
                            if isinstance(n, ast.Name) \
                                    and n.id in helper_borrowed \
                                    and not self._owned_in(arg, n):
                                flag(call,
                                     f"borrowed view '{n.id}' (from "
                                     f"{helper_borrowed[n.id][1]}()) is "
                                     "queued on "
                                     f"'{dotted(fattr.value) or root}'")

        # 2. borrowed argument to an escaping parameter (any origin)
        for call, callee in f.calls:
            if callee is None:
                continue
            cs = summaries.get(callee.key)
            if cs is None or not cs.param_escapes:
                continue
            for arg, pname in _argmap(call, callee):
                if pname not in cs.param_escapes:
                    continue
                for n in walk(arg):
                    if isinstance(n, ast.Name) and n.id in borrowed \
                            and not self._owned_in(arg, n):
                        flag(call,
                             f"borrowed view '{n.id}' passed to "
                             f"{callee.qual}() whose parameter "
                             f"'{pname}' escapes "
                             f"({cs.param_escapes[pname]}) — the view "
                             "outlives its producing call")

        # 3. borrowed captured by a deferred callback (any origin)
        out.extend(self._check_captures(f, borrowed))

        # 4. helper-acquired staging checkouts must pair
        out.extend(self._check_staging_leaks(f, staging, summaries))
        return out

    @staticmethod
    def _owned_in(tree, name_node) -> bool:
        """Is ``name_node`` consumed by an owning wrapper inside tree?"""
        for node in walk(tree):
            if isinstance(node, ast.Call) and _is_owning_call(node):
                for sub in walk(node):
                    if sub is name_node:
                        return True
            if isinstance(node, ast.Attribute) \
                    and node.attr in OWNING_METHODS:
                for sub in walk(node):
                    if sub is name_node:
                        return True
        return False

    def _check_captures(self, f: _Facts, borrowed) -> list:
        out = []
        mod, qual = f.info.mod, f.info.qual
        for nested in f.nested:
            body = nested.body if isinstance(nested, ast.Lambda) \
                else nested
            local = {a.arg for a in nested.args.args
                     + nested.args.kwonlyargs + nested.args.posonlyargs}
            captured = sorted({n.id for n in walk(
                body if isinstance(body, ast.AST) else nested)
                if isinstance(n, ast.Name) and n.id in borrowed
                and n.id not in local})
            if not captured:
                continue
            if not self._nested_escapes(f, nested):
                continue
            kind = "lambda" if isinstance(nested, ast.Lambda) \
                else f"'{nested.name}'"
            out.append(Finding(
                self.name, mod.path, nested.lineno, nested.col_offset,
                f"borrowed view '{captured[0]}' is captured by deferred "
                f"callback {kind} that outlives this call — it will run "
                "after the borrow died; copy first", qual))
        return out

    def _nested_escapes(self, f: _Facts, nested) -> bool:
        """Does the nested def/lambda outlive the call?  Stored,
        returned, or passed to any call except known-synchronous
        consumers."""
        name = getattr(nested, "name", None)
        # a lambda handed straight to a synchronous consumer (sorted
        # key=, max, map...) runs inside that call — never deferred,
        # wherever the consumer call itself appears
        for call, _callee in f.calls:
            args = list(call.args) + [kw.value for kw in call.keywords]
            if nested in args and call_name(call).rsplit(
                    ".", 1)[-1] in SYNC_CONSUMERS:
                return False

        def mentions(tree) -> bool:
            for n in walk(tree):
                if n is nested:
                    return True
                if name and isinstance(n, ast.Name) and n.id == name:
                    return True
            return False

        for ret in f.returns:
            if ret.value is not None and mentions(ret.value):
                return True
        for a in f.assigns:
            if mentions(a.value):
                for t in a.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        return True
        for call, _callee in f.calls:
            cname = call_name(call)
            if cname.rsplit(".", 1)[-1] in SYNC_CONSUMERS:
                continue
            for arg in list(call.args) + [kw.value for kw in
                                          call.keywords]:
                if mentions(arg):
                    return True
        return False

    def _check_staging_leaks(self, f: _Facts, staging, summaries) -> list:
        out = []
        if not staging:
            return out
        mod, qual = f.info.mod, f.info.qual
        released: set = set()
        transferred: set = set()
        for call, callee in f.calls:
            if _is_staging_release(call):
                for arg in call.args:
                    for n in walk(arg):
                        if isinstance(n, ast.Name):
                            released.add(n.id)
            elif callee is not None:
                cs = summaries.get(callee.key)
                if cs is None:
                    continue
                for arg, pname in _argmap(call, callee):
                    for n in walk(arg):
                        if isinstance(n, ast.Name):
                            if pname in cs.param_released:
                                released.add(n.id)
                            if pname in cs.param_escapes:
                                transferred.add(n.id)
        for ret in f.returns:
            if ret.value is not None:
                transferred.update(n.id for n in walk(ret.value)
                                   if isinstance(n, ast.Name))
        for a in f.assigns:
            for t in a.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    transferred.update(n.id for n in walk(a.value)
                                       if isinstance(n, ast.Name))
        for name, (origin, producer) in staging.items():
            if origin != "helper":
                continue         # direct pairing: buffer-ownership pass
            if name in released or name in transferred:
                continue
            # find the producing assign for the location
            node = f.info.node
            for a in f.assigns:
                if isinstance(a.targets[0], ast.Name) \
                        and a.targets[0].id == name:
                    node = a
                    break
            out.append(Finding(
                self.name, mod.path, node.lineno,
                getattr(node, "col_offset", 0),
                f"staging checkout '{name}' (acquired through "
                f"{producer}()) is never released, returned, or stored "
                "— pool accounting leaks on every call", qual))
        return out
