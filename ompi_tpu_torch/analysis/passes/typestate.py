"""mpi-typestate — MPI object lifecycles as checkable automata.

MPI objects carry protocol state the type system cannot see: a
persistent request is ``inactive -> (start) -> active -> (wait/test) ->
inactive -> ... -> (free)``, ``Pready`` is legal only on an *active
partitioned send* request, a passive-target epoch opened by
``Win.lock`` must close with ``Win.unlock``, and every
``instance.acquire``/``Session.init`` must pair with its release.  The
runtime raises on SOME of these (loud ERR_REQUEST on a bad Pready), but
leaks — a started request nobody waits on, an epoch nobody closes — are
silent until the hang.

This pass encodes the automata and walks every function, tracking
locals whose creation it can see.  The automata themselves are
**declared in the API modules** (``_TYPESTATE`` dicts in
``api/request.py`` and ``api/win.py``) so the contract lives next to
the code it describes; built-in defaults cover runs over trees that
don't carry the annotation.

Checks:

- **request lifecycle**: double free, use-after-free, double start
  without an intervening completion, ``Pready`` on recv-side /
  non-partitioned / inactive requests, ``Parrived`` on the send side,
  started-but-never-completed and never-escaping requests (leaks),
  nonblocking requests that are never completed.
- **win epochs**: ``unlock``/``unlock_all`` with no open epoch,
  ``lock`` left open at function exit, ``flush`` outside a
  passive-target epoch, PSCW ``start``/``complete`` + ``post``/``wait``
  pairing.
- **refcount pairing**: ``instance.acquire()`` without a comparable
  ``instance.release()`` (and ``Session.init`` without ``finalize``)
  when the handle does not escape the function.
- **guarded handoff** (the staging-checkout family): a value
  popped from a ``_guarded_by``-declared structure under its lock must
  be re-registered into its destination structure *inside the same
  critical section*.  Re-registering in a later ``with`` block — or
  with no lock at all — leaves a window where the object is observable
  as neither free nor checked out, which is exactly how the staging
  pool double-release aliased live checkouts.  The re-registration is
  tracked **through helper calls** (``self._checkout(raw, ...)``) via
  per-function stores-param-into-guarded summaries.

State tracking is deliberately conservative: ops are sequenced only
when they are loop-consistent and on lexically comparable paths (one
branch arm is never sequenced against its sibling), and any escape —
return, store, yield, or passing the object to a call the resolver
can't prove harmless — ends lifecycle tracking for that local.
"""
from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, const_str, register_pass,
                                     walk)
from ompi_tpu_torch.analysis.passes.lock_discipline import (_guard_maps,
                                                            _lock_pairs)

#: request automaton defaults (overridden by api/request.py _TYPESTATE)
REQUEST_DEFAULTS = {
    "create_inactive": ["send_init", "recv_init", "psend_init",
                        "precv_init", "pallreduce_init"],
    "create_active": ["isend", "irecv"],
    "send_side": ["send_init", "psend_init", "isend", "pallreduce_init"],
    "partitioned": ["psend_init", "precv_init", "pallreduce_init"],
    "start": ["start"],
    "start_many": ["start_all", "startall"],
    # on_complete registers a completion callback: the caller IS
    # observing completion, just asynchronously
    "complete": ["wait", "test", "get_status", "on_complete"],
    "complete_many": ["waitall", "waitany", "waitsome", "testall",
                      "testany", "testsome"],
    "free": ["free"],
    "pready": ["pready", "pready_range", "pready_list"],
    "parrived": ["parrived", "parrived_range"],
}

#: win automaton defaults (overridden by api/win.py _TYPESTATE)
WIN_DEFAULTS = {
    "create": ["Win.create", "Win.allocate", "Win.allocate_shared",
               "Win.create_dynamic"],
    "passive_open": ["lock", "lock_all"],
    "passive_close": ["unlock", "unlock_all"],
    "pscw": {"start": "complete", "post": "wait"},
    "in_passive": ["flush", "flush_all"],
}

#: refcount pairs: acquire-call suffix -> (release suffix, is_method)
REFCOUNT_PAIRS = {
    "instance.acquire": ("instance.release", False),
    "Session.init": ("finalize", True),
}

POPPERS = {"pop", "popleft", "popitem"}


def _propagate_derived(fn, seeds) -> dict:
    """name -> root-seed map: seeds plus every local assigned from an
    expression mentioning a seed (``view = raw[:n].view(d)`` makes
    ``view`` carry ``raw``'s obligation).  Bounded fixpoint — chains in
    real code are 1-2 assignments deep."""
    derived = {s: s for s in seeds}
    for _ in range(3):
        changed = False
        for node in walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.targets[0], ast.Name):
                src = {derived[n.id] for n in walk(node.value)
                       if isinstance(n, ast.Name) and n.id in derived}
                t = node.targets[0].id
                if src and t not in derived:
                    derived[t] = sorted(src)[0]
                    changed = True
        if not changed:
            break
    return derived


def _load_typestate(pkg: Package, suffix: str, defaults: dict) -> dict:
    """Read a ``_TYPESTATE`` dict literal from the module whose path ends
    with ``suffix``; fall back to the built-in defaults."""
    mod = pkg.find(suffix)
    if mod is None:
        return defaults
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "_TYPESTATE"
                        for t in stmt.targets) \
                and isinstance(stmt.value, ast.Dict):
            out = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                key = const_str(k)
                if key is None:
                    continue
                if isinstance(v, (ast.List, ast.Tuple)):
                    out[key] = [s for s in map(const_str, v.elts) if s]
                elif isinstance(v, ast.Dict):
                    out[key] = {const_str(dk): const_str(dv)
                                for dk, dv in zip(v.keys, v.values)
                                if const_str(dk) and const_str(dv)}
            merged = dict(defaults)
            merged.update(out)
            return merged
    return defaults


# ---------------------------------------------------------------------------
# lexical path structure: arm paths + loop membership
# ---------------------------------------------------------------------------

class _PathMap:
    """id(node) -> (armpath tuple, frozenset of enclosing loop ids)."""

    def __init__(self, fn):
        self.arm: dict[int, tuple] = {}
        self.loops: dict[int, frozenset] = {}
        self._walk(fn, (), frozenset())

    def _walk(self, node, path, loops) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue               # different frame
            cpath, cloops = path, loops
            if isinstance(node, ast.If):
                arm = 0 if child in node.body else \
                    (1 if child in node.orelse else None)
                if arm is not None:
                    cpath = path + ((id(node), arm),)
            elif isinstance(node, ast.Try):
                arm = 0 if child in node.body else \
                    (1 if child in node.handlers else None)
                if arm is not None:
                    cpath = path + ((id(node), arm),)
            elif isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                if child in node.body:
                    cloops = loops | {id(node)}
            self.arm[id(child)] = cpath
            self.loops[id(child)] = cloops
            self._walk(child, cpath, cloops)

    def comparable(self, a, b) -> bool:
        pa = self.arm.get(id(a), ())
        pb = self.arm.get(id(b), ())
        n = min(len(pa), len(pb))
        return pa[:n] == pb[:n]

    def same_loops(self, a, b) -> bool:
        return self.loops.get(id(a), frozenset()) \
            == self.loops.get(id(b), frozenset())


class _Op:
    __slots__ = ("kind", "node", "attr")

    def __init__(self, kind, node, attr=""):
        self.kind = kind
        self.node = node
        self.attr = attr


@register_pass
class TypestatePass(AnalysisPass):
    name = "mpi-typestate"
    description = ("MPI object lifecycle automata: request "
                   "init/start/wait/free states, Pready/Parrived "
                   "side rules, win epoch nesting, session/instance "
                   "refcount pairing, guarded pop->re-register handoffs")

    def run(self, pkg: Package) -> list[Finding]:
        from ompi_tpu_torch.analysis import callgraph

        graph = callgraph.build(pkg)
        req = _load_typestate(pkg, "request.py", REQUEST_DEFAULTS)
        win = _load_typestate(pkg, "win.py", WIN_DEFAULTS)
        store_summaries = self._guarded_store_summaries(pkg, graph)
        out: list[Finding] = []
        for mod in pkg.modules:
            attr_guards, _g, locks, _c = _guard_maps(mod)
            for fn, qual in mod.functions():
                paths = _PathMap(fn)
                out.extend(self._check_requests(mod, fn, qual, req, paths))
                out.extend(self._check_wins(mod, fn, qual, win, paths))
                out.extend(self._check_refcounts(mod, fn, qual, paths))
                if attr_guards:
                    out.extend(self._check_handoffs(
                        mod, fn, qual, attr_guards, graph, paths,
                        store_summaries))
        return out

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    def _creators(self, fn, names_inactive, names_active) -> dict:
        created: dict[str, tuple] = {}    # name -> (creator attr, node)
        for node in walk(fn):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            f = node.value.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if attr is None:
                continue
            if attr in names_inactive or attr in names_active:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    created[tgt.id] = (attr, node)
        return created

    def _request_ops(self, fn, name, ts) -> list:
        ops: list[_Op] = []
        kinds = {}
        for cat in ("start", "complete", "free", "pready", "parrived"):
            for opname in ts[cat]:
                kinds[opname] = cat
        many = {}
        for opname in ts["start_many"]:
            many[opname] = "start"
        for opname in ts["complete_many"]:
            many[opname] = "complete"
        for node in walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == name:
                    cat = kinds.get(f.attr)
                    ops.append(_Op(cat or "method", node, f.attr))
                    continue
                short = call_name(node).rsplit(".", 1)[-1]
                # keyword arguments count too: waitall(requests=[r]) is
                # a completion, registry.add(req=r) is an escape
                argexprs = list(node.args) + [kw.value
                                              for kw in node.keywords]
                in_args = any(isinstance(n, ast.Name) and n.id == name
                              for a in argexprs for n in walk(a))
                if in_args:
                    if short in many:
                        ops.append(_Op(many[short], node, short))
                    else:
                        ops.append(_Op("escape", node, short))
            elif isinstance(node, ast.Return) and node.value is not None:
                if any(isinstance(n, ast.Name) and n.id == name
                       for n in walk(node.value)):
                    ops.append(_Op("escape", node, "return"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                value = node.value
                uses = value is not None and any(
                    isinstance(n, ast.Name) and n.id == name
                    for n in walk(value))
                if not uses:
                    continue
                for t in targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        ops.append(_Op("escape", node, "store"))
                    elif isinstance(t, ast.Name) and t.id != name:
                        ops.append(_Op("escape", node, "alias"))
            elif isinstance(node, (ast.Yield, ast.YieldFrom)) \
                    and node.value is not None:
                if any(isinstance(n, ast.Name) and n.id == name
                       for n in walk(node.value)):
                    ops.append(_Op("escape", node, "yield"))
        ops.sort(key=lambda o: (o.node.lineno, o.node.col_offset))
        return ops

    def _check_requests(self, mod, fn, qual, ts, paths) -> list:
        out = []
        # a nonblocking request DISCARDED at the statement level never
        # binds a name: its completion — and any error it carries — is
        # structurally unobservable (MPI_Send is isend + wait, not
        # isend + hope)
        active_creators = set(ts["create_active"])
        for node in walk(fn):
            if isinstance(node, ast.Expr) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in active_creators:
                out.append(Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    f"'{node.value.func.attr}()' request is discarded — "
                    "its completion (and any error it carries) is "
                    "unobservable; wait()/test() the request or hand "
                    "it to a wait family", qual))
        created = self._creators(fn, set(ts["create_inactive"]),
                                 active_creators)
        if not created:
            return out
        send_side = set(ts["send_side"])
        partitioned = set(ts["partitioned"])
        inactive = set(ts["create_inactive"])

        def flag(node, msg):
            out.append(Finding(self.name, mod.path, node.lineno,
                               node.col_offset, msg, qual))

        for name, (creator, cnode) in created.items():
            ops = [o for o in self._request_ops(fn, name, ts)
                   if o.node.lineno > cnode.lineno
                   or (o.node.lineno == cnode.lineno
                       and o.node.col_offset >= cnode.col_offset)]
            escaped = any(o.kind == "escape" for o in ops)
            freed: Optional[_Op] = None
            started = creator not in inactive
            completed = False
            active = started
            for op in ops:
                if op.kind == "escape":
                    break                  # caller owns the rest
                if freed is not None and op.kind in (
                        "start", "complete", "pready", "parrived") \
                        and paths.comparable(freed.node, op.node) \
                        and paths.same_loops(freed.node, op.node):
                    flag(op.node,
                         f"request '{name}' used after free() (freed at "
                         f"line {freed.node.lineno}) — the freed request "
                         "is no longer startable/waitable")
                    continue
                if op.kind == "free":
                    if freed is not None \
                            and paths.comparable(freed.node, op.node) \
                            and paths.same_loops(freed.node, op.node):
                        flag(op.node,
                             f"request '{name}' freed twice (first at "
                             f"line {freed.node.lineno})")
                    freed = op
                elif op.kind == "start":
                    if creator not in inactive:
                        flag(op.node,
                             f"start() on '{name}' created by "
                             f"{creator}() — only persistent (_init) "
                             "requests are startable")
                    elif active and not completed \
                            and any(o.kind == "start" and o is not op
                                    and paths.comparable(o.node, op.node)
                                    and paths.same_loops(o.node, op.node)
                                    and o.node.lineno < op.node.lineno
                                    for o in ops):
                        flag(op.node,
                             f"request '{name}' started twice with no "
                             "intervening wait/test — the runtime "
                             "raises ERR_REQUEST on the second start")
                    started, active = True, True
                elif op.kind == "complete":
                    completed = True
                    active = False
                elif op.kind == "pready":
                    if creator not in partitioned:
                        flag(op.node,
                             f"{op.attr}() on '{name}' created by "
                             f"{creator}() — Pready needs a partitioned "
                             "send request (psend_init)")
                    elif creator not in send_side:
                        flag(op.node,
                             f"{op.attr}() on the receive-side request "
                             f"'{name}' ({creator}()) — Pready is "
                             "send-side only; the receiver tests "
                             "Parrived")
                    elif not started:
                        flag(op.node,
                             f"{op.attr}() on inactive request '{name}' "
                             "— partitions can be marked ready only "
                             "between start() and completion")
                elif op.kind == "parrived":
                    if creator not in partitioned:
                        flag(op.node,
                             f"{op.attr}() on '{name}' created by "
                             f"{creator}() — Parrived needs a "
                             "partitioned receive request (precv_init)")
                    elif creator in send_side:
                        flag(op.node,
                             f"{op.attr}() on the send-side request "
                             f"'{name}' ({creator}()) — arrival is "
                             "observable on the receive side only")
            if escaped or freed is not None:
                continue
            if creator in inactive and started and not completed:
                flag(cnode,
                     f"persistent request '{name}' is started but never "
                     "waited/tested or freed in this function and never "
                     "escapes — its completion is unobservable and the "
                     "request leaks")
            elif creator not in inactive and not completed:
                flag(cnode,
                     f"nonblocking request '{name}' ({creator}()) is "
                     "never waited/tested in this function and never "
                     "escapes — completion (and any error) is silently "
                     "dropped")
        return out

    # ------------------------------------------------------------------
    # win epochs
    # ------------------------------------------------------------------
    def _check_wins(self, mod, fn, qual, ts, paths) -> list:
        creators = set(ts["create"])
        created: dict[str, ast.AST] = {}
        for node in walk(fn):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            name = call_name(node.value)
            tail2 = ".".join(name.split(".")[-2:])
            if tail2 in creators or name in creators:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    created[tgt.id] = node
                elif isinstance(tgt, ast.Tuple) and tgt.elts \
                        and isinstance(tgt.elts[0], ast.Name):
                    created[tgt.elts[0].id] = node   # win, buf = allocate
        if not created:
            return []
        out = []
        p_open = set(ts["passive_open"])
        p_close = set(ts["passive_close"])
        pscw = dict(ts["pscw"])
        pscw_close = {v: k for k, v in pscw.items()}
        in_passive = set(ts["in_passive"])

        def flag(node, msg):
            out.append(Finding(self.name, mod.path, node.lineno,
                               node.col_offset, msg, qual))

        for name, cnode in created.items():
            calls = []
            escaped = False
            for node in walk(fn):
                if isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) \
                            and isinstance(f.value, ast.Name) \
                            and f.value.id == name:
                        calls.append((f.attr, node))
                elif isinstance(node, ast.Return) \
                        and node.value is not None:
                    if any(isinstance(n, ast.Name) and n.id == name
                           for n in walk(node.value)):
                        escaped = True
                elif isinstance(node, ast.Assign):
                    if any(isinstance(n, ast.Name) and n.id == name
                           for n in walk(node.value)) \
                            and any(isinstance(t, (ast.Attribute,
                                                   ast.Subscript))
                                    for t in node.targets):
                        escaped = True
            calls.sort(key=lambda c: (c[1].lineno, c[1].col_offset))
            depth = 0
            open_node = None
            pscw_opened: dict[str, ast.AST] = {}
            for attr, node in calls:
                if attr in p_open:
                    if depth == 0:
                        open_node = node
                    depth += 1
                elif attr in p_close:
                    if depth == 0:
                        flag(node,
                             f"'{name}.{attr}()' closes a passive-target "
                             "epoch that was never opened in this "
                             "function — unlock without lock raises "
                             "ERR_RMA_SYNC at the target")
                    else:
                        depth -= 1
                        if depth == 0:
                            open_node = None
                elif attr in in_passive and depth == 0:
                    flag(node,
                         f"'{name}.{attr}()' outside a passive-target "
                         "epoch — flush only orders operations issued "
                         "under lock/lock_all")
                elif attr in pscw:
                    pscw_opened[attr] = node
                elif attr in pscw_close:
                    opener = pscw_close[attr]
                    if opener not in pscw_opened:
                        flag(node,
                             f"'{name}.{attr}()' without a preceding "
                             f"'{name}.{opener}()' — PSCW epochs pair "
                             f"{opener}/{attr}")
                    else:
                        pscw_opened.pop(opener, None)
            if escaped:
                continue
            if depth > 0 and open_node is not None:
                flag(open_node,
                     f"passive-target epoch on '{name}' is opened here "
                     "but never closed in this function — the target "
                     "stays locked (every later accessor hangs)")
            for opener, node in pscw_opened.items():
                flag(node,
                     f"PSCW '{name}.{opener}()' epoch is never closed "
                     f"with '{ts['pscw'][opener]}()' in this function")
        return out

    # ------------------------------------------------------------------
    # session/instance refcount pairing
    # ------------------------------------------------------------------
    def _check_refcounts(self, mod, fn, qual, paths) -> list:
        out = []
        globals_declared: set[str] = set()
        for node in walk(fn):
            if isinstance(node, ast.Global):
                globals_declared.update(node.names)
        acquires = []        # (suffix, node, bound name | None)
        releases = []        # (suffix, node)
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            for acq, (rel, is_method) in REFCOUNT_PAIRS.items():
                if name.endswith(acq):
                    acquires.append((acq, node, None))
                elif not is_method and name.endswith(rel):
                    releases.append((acq, node))
        if not acquires:
            return out
        # bind acquire results to names; method-released pairs look for
        # <name>.<release>() on the bound name
        for stmt in walk(fn):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and isinstance(stmt.targets[0], ast.Name):
                for i, (acq, node, bound) in enumerate(acquires):
                    if stmt.value is node:
                        acquires[i] = (acq, node, stmt.targets[0].id)
        for acq, node, bound in acquires:
            rel, is_method = REFCOUNT_PAIRS[acq]
            if bound is not None and bound in globals_declared:
                continue        # stored module-wide: released elsewhere
            paired = False
            if is_method:
                if bound is None:
                    continue    # result unbound: not trackable
                for sub in walk(fn):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == rel \
                            and isinstance(sub.func.value, ast.Name) \
                            and sub.func.value.id == bound:
                        paired = True
                escaped = False
                for sub in walk(fn):
                    if isinstance(sub, ast.Return) \
                            and sub.value is not None \
                            and any(isinstance(n, ast.Name)
                                    and n.id == bound
                                    for n in walk(sub.value)):
                        escaped = True
                    elif isinstance(sub, ast.Assign) \
                            and any(isinstance(t, (ast.Attribute,
                                                   ast.Subscript))
                                    for t in sub.targets) \
                            and any(isinstance(n, ast.Name)
                                    and n.id == bound
                                    for n in walk(sub.value)):
                        escaped = True
                if escaped:
                    continue
            else:
                paired = any(a == acq and r.lineno > node.lineno
                             for a, r in releases)
                # escape of the returned handle also transfers the ref
                if bound is not None:
                    for sub in walk(fn):
                        if isinstance(sub, ast.Return) \
                                and sub.value is not None \
                                and any(isinstance(n, ast.Name)
                                        and n.id == bound
                                        for n in walk(sub.value)):
                            paired = True
                        elif isinstance(sub, ast.Assign) \
                                and any(isinstance(t, (ast.Attribute,
                                                       ast.Subscript))
                                        for t in sub.targets) \
                                and any(isinstance(n, ast.Name)
                                        and n.id == bound
                                        for n in walk(sub.value)):
                            paired = True
            if not paired:
                out.append(Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    f"'{acq}()' has no paired '{rel}' in this function "
                    "and its handle never escapes — the refcount can "
                    "only grow (teardown never runs)", qual))
        return out

    # ------------------------------------------------------------------
    # guarded handoff (the staging checkout-outside-lock family)
    # ------------------------------------------------------------------
    def _guarded_store_summaries(self, pkg, graph) -> dict:
        """(mod.path, qual) -> {param -> (guarded attr, lock)} for
        functions that store a parameter (or a value derived from it)
        into a _guarded_by-declared structure."""
        out: dict[tuple, dict] = {}
        for mod in pkg.modules:
            attr_guards, _g, _l, _c = _guard_maps(mod)
            if not attr_guards:
                continue
            for fn, qual in mod.functions():
                params = {a.arg for a in fn.args.args + fn.args.kwonlyargs
                          + fn.args.posonlyargs} - {"self", "cls"}
                if not params:
                    continue
                derived = _propagate_derived(fn, params)
                stores: dict[str, tuple] = {}
                for node in walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    vals = {derived[n.id] for n in walk(node.value)
                            if isinstance(n, ast.Name)
                            and n.id in derived}
                    if not vals:
                        continue
                    for t in node.targets:
                        n = t
                        while isinstance(n, ast.Subscript):
                            n = n.value
                        if isinstance(n, ast.Attribute) \
                                and isinstance(n.value, ast.Name) \
                                and n.value.id == "self" \
                                and n.attr in attr_guards:
                            for p in vals:
                                stores.setdefault(
                                    p, (n.attr, attr_guards[n.attr]))
                if stores:
                    out[(mod.path, qual)] = stores
        return out

    def _check_handoffs(self, mod, fn, qual, attr_guards, graph, paths,
                        store_summaries) -> list:
        out = []
        info = graph.function_at(mod, qual)
        # alias map: dq = self._free.get(cls) -> dq means _free
        aliases: dict[str, str] = {}
        for node in walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.targets[0], ast.Name):
                v = node.value
                while isinstance(v, (ast.Call, ast.Subscript,
                                     ast.Attribute)):
                    if isinstance(v, ast.Attribute) \
                            and v.attr in attr_guards:
                        aliases[node.targets[0].id] = v.attr
                        break
                    v = v.func if isinstance(v, ast.Call) else v.value
        # With blocks acquiring declared locks, with their body node ids
        lock_bodies: list[tuple] = []    # (lock, with-node, set of ids)
        declared = set(attr_guards.values())
        for node in walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for _base, lock in _lock_pairs(node):
                    if lock in declared:
                        ids = set()
                        for stmt in node.body:
                            ids.update(id(s) for s in walk(stmt))
                        lock_bodies.append((lock, node, ids))
        if not lock_bodies:
            return out
        # pops of guarded structures under a declared lock
        popped: dict[str, tuple] = {}    # name -> (attr, lock, node)
        for node in walk(fn):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr in POPPERS
                    and isinstance(node.targets[0], ast.Name)):
                continue
            recv = node.value.func.value
            attr = None
            n = recv
            while isinstance(n, (ast.Attribute, ast.Subscript, ast.Call)):
                if isinstance(n, ast.Attribute) and n.attr in attr_guards:
                    attr = n.attr
                    break
                n = n.func if isinstance(n, ast.Call) else n.value
            if attr is None and isinstance(recv, ast.Name):
                attr = aliases.get(recv.id)
            if attr is None:
                continue
            for lock, wnode, ids in lock_bodies:
                if id(node) in ids and lock == attr_guards[attr]:
                    popped[node.targets[0].id] = (attr, lock, node, ids)
        if not popped:
            return out
        # derived names (view = raw[:n].view(...)) carry the handoff
        derived = _propagate_derived(fn, popped)

        def window_finding(node, root, dst_attr, src_attr, lock, how):
            out.append(Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"guarded handoff: '{root}' popped from '{src_attr}' "
                f"under '{lock}' is re-registered into '{dst_attr}' "
                f"{how} — in the window the object is observable as "
                "neither free nor checked out, so a concurrent "
                "double-release/re-acquire passes every guard (the "
                "staging-pool aliasing family); move the "
                "re-registration into the same critical section", qual))

        for node in walk(fn):
            # direct re-register: self._out[...] = <derived>
            if isinstance(node, ast.Assign):
                vals = {derived[n.id] for n in walk(node.value)
                        if isinstance(n, ast.Name) and n.id in derived}
                if not vals:
                    continue
                for t in node.targets:
                    n = t
                    while isinstance(n, ast.Subscript):
                        n = n.value
                    if not (isinstance(n, ast.Attribute)
                            and isinstance(n.value, ast.Name)
                            and n.value.id == "self"
                            and n.attr in attr_guards):
                        continue
                    for root in vals:
                        src_attr, lock, pnode, ids = popped[root]
                        if n.attr == src_attr:
                            continue
                        if attr_guards[n.attr] != lock:
                            continue
                        if id(node) not in ids \
                                and paths.comparable(pnode, node):
                            window_finding(
                                node, root, n.attr, src_attr, lock,
                                "outside the popping critical section")
            # helper re-register: self._checkout(raw, ...) where the
            # callee stores that parameter into a guarded structure
            elif isinstance(node, ast.Call) and info is not None:
                callee = graph.resolve_call(info, node)
                if callee is None:
                    continue
                summary = store_summaries.get(callee.key)
                if not summary:
                    continue
                cparams = list(callee.params)
                if callee.cls is not None and cparams \
                        and cparams[0] in ("self", "cls"):
                    cparams = cparams[1:]
                for i, arg in enumerate(node.args):
                    if i >= len(cparams):
                        break
                    pstore = summary.get(cparams[i])
                    if pstore is None:
                        continue
                    roots = {derived[n.id] for n in walk(arg)
                             if isinstance(n, ast.Name)
                             and n.id in derived}
                    for root in roots:
                        src_attr, lock, pnode, ids = popped[root]
                        dst_attr, dst_lock = pstore
                        if dst_attr == src_attr or dst_lock != lock:
                            continue
                        if id(node) not in ids \
                                and paths.comparable(pnode, node):
                            window_finding(
                                node, root, dst_attr, src_attr, lock,
                                f"by {callee.qual}() called outside "
                                "the popping critical section")
        return out
