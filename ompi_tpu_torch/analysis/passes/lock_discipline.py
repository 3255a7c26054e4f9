"""lock-discipline — declared guards hold, no blocking under them, no cycles.

Three checks over the ``_guarded_by`` annotation convention:

1. **Guarded mutations**: a class declaring
   ``_guarded_by = {"outq": "send_lock"}`` (or a module declaring
   ``_GUARDED_BY = {"_callbacks": "_lock"}``) promises that every
   mutation of that structure happens inside ``with <base>.<lock>:`` on
   the *same base object*.  Methods whose name ends in ``_locked`` (and
   ``__init__``, where the object is not yet shared) are assumed to run
   with the lock held by contract.  Reads are deliberately not checked —
   the codebase uses GIL-atomic snapshot reads throughout.

2. **No blocking calls under a declared lock**: ``time.sleep``, blocking
   socket ops (``sendall``/``connect``/``accept``/``create_connection``/
   ``recv``), and module-local helpers that contain one (depth-1
   closure — how ``coord._send_frame`` is known to block) must not run
   while a declared guard lock is held; a stalled peer would freeze
   every other thread contending on the structure.  ``.wait``/
   ``.wait_for`` are exempt (Condition.wait releases the lock), as are
   the nonblocking-by-contract ``sendmsg``/``recv_into``.

3. **Lock-order acyclicity**: lexically nested ``with`` acquisitions of
   declared locks form a package-wide edge set; a cycle is a deadlock
   waiting for the right interleaving.
"""
from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, const_str, dotted,
                                     register_pass, walk)

MUTATORS = {"append", "appendleft", "extend", "insert", "remove", "pop",
            "popleft", "popitem", "clear", "add", "discard", "update",
            "setdefault", "push", "move_to_end"}

BLOCKING_ATTRS = {"sleep", "sendall", "accept", "connect",
                  "create_connection", "create_server", "getaddrinfo",
                  "recv"}
EXEMPT_ATTRS = {"wait", "wait_for", "sendmsg", "recv_into"}


def _guard_maps(mod):
    """(attr->lock merged across classes, global->lock, declared lock
    names, conflict findings).

    The attr map is module-wide ON PURPOSE: guarded structures are
    mutated through any base object (``conn.outq`` from TcpBtl
    methods), so the attribute name is the contract key.  That makes
    two classes declaring the SAME attr under DIFFERENT locks ambiguous
    — the pass reports the collision instead of silently letting the
    later declaration win (which would check the first class's
    mutations against the wrong lock)."""
    attr_guards: dict[str, str] = {}
    global_guards: dict[str, str] = {}
    conflicts: list[Finding] = []

    def read_dict(node) -> dict:
        out = {}
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                ks, vs = const_str(k), const_str(v)
                if ks and vs:
                    out[ks] = vs
        return out

    for node in walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id == "_guarded_by"
                                for t in stmt.targets):
                    for attr, lock in read_dict(stmt.value).items():
                        have = attr_guards.get(attr)
                        if have is not None and have != lock:
                            conflicts.append(Finding(
                                "lock-discipline", mod.path, stmt.lineno,
                                stmt.col_offset,
                                f"ambiguous _guarded_by: attribute "
                                f"'{attr}' is declared guarded by "
                                f"'{have}' elsewhere in this module and "
                                f"by '{lock}' in class '{node.name}' — "
                                "guard keys are module-wide, rename one "
                                "attribute", node.name))
                        attr_guards[attr] = lock
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "_GUARDED_BY"
                        for t in stmt.targets):
            global_guards.update(read_dict(stmt.value))
    locks = set(attr_guards.values()) | set(global_guards.values())
    return attr_guards, global_guards, locks, conflicts


def _blocking_helpers(mod) -> set:
    """Module-level functions that (directly) make a blocking call."""
    helpers = set()
    for stmt in mod.tree.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in BLOCKING_ATTRS:
                helpers.add(stmt.name)
                break
    return helpers


def _lock_pairs(withstmt) -> list:
    """(base, lockname) pairs a With statement acquires."""
    pairs = []
    for item in withstmt.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Attribute) and isinstance(ctx.value, ast.Name):
            pairs.append((ctx.value.id, ctx.attr))
        elif isinstance(ctx, ast.Name):
            pairs.append((None, ctx.id))
    return pairs


@register_pass
class LockDisciplinePass(AnalysisPass):
    name = "lock-discipline"
    description = ("_guarded_by structures mutate only under their lock, "
                   "no blocking call while a declared lock is held, "
                   "package lock-order graph is acyclic")

    def run(self, pkg: Package) -> list[Finding]:
        out: list[Finding] = []
        edges: dict[tuple, tuple] = {}   # (from, to) -> (mod, line)
        for mod in pkg.modules:
            attr_guards, global_guards, locks, conflicts = _guard_maps(mod)
            out.extend(conflicts)
            blockers = _blocking_helpers(mod) if locks else set()
            for fn, qual in mod.functions():
                exempt = (fn.name.endswith("_locked")
                          or fn.name == "__init__")
                ctx = _FnChecker(self.name, mod, qual, attr_guards,
                                 global_guards, locks, blockers, exempt)
                ctx.visit_body(fn.body, frozenset())
                out.extend(ctx.findings)
                for edge, where in ctx.edges.items():
                    edges.setdefault(edge, where)
        out.extend(self._check_cycles(edges))
        return out

    def _check_cycles(self, edges) -> list:
        graph: dict[str, set] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
        out, state = [], {}

        def dfs(node, stack):
            state[node] = 1
            for nxt in graph.get(node, ()):
                if state.get(nxt) == 1:
                    cyc = stack[stack.index(nxt):] + [nxt] \
                        if nxt in stack else [node, nxt]
                    mod, line = edges[(node, nxt)]
                    out.append(Finding(
                        self.name, mod.path, line, 0,
                        "lock-acquisition-order cycle: "
                        + " -> ".join(cyc)
                        + " (deadlock under the right interleaving)",
                        ""))
                elif state.get(nxt) is None:
                    dfs(nxt, stack + [nxt])
            state[node] = 2

        for node in sorted(graph):
            if state.get(node) is None:
                dfs(node, [node])
        return out


class _FnChecker:
    """Walks one function body carrying the lexically-held lock set."""

    def __init__(self, rule, mod, qual, attr_guards, global_guards,
                 locks, blockers, exempt):
        self.rule = rule
        self.mod = mod
        self.qual = qual
        self.attr_guards = attr_guards
        self.global_guards = global_guards
        self.locks = locks
        self.blockers = blockers
        self.exempt = exempt
        self.aliases: dict[str, tuple] = {}   # local -> (base, attr)
        self.findings: list[Finding] = []
        self.edges: dict[tuple, tuple] = {}
        self.seen: set = set()

    # -- walk -------------------------------------------------------------
    def visit_body(self, body, held: frozenset) -> None:
        for stmt in body:
            self.visit_stmt(stmt, held)

    def visit_stmt(self, stmt, held: frozenset) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pairs = _lock_pairs(stmt)
            for base, lock in pairs:
                if lock in self.locks:
                    for hb, hl in held:
                        if hl in self.locks and hl != lock:
                            self.edges.setdefault(
                                (hl, lock), (self.mod, stmt.lineno))
            self.visit_body(stmt.body, held | set(pairs))
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return   # nested defs execute later, not under these locks
        if isinstance(stmt, ast.Assign) \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Attribute) \
                and isinstance(stmt.value.value, ast.Name):
            # alias: q = conn.outq — later q.popleft() is conn.outq's
            self.aliases[stmt.targets[0].id] = (
                stmt.value.value.id, stmt.value.attr)
        self.check_stmt(stmt, held)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.stmt, ast.excepthandler)):
                self.visit_stmt(child, held)
            elif isinstance(child, ast.expr):
                self.check_expr(child, held)

    # -- checks -----------------------------------------------------------
    def check_stmt(self, stmt, held) -> None:
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for tgt in targets:
                self.check_mutation_target(tgt, held, stmt)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                self.check_mutation_target(tgt, held, stmt)

    def check_expr(self, expr, held) -> None:
        # prune lambda bodies: they execute later, not under these locks
        deferred: set = set()
        for node in walk(expr):
            if isinstance(node, ast.Lambda):
                for sub in walk(node.body):
                    deferred.add(id(sub))
        for node in walk(expr):
            if id(node) in deferred or not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
                key = self.resolve(f.value)
                if key is not None:
                    self.require(key, held, node,
                                 f"{dotted(f.value) or key[1]}.{f.attr}()")
            self.check_blocking(node, held)

    def check_mutation_target(self, tgt, held, stmt) -> None:
        if isinstance(tgt, ast.Name) and isinstance(stmt, ast.Assign):
            # a plain Assign to a bare name rebinds a local (or, for a
            # guarded module global, rewrites module state — only that
            # case is a mutation; alias rebinding is not)
            if tgt.id in self.global_guards:
                self.require((None, tgt.id, self.global_guards[tgt.id]),
                             held, stmt, tgt.id)
            return
        key = self.resolve(tgt)
        if key is not None:
            self.require(key, held, stmt, dotted(tgt) or key[1])

    def resolve(self, node) -> Optional[tuple]:
        """(base, attr, lock) for a guarded attr chain, (None, name, lock)
        for a guarded module global, else None."""
        n = node
        while isinstance(n, (ast.Attribute, ast.Subscript, ast.Call)):
            if isinstance(n, ast.Attribute) \
                    and isinstance(n.value, ast.Name) \
                    and n.attr in self.attr_guards:
                return (n.value.id, n.attr, self.attr_guards[n.attr])
            n = n.func if isinstance(n, ast.Call) else n.value
        if isinstance(n, ast.Name):
            if n.id in self.global_guards:
                return (None, n.id, self.global_guards[n.id])
            alias = self.aliases.get(n.id)
            if alias is not None and alias[1] in self.attr_guards:
                return (alias[0], alias[1], self.attr_guards[alias[1]])
        return None

    def require(self, key, held, node, what) -> None:
        if self.exempt:
            return
        base, name, lock = key
        if (base, lock) in held or (None, lock) in held:
            return
        mark = (node.lineno, node.col_offset, name)
        if mark in self.seen:
            return
        self.seen.add(mark)
        owner = f"{base}." if base else ""
        self.findings.append(Finding(
            self.rule, self.mod.path, node.lineno, node.col_offset,
            f"'{what}' mutates '{name}' (declared guarded by "
            f"'{lock}') outside 'with {owner}{lock}:'", self.qual))

    def check_blocking(self, call, held) -> None:
        declared_held = [l for _b, l in held if l in self.locks]
        if not declared_held:
            return
        f = call.func
        name = None
        if isinstance(f, ast.Attribute):
            if f.attr in EXEMPT_ATTRS:
                return
            if f.attr in BLOCKING_ATTRS:
                name = call_name(call) or f.attr
        elif isinstance(f, ast.Name) and f.id in self.blockers:
            name = f.id
        if name is None:
            return
        mark = (call.lineno, call.col_offset, "blocking")
        if mark in self.seen:
            return
        self.seen.add(mark)
        self.findings.append(Finding(
            self.rule, self.mod.path, call.lineno, call.col_offset,
            f"blocking call '{name}' while holding declared lock(s) "
            f"{', '.join(sorted(set(declared_held)))} — a stalled peer "
            "freezes every thread contending on the guarded structure",
            self.qual))
