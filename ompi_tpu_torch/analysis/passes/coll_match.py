"""collective-matching — rank-divergent collectives are deadlocks.

The classic MPI hang: a collective call reachable under a
rank-conditional branch with no matching call on the other arm.  Rank 0
enters ``comm.gather``; every other rank took the else-branch and is
already three statements ahead — the job stops making progress with no
error anywhere.

Matching rules (tuned against this package's own collectives — the
basic/han modules are a zoo of *legal* rank-conditional shapes):

1. An ``if`` whose test reads a rank splits execution; the two sides
   are the explicit arms, or — when the body ends in ``return`` with no
   ``else`` — the body vs the *continuation* (the statements the
   non-returning ranks fall through to, accumulated through enclosing
   blocks).  ``reduce-to-root + if rank==0: return bcast(...)  /
   return bcast(...)`` therefore matches.
2. Calls are matched per **communicator identity**, not just per
   method: the identity is the call receiver, or the first argument
   when the receiver is a module-style collective provider
   (``self.bcast(comm, ...)``/``_basic.bcast(comm, ...)``).
3. Only identities the branch test actually ranks over are matched:
   ``if low.rank == 0: self._leaders.allreduce(...)`` is the
   hierarchical-collective shape — ``_leaders`` exists only on the
   ranks that took the branch, so it has no matching obligation.  A
   bare ``rank`` name is resolved through ``rank = comm.rank``
   assignments; when it cannot be resolved, every identity must match
   (conservative).
4. Arms that ``raise`` (or call a ``*abort*`` helper) are exempt: an
   erroring rank is torn down by the errhandler, not matched.

Point-to-point calls (send/recv/isend...) are deliberately NOT
matched: asymmetry is their normal shape.  Receivers that are numerics
namespaces (``np``/``jax``/``functools``/...) never count, so
``functools.reduce`` and ``np.add.reduce`` are not collectives.
"""
from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     dotted, register_pass, walk)

#: blocking + nonblocking collective method names (the nonblocking ones
#: diverge at their wait, but the call itself must still be symmetric)
COLLECTIVES = {
    "allreduce", "reduce", "bcast", "barrier", "allgather", "allgatherv",
    "gather", "gatherv", "scatter", "scatterv", "alltoall", "alltoallv",
    "alltoallw", "reduce_scatter", "reduce_scatter_block", "scan",
    "exscan",
    "iallreduce", "ireduce", "ibcast", "ibarrier", "iallgather",
    "igather", "iscatter", "ialltoall", "iscan", "iexscan",
}

#: receivers that are numerics/utility namespaces, never communicators
NON_COMM_RECEIVERS = {"np", "numpy", "jnp", "jax", "lax", "functools",
                      "operator", "math", "itertools", "torch", "plt"}

RANK_NAMES = ("rank", "myrank", "my_rank")


def _rank_aliases(fn) -> dict:
    """bare name -> comm dotted name, from ``rank = comm.rank`` /
    ``rank = comm.rank()`` assignments."""
    out: dict[str, str] = {}
    for node in walk(fn):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        if isinstance(v, ast.Call):
            v = v.func
        if isinstance(v, ast.Attribute) and v.attr in RANK_NAMES:
            base = dotted(v.value)
            if base:
                out[node.targets[0].id] = base
    return out


def _tested_identities(test, aliases) -> Optional[set]:
    """Dotted names of the comms whose rank the test reads; None when a
    bare rank name cannot be resolved (then everything must match)."""
    out: set[str] = set()
    unresolved = False
    found = False
    for node in walk(test):
        if isinstance(node, ast.Attribute) and node.attr in RANK_NAMES:
            found = True
            base = dotted(node.value)
            if base:
                out.add(base)
            else:
                unresolved = True
        elif isinstance(node, ast.Name) and node.id in RANK_NAMES:
            found = True
            base = aliases.get(node.id)
            if base:
                out.add(base)
            else:
                unresolved = True
    if not found:
        return set()
    return None if unresolved else out


def _collective_calls(stmts) -> list:
    """(method, identity receiver, first-arg dotted, node) for every
    collective call in the statement list, nested defs excluded."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call) \
                    and isinstance(child.func, ast.Attribute) \
                    and child.func.attr in COLLECTIVES:
                recv = dotted(child.func.value) or ""
                root = recv.split(".")[0] if recv else ""
                if root not in NON_COMM_RECEIVERS:
                    arg0 = dotted(child.args[0]) if child.args else None
                    out.append((child.func.attr, recv, arg0 or "", child))
            visit(child)

    for stmt in stmts:
        visit(stmt)
    return out


def _arm_exits_with_error(stmts) -> bool:
    """An arm that raises (or aborts) is an error path, not a matching
    obligation — the errhandler tears the rank down."""
    for stmt in stmts:
        if isinstance(stmt, ast.Raise):
            return True
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            name = dotted(stmt.value.func) or ""
            if "abort" in name.rsplit(".", 1)[-1].lower():
                return True
    return False


def _terminal_return(stmts) -> bool:
    return bool(stmts) and isinstance(stmts[-1], ast.Return)


@register_pass
class CollectiveMatchingPass(AnalysisPass):
    name = "collective-matching"
    description = ("collectives reachable under rank-conditional "
                   "branches must have a matching call on the other "
                   "arm (or the fall-through continuation) on the "
                   "same communicator")

    def run(self, pkg: Package) -> list[Finding]:
        out: list[Finding] = []
        for mod in pkg.modules:
            for fn, qual in mod.functions():
                aliases = _rank_aliases(fn)
                self._scan_block(mod, fn.body, [], aliases, qual, out,
                                 set())
        return out

    def _scan_block(self, mod, stmts, rest_outer, aliases, qual, out,
                    handled) -> None:
        for i, stmt in enumerate(stmts):
            rest_here = stmts[i + 1:] + rest_outer
            if isinstance(stmt, ast.If) and id(stmt) not in handled \
                    and _tested_identities(stmt.test, aliases) != set():
                self._check_chain(mod, stmt, rest_here, aliases, qual,
                                  out, handled)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    # a `return` inside any nested block exits the
                    # function, so the continuation carries through
                    self._scan_block(mod, sub, rest_here, aliases,
                                     qual, out, handled)
            for h in getattr(stmt, "handlers", ()) or ():
                self._scan_block(mod, h.body, rest_here, aliases,
                                 qual, out, handled)

    @staticmethod
    def _flatten_chain(ifnode, continuation):
        """An if/elif/.../else ladder as a flat arm list.  Returns
        (arms, tests, via): the final implicit arm is the fall-through
        continuation when every explicit arm terminal-returns (then
        ``via`` carries the chain's line for the message), the empty
        arm otherwise."""
        arms, tests = [], []
        node = ifnode
        while True:
            tests.append(node.test)
            arms.append(node.body)
            if len(node.orelse) == 1 and isinstance(node.orelse[0],
                                                    ast.If):
                node = node.orelse[0]
                continue
            break
        via = None
        if node.orelse:
            arms.append(node.orelse)
        elif all(_terminal_return(a) for a in arms):
            arms.append(continuation)
            via = ifnode.lineno
        else:
            arms.append([])
        return arms, tests, via

    def _check_chain(self, mod, ifnode, continuation, aliases, qual,
                     out, handled) -> None:
        """Compare every arm of the (possibly elif-laddered) chain: a
        rank-role ladder where each rank calls the same collectives is
        legal; a call with no counterpart on some sibling arm is the
        deadlock."""
        arms, tests, via = self._flatten_chain(ifnode, continuation)
        # the whole ladder is handled here: the nested elif Ifs must
        # not be re-compared arm-vs-tail by the block scan
        node = ifnode
        while len(node.orelse) == 1 and isinstance(node.orelse[0],
                                                   ast.If):
            node = node.orelse[0]
            handled.add(id(node))
        arms = [a for a in arms if not _arm_exits_with_error(a)]
        if len(arms) < 2:
            return
        tested: Optional[set] = set()
        for t in tests:
            ids = _tested_identities(t, aliases)
            if ids is None:
                tested = None
                break
            tested |= ids

        def key(call) -> Optional[tuple]:
            name, recv, arg0, _node = call
            if tested is None:
                return (name, recv or arg0)
            if recv in tested:
                return (name, recv)
            if arg0 in tested:
                return (name, arg0)
            return None          # membership-scoped sub-communicator

        calls = [_collective_calls(a) for a in arms]
        sets = []
        for arm_calls in calls:
            counts: dict[tuple, int] = {}
            for c in arm_calls:
                k = key(c)
                if k is not None:
                    counts[k] = counts.get(k, 0) + 1
            sets.append(counts)
        if all(s == sets[0] for s in sets[1:]):
            return
        last = len(arms) - 1
        for i, arm_calls in enumerate(calls):
            flagged: dict[tuple, int] = {}
            for call in arm_calls:
                k = key(call)
                if k is None:
                    continue
                floor = min(s.get(k, 0)
                            for j, s in enumerate(sets) if j != i)
                excess = sets[i].get(k, 0) - floor
                if excess <= 0 or flagged.get(k, 0) >= excess:
                    continue
                flagged[k] = flagged.get(k, 0) + 1
                name, _recv, _arg0, node = call
                comm = k[1]
                where = f"on '{comm}'" if comm else ""
                if i == last and via is not None:
                    msg = (f"collective '{name}' {where} is skipped by "
                           f"the rank-conditional return at line {via} "
                           "— only a subset of ranks reaches it: "
                           "deadlock unless every rank takes the same "
                           "path")
                else:
                    msg = (f"collective '{name}' {where} is reachable "
                           "on only some arms of a rank-conditional "
                           f"branch (line {ifnode.lineno}) with no "
                           f"matching '{name}' on every other arm — "
                           "ranks taking another path never enter it: "
                           "deadlock")
                out.append(Finding(self.name, mod.path, node.lineno,
                                   node.col_offset, msg, qual))
