"""Fault-tolerant agreement: ``agree_kv``, ``agree_tree`` and the ERA
``agree_p2p``.

Copy of ``ompi_tpu/ft/agreement.py`` (after the reference's ERA consensus,
``ompi/mca/coll/ftagree/coll_ftagree_earlyreturning.c``), three algorithms
coll/ftagree picks from (``otpu_coll_ftagree_algorithm``):

- ``agree_kv``: every live participant publishes its contribution under a
  per-instance key (``ftagree:c:...``); the lowest live participant
  gathers, reduces and races for the instance's single decision slot
  (``ftagree:d:...``, an atomic put-if-absent on the coordination server);
  everyone adopts whatever won the slot, and if a coordinator dies the
  next-lowest live rank takes over;
- ``agree_tree``: a static binomial-tree reduce over point-to-point
  (below ``Comm._check_state``, so it runs on a revoked comm) with
  coverage-tagged partials, anchored on the same uniform slot;
- ``agree_p2p`` (the default): coordination-free ERA over the pml's CTL
  carrier (``ftagree_p2p`` frames): a tree reduce of idempotent
  {rank: contribution} dicts, a two-phase prepare/ack/commit at the root,
  straggler queries (the early return), and a takeover root that collects
  a reply from every live participant before preparing afresh, guarded by
  the pledge (after answering root R's query a rank rejects frames stamped
  by an earlier root).

Each instance is an ``ft`` trace span named after its algorithm
(``_traced_agree``).  Chaos kill points sit before the ``prepare`` and
``decision`` frames (``agree_prepare``, ``agree_decision``,
``agreement.py:441-448``): ``kill:site=agree_prepare,count=k`` dies before
sending prepare frame k+1, the cascading-takeover windows ERA's
early-return tables exist for.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterable, Optional

from ompi_tpu_torch.ft import state as ft_state
from ompi_tpu_torch.runtime import trace


class AgreementError(RuntimeError):
    pass


def _traced_agree(fn):
    """Record one agreement instance as an ``ft`` span — decision latency
    is the FT signal the trace timeline exists to expose (a slow agree is
    a straggler or a takeover round)."""
    def wrapper(*a, **kw):
        if not trace.enabled:
            return fn(*a, **kw)
        inst = kw.get("instance", a[1] if len(a) > 1 else None)
        t0 = trace.now()
        try:
            return fn(*a, **kw)
        finally:
            trace.span(fn.__name__, "ft", t0, args={"instance": str(inst)})

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


def _key(instance: tuple, kind: str) -> str:
    return f"ftagree:{kind}:" + ":".join(str(x) for x in instance)


def _recovery_scope(client):
    """The coord client's recovery budget
    (``CoordClient.recovery_scope``): agreement rounds ARE the
    recovery path — right after a failure every survivor hits the
    coordination server at once, and the steady-state retry ladder
    was measured too short for that burst (the fleet-soak
    coord-timeout flake).  Clients without the scope (tests' fakes)
    get a null context."""
    scope = getattr(client, "recovery_scope", None)
    return scope() if scope is not None else contextlib.nullcontext()


def _setup_instance(rte, instance: tuple, contribution: Any,
                    prev_instance: Optional[tuple]):
    """Common preamble: require the coord client, GC the read-complete
    prior instance (see agree_kv's seq-2 contract), publish my
    contribution as the fallback/takeover anchor."""
    client = getattr(rte, "client", None)
    if client is None:
        raise AgreementError(
            "agreement requires the coordination service (ProcRte)")
    if prev_instance is not None:
        try:
            client.delete(rte.my_world_rank, _key(prev_instance, "c"))
            client.delete(-1, _key(prev_instance, "d"))
        except Exception:
            pass
    rte.modex_put(_key(instance, "c"), contribution)
    return client


@_traced_agree
def agree_kv(
    rte,
    instance: tuple,
    contribution: Any,
    participants: Iterable[int],
    combine: Callable[[Any, Any], Any],
    timeout: float = 60.0,
    poll: float = 0.02,
    prev_instance: Optional[tuple] = None,
) -> tuple[Any, frozenset]:
    """One agreement instance; returns (combined value, agreed failed set).

    ``instance`` must be identical on every participant and unique per call
    (e.g. ``(cid, epoch, seq)``).  ``participants`` are world ranks.
    Contributions are combined in ascending-rank order, so any associative
    reduction is deterministic.

    ``prev_instance``: an instance on the same ordered stream that is
    *read-complete* — every live participant has both finished it AND read
    its decision.  The caller must pass the instance TWO steps back
    (seq-2), not the immediately preceding one: entering seq N proves this
    rank completed N-1, and every live peer is at least past N-2 (inside
    or beyond N-1), hence has read N-2's decision; a slow peer may still
    be parked reading N-1's slot, so N-1 must survive.  Its KV entries are
    deleted here so the coordination server's store stays bounded over
    long-running recovery loops.
    """
    participants = sorted(participants)
    me = rte.my_world_rank
    dkey = _key(instance, "d")
    client = _setup_instance(rte, instance, contribution, prev_instance)
    deadline = time.monotonic() + timeout

    with _recovery_scope(client):
        while True:
            # the decision slot is global (rank namespace -1) and written
            # with an atomic first-writer-wins put, so one value wins
            # uniformly no matter how many coordinators race for it
            got = client.get(-1, dkey, wait=False)
            if got is not None:
                return got
            # am I the lowest live participant? then gather, decide, race
            live = [r for r in participants
                    if not ft_state.is_failed(r)]
            if not live:
                raise AgreementError(
                    f"agreement {instance}: no live participants")
            if live[0] == me:
                decision = _decide(rte, instance, participants, combine,
                                   deadline, poll)
                return client.put_new(-1, dkey, decision)
            if time.monotonic() > deadline:
                raise AgreementError(
                    f"agreement {instance} timed out at rank {me}")
            # park on the decision slot with ONE server-side waiting get
            # instead of busy-polling (O(n^2) RPC load across the job
            # otherwise)
            try:
                got = client.get(-1, dkey, wait=True, timeout=0.5)
            except Exception:
                got = None
            if got is not None:
                return got


@_traced_agree
def agree_tree(
    comm,
    instance: tuple,
    contribution: Any,
    participants: Iterable[int],
    combine: Callable[[Any, Any], Any],
    timeout: float = 60.0,
    prev_instance: Optional[tuple] = None,
) -> tuple[Any, frozenset]:
    """ERA-shaped agreement: binomial-tree p2p reduce + uniform KV slot.

    The reference's ERA (``coll_ftagree_earlyreturning.c``) reduces
    contributions up a resilient tree and rebalances around failures.
    Here the tree is STATIC over the participants list (identical on every
    rank — divergent failure views must not produce divergent trees) and
    carries *coverage-tagged partials* — ``(member_set, partial)`` — so
    the root knows which members a partial represents; coverage a failure
    knocked out of the tree is recovered from the members' published KV
    contributions, and orphans whose parent died fall back to the
    per-instance atomic first-writer-wins decision slot, which every
    waiter polls (the early return) and which makes the outcome uniform
    no matter which path computed it.

    Messaging bypasses the Comm wrappers (pml direct): agreement must
    keep working on a revoked communicator and with failed peers — the
    two cases ``Comm._check_state`` turns into exceptions.

    ``combine`` must be associative AND commutative (partials fold in
    coverage order, not rank order).
    """
    rte = comm.rte
    me = rte.my_world_rank
    participants = sorted(participants)
    ckey = _key(instance, "c")
    dkey = _key(instance, "d")
    client = _setup_instance(rte, instance, contribution, prev_instance)
    deadline = time.monotonic() + timeout

    # STATIC binomial tree over participants: parent clears the lowest
    # set bit; vrank v owns children v + 2^k for k below v's lowest set
    # bit (all bits for the root) — the coll_base_topo binomial shape,
    # shared with agree_p2p via _p2p_tree
    if me in participants:
        parent, children, _ = _p2p_tree(participants, me)
    else:
        parent, children = None, []

    coverage = {me}
    acc = contribution
    # deterministic across processes (hash() is salted per interpreter)
    import zlib

    tag = -(1 << 23) - (zlib.crc32(repr(instance).encode()) % (1 << 20))
    pml = comm.pml

    def _slot() -> Optional[tuple]:
        return client.get(-1, dkey, wait=False)

    def _recv_obj_raw(src_world: int):
        """recv_obj without Comm._check_state (revoked/failed-safe)."""
        import pickle

        import numpy as np

        src = comm.group.rank_of(src_world)
        hdr = np.zeros(1, np.int64)
        pml.recv(comm, hdr, src, tag)
        payload = np.zeros(int(hdr[0]), np.uint8)
        pml.recv(comm, payload, src, tag)
        return pickle.loads(payload.tobytes())

    def _send_obj_raw(obj, dst_world: int) -> None:
        import pickle

        import numpy as np

        dst = comm.group.rank_of(dst_world)
        payload = np.frombuffer(pickle.dumps(obj), np.uint8)
        pml.send(comm, np.array([payload.size], np.int64), dst, tag)
        pml.send(comm, payload, dst, tag)

    # phase up: collect each child's coverage-tagged partial; a dead
    # child's subtree is recovered from the KV by whoever roots
    decided = None
    last_slot_poll = 0.0
    for child in children:
        while decided is None:
            ok, _st = pml.probe(comm, comm.group.rank_of(child), tag,
                                blocking=False)
            if ok:
                try:
                    cov, val = _recv_obj_raw(child)
                except Exception:
                    break          # child died mid-message: KV recovery
                coverage |= set(cov)
                acc = combine(acc, val)
                break
            if ft_state.is_failed(child):
                break
            now = time.monotonic()
            if now - last_slot_poll > 0.1:
                last_slot_poll = now
                decided = _slot()  # someone already decided: early return
            if now > deadline:
                raise AgreementError(f"tree agree {instance} timed out")
        if decided is not None:
            return decided

    if parent is not None and not ft_state.is_failed(parent):
        try:
            _send_obj_raw((sorted(coverage), acc), parent)
        except Exception:
            pass    # parent died mid-send: the slot path covers us
        # park on the uniform decision slot (the root's early return)
        while True:
            try:
                got = client.get(-1, dkey, wait=True, timeout=0.5)
            except Exception:
                got = None
            if got is not None:
                return got
            if time.monotonic() > deadline:
                raise AgreementError(f"tree agree {instance} timed out")
            # root chain may have died: lowest live rank takes over
            live = [r for r in participants if not ft_state.is_failed(r)]
            if live and live[0] == me:
                decision = _decide(rte, instance, participants, combine,
                                   deadline, 0.02)
                return client.put_new(-1, dkey, decision)
    # I root this agreement (or my parent died): fill missing coverage
    # from the KV contributions
    missing = [r for r in participants
               if r not in coverage and not ft_state.is_failed(r)]
    while missing:
        got = _slot()
        if got is not None:
            return got
        still = []
        for r in missing:
            val = rte.modex_get(r, ckey, wait=False)
            if val is not None:
                acc = combine(acc, val)
                coverage.add(r)
            elif not ft_state.is_failed(r):
                still.append(r)
        missing = still
        if missing:
            if time.monotonic() > deadline:
                raise AgreementError(
                    f"tree agree {instance}: missing {missing}")
            time.sleep(0.02)
    failed = frozenset(r for r in participants if ft_state.is_failed(r))
    return client.put_new(-1, dkey, (acc, failed))


def _lowbit(x: int) -> int:
    return (x & -x).bit_length() - 1


def _decide(rte, instance, participants, combine, deadline, poll):
    """Coordinator side: gather live contributions, reduce, decide."""
    ckey = _key(instance, "c")
    values: dict[int, Any] = {}
    known_failed: set[int] = set()
    pending = list(participants)
    while pending:
        still = []
        for r in pending:
            got = rte.modex_get(r, ckey, wait=False)
            if got is not None:
                values[r] = got
            elif ft_state.is_failed(r):
                known_failed.add(r)
            else:
                still.append(r)
        pending = still
        if pending:
            if time.monotonic() > deadline:
                raise AgreementError(
                    f"agreement {instance} timed out waiting for {pending}")
            time.sleep(poll)
    out = None
    for r in sorted(values):
        out = values[r] if out is None else combine(out, values[r])
    known_failed.update(r for r in participants
                        if ft_state.is_failed(r))
    return out, frozenset(known_failed)




# ======================================================================
# agree_p2p — ERA-grade agreement with NO coordination-service dependency
# ======================================================================
#
# The decision path of ``coll_ftagree_earlyreturning.c`` never touches an
# out-of-band server: contributions reduce up a tree of survivors, the
# root runs a prepare/ack/commit round, and stragglers pull the outcome
# with queries ("early return" — ``:34-36`` keeps per-agreement hash
# tables of passed/ongoing instances exactly for those late queries).
# This is that protocol over the pml's CTL carrier:
#
# - values are IDEMPOTENT {rank: contribution} dicts (merge-safe), so
#   tree rebalancing can never double-count a partial;
# - fast path: static binomial-tree reduce (subtree-complete dicts sent
#   up), root acts when its dict covers every live participant;
# - TWO-PHASE uniformity: the root first broadcasts PREPARE(D) and waits
#   for an ack from every live participant; only then does it commit
#   (DECISION) and return.  No rank returns before the commit exists, and
#   the commit exists only once every survivor holds the prepared value —
#   so a takeover root is guaranteed to find the value (prepared or
#   committed) at some survivor whenever ANY rank (alive or since dead)
#   can have returned it.  This is ERA's ack/commit round; without it a
#   root that decides, returns, and dies forks the outcome;
# - failure recovery: on any failure-knowledge change every undecided
#   rank pushes its dict DIRECTLY to the current root (lowest live);
#   a takeover root must collect a reply (decision / prepared /
#   explicit "undecided") from EVERY live participant before preparing
#   fresh — adopt-before-recompute;
# - late-frame guards: prepare/decision from a known-failed IMMEDIATE
#   sender is discarded, and after answering a takeover root R's query a
#   rank rejects prepare/decision stamped by any earlier root ("pledge");
#   both lean on the perfect-detector assumption ULFM itself makes;
# - GC: the ``prev_instance`` seq-2 contract of agree_kv, plus an LRU cap
#   on completed instances kept for early-return queries.

_P2P_PROTO = "ftagree_p2p"
_p2p_lock = None          # created lazily (threading import cost)
_p2p_instances: dict = {}
_p2p_done_order: list = []
_P2P_DONE_CAP = 512
_p2p_registered = False


def _p2p_state(instance: tuple, create: bool = True):
    st = _p2p_instances.get(instance)
    if st is None and create:
        st = _p2p_instances[instance] = {
            "vals": {},          # rank -> contribution (idempotent merge)
            "prepared": None,    # (value, stamp) once a PREPARE was seen
            "acks": set(),       # ranks that acked MY prepare round
            "decision": None,    # committed outcome
            "by": -1,            # stamp of the committed outcome
            "replies": set(),    # ranks that answered MY query round
            # highest root rank whose query this rank answered while
            # undecided: after pledging to R, prepare/decision frames
            # stamped by an earlier root are rejected
            "answered_root": -1}
    return st


def _p2p_gc(instance: tuple) -> None:
    """LRU-bound completed instances (runs under _p2p_lock)."""
    _p2p_done_order.append(instance)
    while len(_p2p_done_order) > _P2P_DONE_CAP:
        _p2p_instances.pop(_p2p_done_order.pop(0), None)


def _p2p_setup():
    global _p2p_lock, _p2p_registered
    import threading

    if _p2p_lock is None:
        _p2p_lock = threading.Lock()
    if not _p2p_registered:
        from ompi_tpu_torch.mca.pml import ob1

        ob1.register_ctl_handler(_P2P_PROTO, _p2p_on_frag)
        _p2p_registered = True


def _p2p_send(rte, dst_world: int, op: str, instance: tuple,
              payload=None, extra: Optional[dict] = None) -> None:
    import pickle

    import numpy as np

    from ompi_tpu_torch.ft import chaos

    if chaos.enabled and op in ("prepare", "decision"):
        # protocol-phase kill points: 'kill:site=agree_prepare,count=k'
        # dies before sending prepare frame #(k+1)
        chaos.kill_point("agree_" + op)

    from ompi_tpu_torch.mca.bml import resolve_bml
    from ompi_tpu_torch.mca.btl.base import CTL, Frag
    from ompi_tpu_torch.runtime import init as rt

    world = rt.get_world_if_initialized()
    if world is None:
        return
    bml = resolve_bml(world.pml)
    if bml is None:
        return
    try:
        ep = bml.endpoint(dst_world)
        if ep is None:
            return
        meta = {"proto": _P2P_PROTO, "op": op, "inst": instance}
        if extra:
            meta.update(extra)
        data = b"" if payload is None else \
            np.frombuffer(pickle.dumps(payload), np.uint8)
        ep.btl.send(ep, Frag(0, rte.my_world_rank, dst_world, -1, 0, CTL,
                             data, meta=meta))
    except Exception:
        pass   # peer died mid-send: recovery paths cover it


def _p2p_on_frag(frag) -> None:
    import pickle

    inst = tuple(frag.meta["inst"])
    op = frag.meta["op"]
    payload = pickle.loads(bytes(frag.data)) if len(frag.data) else None
    # a query from a self-declared root proves everything below it died —
    # adopt that knowledge before answering (faster than the flood)
    for r in frag.meta.get("failed", ()):
        ft_state.mark_failed(int(r))
    reply = None
    with _p2p_lock:
        st = _p2p_state(inst)
        if op == "vals":
            st["vals"].update(payload)
            if frag.meta.get("answer"):
                st["replies"].add(frag.src)
        elif op == "prepare":
            by = int(frag.meta.get("by", frag.src))
            if ft_state.is_failed(frag.src) or by < st["answered_root"]:
                return   # late frame from a superseded/dead root
            cur = st["prepared"]
            if cur is None or by >= cur[1]:
                st["prepared"] = (payload, by)
            reply = ("pack", None, None)
        elif op == "pack":
            st["acks"].add(frag.src)
        elif op == "prepared":
            # a query reply reporting a prepared-but-uncommitted value
            by = int(frag.meta.get("by", -1))
            cur = st["prepared"]
            if cur is None or by >= cur[1]:
                st["prepared"] = (payload, by)
            if frag.meta.get("answer"):
                st["replies"].add(frag.src)
        elif op == "decision":
            by = int(frag.meta.get("by", frag.src))
            if ft_state.is_failed(frag.src) or by < st["answered_root"]:
                return
            if st["decision"] is None:
                st["decision"] = payload
                st["by"] = by
                _p2p_gc(inst)
        elif op == "query":
            if st["decision"] is not None:
                reply = ("decision", st["decision"],
                         {"by": st["by"]})
            elif st["prepared"] is not None:
                reply = ("prepared", st["prepared"][0],
                         {"by": st["prepared"][1], "answer": True})
            else:
                if frag.meta.get("root"):
                    st["answered_root"] = max(st["answered_root"],
                                              frag.src)
                reply = ("vals", dict(st["vals"]), {"answer": True})
    if reply is not None:
        from ompi_tpu_torch.runtime import init as rt

        world = rt.get_world_if_initialized()
        rte = world.rte if world is not None else None
        if rte is not None:
            rop, rpayload, rextra = reply
            _p2p_send(rte, frag.src, rop, inst, rpayload, extra=rextra)


def _p2p_tree(participants: list, me: int):
    """Static binomial tree: (parent, children, subtree member set).
    Shared by agree_tree and agree_p2p — one tree shape, one formula."""
    n = len(participants)
    idx = participants.index(me)
    max_k = _lowbit(idx) if idx else max(1, n - 1).bit_length()
    children = [participants[idx + (1 << k)] for k in range(max_k)
                if idx + (1 << k) < n]
    parent = None if idx == 0 else participants[idx & (idx - 1)]
    subtree = {me}
    frontier = [participants.index(c) for c in children]
    while frontier:
        j = frontier.pop()
        subtree.add(participants[j])
        kk = _lowbit(j) if j else 0
        frontier.extend(j + (1 << k) for k in range(kk)
                        if j + (1 << k) < n)
    return parent, children, subtree


@_traced_agree
def agree_p2p(
    comm,
    instance: tuple,
    contribution: Any,
    participants: Iterable[int],
    combine: Callable[[Any, Any], Any],
    timeout: float = 60.0,
    prev_instance: Optional[tuple] = None,
) -> tuple[Any, frozenset]:
    """Coordination-free uniform agreement; returns (combined, failed set).

    Safe on revoked communicators (rides the CTL carrier, below
    matching) and with the coordination service completely dead —
    liveness rests only on the failure detector's p2p carriers.
    ``combine`` folds contributions in ascending-rank order.
    """
    from ompi_tpu_torch.runtime.progress import progress

    rte = comm.rte
    me = rte.my_world_rank
    participants = sorted(participants)
    _p2p_setup()
    instance = tuple(instance)
    with _p2p_lock:
        if prev_instance is not None:
            _p2p_instances.pop(tuple(prev_instance), None)
        st = _p2p_state(instance)
        st["vals"][me] = contribution
    original_root = participants[0]
    parent, children, subtree = _p2p_tree(participants, me)
    deadline = time.monotonic() + timeout

    sent_up = False
    last_push_root = original_root
    last_known_failed: frozenset = frozenset()
    # throttle clocks start NOW: a 0.0 epoch would fire every query path
    # on the first iteration and drown the tree fast path in O(n) pulls
    last_query = time.monotonic()
    last_prep = 0.0

    def _commit(decision):
        with _p2p_lock:
            if st["decision"] is None:
                st["decision"] = decision
                st["by"] = me
                _p2p_gc(instance)
            decision, by = st["decision"], st["by"]
        for r in participants:
            if r != me and not ft_state.is_failed(r):
                _p2p_send(rte, r, "decision", instance, decision,
                          extra={"by": by})
        return decision

    while True:
        progress()
        with _p2p_lock:
            decision = st["decision"]
            decided_by = st["by"]
            prepared = st["prepared"]
            vals = dict(st["vals"])
            replies = set(st["replies"])
            acks = set(st["acks"])
        if decision is not None:
            # relay down the live tree so my subtree sees it too
            live = [r for r in participants if not ft_state.is_failed(r)]
            if me in live:
                _, kids, _ = _p2p_tree(live, me)
                for c in kids:
                    _p2p_send(rte, c, "decision", instance, decision,
                              extra={"by": decided_by})
            return decision

        known_failed = frozenset(
            r for r in participants if ft_state.is_failed(r))
        live = [r for r in participants if r not in known_failed]
        if not live:
            raise AgreementError(f"agreement {instance}: no live participants")
        root = live[0]
        now = time.monotonic()

        if me == root:
            if prepared is not None:
                # prepare round: re-push to unacked members; commit once
                # every live participant holds the prepared value
                if all(r in acks or r == me for r in live):
                    return _commit(prepared[0])
                if now - last_prep > 0.05:
                    last_prep = now
                    for r in live:
                        if r != me and r not in acks:
                            _p2p_send(rte, r, "prepare", instance,
                                      prepared[0], extra={"by": me})
            else:
                covered = all(r in vals for r in live)
                ready = covered and (
                    me == original_root
                    or all(r in replies or r == me for r in live))
                if ready:
                    out = None
                    for r in sorted(vals):
                        out = vals[r] if out is None \
                            else combine(out, vals[r])
                    value = (out, frozenset(known_failed))
                    with _p2p_lock:
                        if st["prepared"] is None:
                            st["prepared"] = (value, me)
                        prepared = st["prepared"]
                elif now - last_query > 0.05:
                    # gather: query members I have neither values nor a
                    # query-round answer from (piggybacking my failure
                    # knowledge, which also justifies my root claim)
                    last_query = now
                    for r in live:
                        if r != me and (r not in vals or r not in replies):
                            _p2p_send(rte, r, "query", instance,
                                      extra={"failed": sorted(known_failed),
                                             "root": True})
        else:
            # fast path: send my subtree-complete dict up the static tree
            if not sent_up and not known_failed:
                if all(r in vals for r in subtree):
                    _p2p_send(rte, parent, "vals", instance, vals)
                    sent_up = True
            # recovery: failure-knowledge changes -> push direct to root
            elif known_failed and (known_failed != last_known_failed
                                   or last_push_root != root):
                _p2p_send(rte, root, "vals", instance, vals,
                          extra={"failed": sorted(known_failed)})
                last_push_root = root
                last_known_failed = known_failed
            # straggler pull: periodically ask the root for the outcome
            if now - last_query > 0.25:
                last_query = now
                _p2p_send(rte, root, "query", instance,
                          extra={"failed": sorted(known_failed)})
        if time.monotonic() > deadline:
            raise AgreementError(f"p2p agree {instance} timed out at {me}")
        time.sleep(0.002)
