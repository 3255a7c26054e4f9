"""serving/scheduler — the continuous-batching admission scheduler.

Copy of ``ompi_tpu/serving/scheduler.py`` with its imports re-pointed: the
same admission order for the same submissions, the same budgets, the same
``serving`` telemetry source and ``serve_*`` counters.

One object owns the request lifecycle: QUEUED (submitted, waiting) →
RUNNING (admitted into the in-flight batch, holding a KV slot) → DONE.
Every engine tick the router calls :meth:`ContinuousBatchScheduler.tick`,
which first *evicts* sequences that finished since the last tick (their
KV slots return to the free list immediately — the batch is never
drained) and then *admits* queued requests strictly in arrival order
while three budgets hold: batch width (``max_batch``), reserved token
budget (``max_batch_tokens``, counting ``prompt_len + max_new_tokens``
per admitted request), and free KV slots.

Strict-FIFO admission is the no-starvation guarantee the tests pin: a
request is admitted only when it is the OLDEST queued request, so a
stream of short requests can never overtake a long one indefinitely.

**Multi-tenant fair share** (the fleet layer): with ``tenants={name:
weight}`` configured, each tenant owns its own strict-FIFO queue and
admission runs **weighted round-robin across tenants** — each pass of
the cycle lets tenant ``t`` admit up to ``weight[t]`` requests, so one
tenant's burst can delay another by at most one cycle of the others'
quanta, never starve it.  Both guarantees are *checkable*:
:meth:`check_invariants` asserts per-tenant arrival order AND the
cross-tenant bound (a continuously-backlogged tenant is never passed
over for more than two full cycles of the other tenants' quanta — two,
not one, because the tenant table may grow mid-run) against a bounded
admission log.  A request whose head does not fit the width/token/slot
budgets stops the WHOLE admission round — budget head-of-line blocking
is shared, exactly like the single-queue case, so "passed over" can
only mean "the WRR cycle was mid-rotation", which is what the bound
covers.  Untagged requests ride the default tenant ``""`` and a
scheduler constructed without ``tenants`` degenerates to the original
single-queue FIFO bit-for-bit.

Thread discipline: ``submit`` may be called from a driver thread while
the router thread ticks, so every queue/batch structure is declared
``_guarded_by`` the scheduler lock (otpu-lint's lock-discipline pass
enforces the annotation); :meth:`tick` is tagged ``@hot_path`` — it
runs once per engine tick and stays inside the allocation budget the
hot-path pass checks (no pickle, no string formatting, no list concat).
"""
from __future__ import annotations

import collections
import enum
import itertools
import threading
from typing import Optional

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.runtime import spc, trace
from ompi_tpu_torch.runtime.hotpath import hot_path

_rid_counter = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"


class ServeRequest:
    """One inference request travelling through the serving engine.

    ``tenant``/``model`` place the request in the fleet (fair-share
    queue and target pool); ``prompt`` optionally carries the actual
    prompt tokens — with it the router can hash prefix blocks and
    route the request to the worker already holding them (``hashes``
    is the lazily computed digest chain, ``hint`` the
    ``(hash, generation)`` the dispatched worker verifies, and
    ``prefill_skipped`` records whether the hit actually saved the
    prefill).  Without ``prompt`` everything behaves exactly as
    before — prefix awareness is strictly additive."""

    __slots__ = ("rid", "prompt_len", "max_new_tokens", "arrival_ns",
                 "state", "tokens", "slot", "worker", "prefilled",
                 "admit_ns", "done_ns", "tenant", "model", "prompt",
                 "hashes", "hint", "prefill_skipped",
                 "dispatch_ns", "decode_ns", "last_res_ns", "slo")

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 rid: Optional[int] = None, tenant: str = "",
                 model: str = "", prompt=None, slo: str = "") -> None:
        if prompt is not None and not prompt_len:
            prompt_len = len(prompt)
        if prompt_len <= 0 or max_new_tokens <= 0:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"request needs positive prompt/decode "
                           f"lengths, got ({prompt_len}, {max_new_tokens})")
        self.rid = next(_rid_counter) if rid is None else int(rid)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.arrival_ns = trace.now()
        self.state = RequestState.QUEUED
        self.tokens: list = []           # decoded tokens, router-collected
        self.slot: Optional[int] = None  # KV slot while RUNNING
        self.worker: Optional[int] = None
        self.prefilled = False
        self.admit_ns: Optional[int] = None
        self.done_ns: Optional[int] = None
        self.tenant = str(tenant)
        self.model = str(model)
        self.prompt = tuple(int(t) for t in prompt) \
            if prompt is not None else None
        # SLO class ("interactive"/"batch", frontdoor-assigned; ""
        # means unclassified — never shed, never preempted)
        self.slo = str(slo)
        self.hashes: Optional[tuple] = None   # router-computed digests
        self.hint: Optional[tuple] = None     # (hash, generation)
        self.prefill_skipped = False
        # otpu-req stage stamps, written ONLY while trace.requests_
        # enabled (the zero-overhead identity keeps the record path
        # byte-identical with requests tracing off).  Each lifecycle
        # point stamps its time exactly once and every later consumer
        # reuses the stamp — double-now() reads made the queue-wait and
        # dispatch stages overlap in the decomposition.
        self.dispatch_ns: Optional[int] = None  # first cmd sent
        self.decode_ns: Optional[int] = None    # decode window opened
        self.last_res_ns: Optional[int] = None  # last token chunk in

    @property
    def cost(self) -> int:
        """Reserved token budget: prompt + the full decode allowance
        (the batch must never exceed budget even if every admitted
        sequence runs to its cap)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def __repr__(self) -> str:
        return (f"ServeRequest(rid={self.rid}, {self.state.value}, "
                f"prompt={self.prompt_len}, "
                f"decoded={len(self.tokens)}/{self.max_new_tokens})")


class ContinuousBatchScheduler:
    """Admission control for the continuous batch (see module doc)."""

    _guarded_by = {
        "_sq": "_slock", "_running": "_slock", "_done": "_slock",
        "_free_slots": "_slock", "_tq": "_slock", "_tenants": "_slock",
        "_tenant_names": "_slock", "_admit_log": "_slock",
        "_rr": "_slock", "_rr_left": "_slock",
    }

    def __init__(self, max_batch: int = 8,
                 max_batch_tokens: int = 1 << 14,
                 slots: Optional[int] = None,
                 tenants: Optional[dict] = None) -> None:
        if max_batch <= 0 or max_batch_tokens <= 0:
            raise MpiError(ErrorClass.ERR_ARG,
                           "scheduler budgets must be positive")
        self.max_batch = int(max_batch)
        self.max_batch_tokens = int(max_batch_tokens)
        self.slots = int(slots) if slots is not None else self.max_batch
        if self.slots < self.max_batch:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"{self.slots} KV slots cannot back a batch "
                           f"of {self.max_batch}")
        self._slock = threading.Lock()
        # per-tenant strict-FIFO queues; "" is the default tenant and
        # its queue IS the legacy _sq attribute (same list object), so
        # single-tenant callers see the original scheduler unchanged
        self._tenants: dict = {"": 1}
        if tenants:
            for name, weight in tenants.items():
                if int(weight) <= 0:
                    raise MpiError(ErrorClass.ERR_ARG,
                                   f"tenant {name!r} needs a positive "
                                   f"weight, got {weight}")
                self._tenants[str(name)] = int(weight)
        self._tq: dict = {name: [] for name in self._tenants}
        self._sq: list = self._tq[""]   # FIFO admission queue (default)
        self._tenant_names = tuple(self._tenants)
        # bounded admission history backing the cross-tenant
        # no-starvation invariant: (tenant, other-backlogged-tenants)
        self._admit_log: collections.deque = collections.deque(maxlen=256)
        # weighted-round-robin rotation state, persistent ACROSS ticks
        # (resetting per tick would let a heavy tenant monopolize a
        # batch narrower than its quantum forever)
        self._rr = 0
        self._rr_left = self._tenants[self._tenant_names[0]]
        self._running: list = []
        self._done: list = []
        self._free_slots = list(range(self.slots - 1, -1, -1))
        self._used_tokens = 0
        # scheduler depth for otpu_top (latest-constructed scheduler
        # wins the slot; the provider runs on the sampler thread only)
        from ompi_tpu_torch.runtime import telemetry

        telemetry.register_source("serving", self.stats)

    def stats(self) -> dict:
        """Queue/batch depth snapshot (the telemetry ``serving`` source
        and the autoscaler's richer sibling of :meth:`depth`)."""
        with self._slock:
            out = {"queued": sum(len(q) for q in self._tq.values()),
                   "running": len(self._running),
                   "done": len(self._done),
                   "used_tokens": self._used_tokens,
                   "free_slots": len(self._free_slots)}
            if len(self._tq) > 1:
                out["tenants"] = {t: len(q) for t, q in self._tq.items()
                                  if q}
            return out

    # -- submission (any thread) -----------------------------------------
    def submit(self, req: ServeRequest) -> ServeRequest:
        if req.cost > self.max_batch_tokens:
            raise MpiError(
                ErrorClass.ERR_ARG,
                f"request {req.rid} reserves {req.cost} tokens, above "
                f"the whole-batch budget {self.max_batch_tokens} — it "
                "could never be admitted")
        spc.record("serve_requests")
        with self._slock:
            q = self._tq.get(req.tenant)
            if q is None:
                # a tenant first seen at submit time joins with weight 1
                # (explicit weights come from the constructor's table)
                self._tenants[req.tenant] = 1
                q = self._tq[req.tenant] = []
                self._tenant_names = tuple(self._tenants)
            q.append(req)
        return req

    def depth(self) -> int:
        """Queued (not yet admitted) request count across every tenant
        — the autoscaling watermark signal."""
        with self._slock:
            return sum(len(q) for q in self._tq.values())

    def tenant_depths(self) -> dict:
        """{tenant: queued count} — the fleet fair-share view."""
        with self._slock:
            return {t: len(q) for t, q in self._tq.items()}

    def running(self) -> list:
        with self._slock:
            return list(self._running)

    def done_count(self) -> int:
        with self._slock:
            return len(self._done)

    def used_tokens(self) -> int:
        with self._slock:
            return self._used_tokens

    # -- engine tick (router thread) -------------------------------------
    @hot_path
    def tick(self) -> tuple:
        """One admission round: (admitted, evicted) lists.

        Eviction first — a sequence that finished last tick frees its
        slot and token reservation for this tick's admissions, which is
        what keeps the batch continuously full instead of draining.
        """
        spc.record("serve_ticks")
        admitted: list = []
        evicted: list = []
        with self._slock:
            keep: list = []
            for r in self._running:
                if r.state is RequestState.DONE:
                    evicted.append(r)
                    self._done.append(r)
                    self._used_tokens -= r.cost
                    if r.slot is not None:
                        self._free_slots.append(r.slot)
                        r.slot = None
                else:
                    keep.append(r)
            self._running = keep
            self._admit_locked(admitted)
        if admitted:
            spc.record("serve_admitted", len(admitted))
        if evicted:
            spc.record("serve_evicted", len(evicted))
        return admitted, evicted

    def _admit_locked(self, admitted: list) -> None:
        """Weighted-round-robin admission (caller holds the scheduler
        lock).  Each cycle pass lets tenant ``t`` admit up to
        ``weight[t]`` oldest requests; a head that does not fit a
        budget ends the WHOLE round (shared head-of-line semantics —
        budget pressure never reorders anybody).  One tenant
        degenerates to the original strict-FIFO loop."""
        names = self._tenant_names
        multi = len(names) > 1
        if self._rr >= len(names):
            self._rr = 0
        while True:
            if not any(self._tq[n] for n in names):
                return
            t = names[self._rr]
            q = self._tq[t]
            if not q or self._rr_left <= 0:
                # empty queue forfeits the rest of the quantum (DRR);
                # either way the NEXT tenant's quantum starts fresh
                self._rr = (self._rr + 1) % len(names)
                self._rr_left = self._tenants[names[self._rr]]
                continue
            head = q[0]
            if len(self._running) >= self.max_batch:
                return
            if self._used_tokens + head.cost > self.max_batch_tokens:
                return
            if not self._free_slots:
                return
            # a budget return above leaves the rotation state in place:
            # the next tick resumes THIS tenant's turn — fairness holds
            # across tick boundaries, not only inside one tick (a
            # narrow batch refilling one slot per tick must still walk
            # the whole cycle)
            q.pop(0)
            head.slot = self._free_slots.pop()
            head.state = RequestState.RUNNING
            head.admit_ns = trace.now()
            self._used_tokens += head.cost
            self._running.append(head)
            admitted.append(head)
            self._rr_left -= 1
            if multi:
                # the no-starvation evidence: who was admitted, and
                # which OTHER tenants were backlogged at that moment
                # (check_invariants replays this)
                others = tuple(n for n in names
                               if n != t and self._tq[n])
                self._admit_log.append((t, others))

    def mark_done(self, req: ServeRequest) -> None:
        """Sequence finished decoding: it leaves the batch at the NEXT
        tick's eviction sweep (state flip only — callable from the
        result-drain path without the lock because state is a single
        attribute store and eviction happens on the tick thread)."""
        req.done_ns = trace.now()
        req.state = RequestState.DONE

    # -- failure recovery -------------------------------------------------
    def requeue(self, reqs) -> None:
        """Serve-through-failure: push RUNNING requests back to the
        head of the queue (arrival order preserved) after their worker
        died.  Decoded tokens survive — decode is deterministic, so a
        replacement worker continues from ``len(tokens)``."""
        back = sorted(reqs, key=lambda r: r.arrival_ns)
        with self._slock:
            for r in reversed(back):
                if r not in self._running:
                    continue
                if r.state is RequestState.DONE:
                    # finished before the failure — nothing was lost;
                    # the next tick's eviction sweep retires it (a
                    # requeue here would re-admit a request with no
                    # decode work left, which can never complete again)
                    continue
                self._running.remove(r)
                self._used_tokens -= r.cost
                if r.slot is not None:
                    self._free_slots.append(r.slot)
                    r.slot = None
                r.state = RequestState.QUEUED
                r.worker = None
                r.prefilled = False
                r.hint = None
                # the replay is a fresh attempt: stale stage stamps
                # from the dead worker's dispatch would fold a bogus
                # pre-failure window into the decomposition
                r.dispatch_ns = None
                r.decode_ns = None
                r.last_res_ns = None
                q = self._tq.get(r.tenant)
                if q is None:
                    self._tenants[r.tenant] = 1
                    q = self._tq[r.tenant] = []
                    self._tenant_names = tuple(self._tenants)
                q.insert(0, r)
        spc.record("serve_requeued", len(back))

    def withdraw(self, slo: str) -> list:
        """Pull every QUEUED request of one SLO class out of the tenant
        queues, arrival-ordered — the front door's preemption path:
        after requeueing a pool's RUNNING batch work, the door also
        withdraws the QUEUED batch work so nothing batch re-admits
        ahead of the interactive backlog (withdrawn requests go back
        BEHIND the door; they are never dropped).  Pulling the whole
        class keeps every tenant queue arrival-ordered when the door
        later re-forwards in its own FIFO order."""
        with self._slock:
            out = []
            for q in self._tq.values():
                mine = [r for r in q if r.slo == slo]
                if mine:
                    out.extend(mine)
                    q[:] = [r for r in q if r.slo != slo]
            out.sort(key=lambda r: r.arrival_ns)
            return out

    # -- invariants (tests) ------------------------------------------------
    def check_invariants(self) -> None:
        """Raise AssertionError when a batch/budget/slot invariant is
        violated — the serving tests call this every tick."""
        with self._slock:
            assert len(self._running) <= self.max_batch, \
                "batch width exceeded"
            used = sum(r.cost for r in self._running)
            assert used == self._used_tokens, "token accounting drifted"
            assert used <= self.max_batch_tokens, "token budget exceeded"
            slots = [r.slot for r in self._running]
            assert None not in slots, "RUNNING request without a slot"
            assert len(set(slots)) == len(slots), "slot double-assigned"
            assert set(slots).isdisjoint(self._free_slots), \
                "slot both free and assigned"
            assert len(slots) + len(self._free_slots) == self.slots, \
                "slots leaked"
            # per-tenant strict FIFO: every queue stays arrival-ordered
            for t, q in self._tq.items():
                arr = [r.arrival_ns for r in q]
                assert arr == sorted(arr), \
                    f"tenant {t!r} queue broke arrival order"
            # cross-tenant no-starvation (the fleet fair-share
            # guarantee): replay the admission log — a tenant that was
            # backlogged at every admission in a run of OTHER tenants'
            # admissions is passed over at most two WRR cycles of the
            # others' quanta (two, not one: the tenant table may have
            # grown mid-run, rotating the cycle under it).  Budget
            # blocking cannot inflate the run — a non-fitting head
            # stops the whole round, so nothing after it is logged.
            total_w = sum(self._tenants.values())
            for t, w in self._tenants.items():
                bound = 2 * max(1, total_w - w)
                run = 0
                for adm, backlogged in self._admit_log:
                    if adm == t or t not in backlogged:
                        run = 0
                        continue
                    run += 1
                    assert run <= bound, (
                        f"tenant {t!r} passed over {run} consecutive "
                        f"admissions while backlogged (bound {bound}) "
                        "— fair-share admission starved it")
