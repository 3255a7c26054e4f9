"""Serving front door: SLO-tiered admission, rate limiting, and
overload shedding ahead of the continuous-batching routers.

Copy of ``ompi_tpu/serving/frontdoor.py`` with its imports re-pointed: the
same token-bucket arithmetic, shed and preemption decisions, module hooks
and ``frontdoor`` telemetry source.  The fleet that pumps it in the
reference is not copied yet; a door over single routers works as there.

The scheduler (``serving/scheduler.py``) admits fairly among tenants but
admits *everything* — under sustained overload its queues grow without
bound and every class's latency collapses together.  The front door sits
between the driver and the routers and turns overload into policy:

* every request declares an SLO class (``interactive`` or ``batch``) and
  waits in a bounded per-(pool, class) FIFO behind the door;
* per-tenant token buckets rate-limit admission; a request that finds no
  token (or a full class queue) is **shed** with a deterministic
  retry-after hint instead of queued forever — the driver re-arrives it;
* the door forwards into the scheduler only while the scheduler is
  shallow (``otpu_serving_fd_backlog``), interactive first, so the
  in-engine queue stays short and interactive latency stays bounded;
* when a pool's interactive p99 (rolling window of door-observed
  completions) breaches ``otpu_serving_slo_p99_ms``, the door
  **preempts**: RUNNING batch requests are requeued (never dropped),
  QUEUED batch work is withdrawn back behind the door, and batch
  forwarding is held for ``otpu_serving_fd_hold_ticks`` pump cycles.

Shed -> preempt -> scale-up is one escalation ladder: the breach signal
here is the same ``otpu_serving_slo_p99_ms`` the SLO accountant
(``runtime/telemetry.py``) and the fleet autoscaler
(``serving/fleet.py``) read, and every decision is trace-instant'ed and
SPC-counted (``serve_shed`` / ``serve_preempt``).

The module follows the telemetry/profile module-bool discipline: with no
``FrontDoor`` constructed, ``enabled`` is ``False``, ``_active`` is
``None``, no queue objects exist, no threads run (the door never owns a
thread at all — ``pump()`` rides the fleet tick), and the hot-path hook
in ``router._finish`` is one module-attribute check
(``tests/test_torch_frontdoor.py`` holds the hooks against the
reference's).

NOTE import discipline: ``router.py`` imports this module, so this
module must never import ``router`` — only scheduler / telemetry / spc /
trace / var.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime import spc, telemetry, trace
from ompi_tpu_torch.serving.scheduler import RequestState, ServeRequest

#: the two admission classes.  "" on a ServeRequest means unclassified
#: (submitted around the door) — such requests are never shed and never
#: preempted.
SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_BATCH)

#: a breach verdict needs at least this many interactive completions in
#: the rolling window — a p99 over three samples is noise, not a signal
_MIN_WINDOW = 16

_queue_cap_var = registry.register(
    "serving", None, "fd_queue_cap", vtype=VarType.INT, default=64,
    help="Front door: bounded depth of each per-(pool, SLO-class) "
         "admission queue.  A request arriving at a full queue is shed "
         "with a retry-after instead of admitted")
_rate_var = registry.register(
    "serving", None, "fd_rate_rps", vtype=VarType.FLOAT, default=0.0,
    help="Front door: per-tenant token-bucket refill rate "
         "(requests/second).  0 (the default) disables rate limiting — "
         "only queue bounds shed")
_burst_var = registry.register(
    "serving", None, "fd_burst", vtype=VarType.FLOAT, default=8.0,
    help="Front door: token-bucket capacity — how many requests a "
         "tenant may burst above its sustained fd_rate_rps")
_retry_s_var = registry.register(
    "serving", None, "fd_retry_s", vtype=VarType.FLOAT, default=0.05,
    help="Front door: retry-after hint (seconds) attached to queue-full "
         "sheds.  Rate-limit sheds compute their own hint from the "
         "bucket deficit")
_backlog_var = registry.register(
    "serving", None, "fd_backlog", vtype=VarType.INT, default=8,
    help="Front door: forward door-held requests into a pool's "
         "scheduler only while its queued depth is below this "
         "watermark — the in-engine queue stays shallow and the door "
         "keeps class ordering under its own control")
_hold_ticks_var = registry.register(
    "serving", None, "fd_hold_ticks", vtype=VarType.INT, default=50,
    help="Front door: after preempting a pool's batch work on an "
         "interactive-p99 breach, hold batch forwarding for this many "
         "pump cycles so the preemption can actually drain the "
         "interactive backlog before batch re-enters")
_window_var = registry.register(
    "serving", None, "fd_p99_window", vtype=VarType.INT, default=64,
    help="Front door: rolling window (completions) of per-pool "
         "interactive latencies the breach detector computes its p99 "
         "over")

#: module-bool discipline (telemetry/profile pattern): `enabled` is the
#: one-attribute hot-path gate in router._finish; `_active` is the armed
#: door instance.  Both stay inert until a FrontDoor is constructed.
enabled = False
_active: Optional["FrontDoor"] = None


def observe(pool: str, slo: str, dur_ms: float) -> None:
    """Hot-path completion hook (router._finish): feed one finished
    request's latency to the armed door's breach detector.  No-op
    unless a door is armed."""
    fd = _active
    if fd is not None:
        fd.observe(pool, slo, dur_ms)


def disarm(fd: Optional["FrontDoor"] = None) -> None:
    """Disarm the module hooks.  With an instance given, only disarms
    if that instance is the armed one (a closed old door must not
    disarm its replacement)."""
    global enabled, _active
    if fd is None or _active is fd:
        _active = None
        enabled = False


def _arm(fd: "FrontDoor") -> None:
    global enabled, _active
    _active = fd
    enabled = True


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/second refill toward
    a ``burst`` cap; one token per admission.  The clock is injectable
    so tests (and the Poisson driver's virtual time) get bit-exact
    refill math, and a failed take returns the exact deficit wait —
    ``(1 - tokens) / rate`` seconds — which becomes the retry-after
    hint the driver honors."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float,
                 now: float = 0.0) -> None:
        if rate <= 0.0:
            raise MpiError(ErrorClass.ERR_ARG,
                           "token bucket needs a positive rate")
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = float(now)

    def _refill(self, now: float) -> None:
        dt = float(now) - self._last
        if dt > 0.0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self._last = float(now)

    def try_take(self, now: float) -> float:
        """Take one token at time ``now``.  Returns 0.0 on success, or
        the exact wait (seconds) until one token will be available."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class Decision:
    """Outcome of one door submission: either ``request`` (admitted —
    the door now owns it until it forwards into the scheduler) or a
    shed with a ``retry_after_s`` hint and the shed ``reason``
    (``"rate"`` or ``"queue"``)."""

    __slots__ = ("request", "retry_after_s", "reason")

    def __init__(self, request: Optional[ServeRequest],
                 retry_after_s: float, reason: str) -> None:
        self.request = request
        self.retry_after_s = float(retry_after_s)
        self.reason = reason

    @property
    def admitted(self) -> bool:
        return self.request is not None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self.admitted:
            return f"Decision(admitted rid={self.request.rid})"
        return (f"Decision(shed reason={self.reason} "
                f"retry_after={self.retry_after_s:.4f}s)")


class FrontDoor:
    """The admission plane over a fleet's routers.

    Construction arms the module hooks (``enabled`` / ``observe``);
    ``close()`` disarms them.  All mutable state is guarded by one
    lock; ``pump()`` is called from the fleet tick (rank 0's control
    loop) — the door never starts a thread.
    """

    _guarded_by = {
        "_q": "_lock", "_buckets": "_lock", "_tenant_class": "_lock",
        "_lat": "_lock", "_hold": "_lock", "_shed_by": "_lock",
        "_shed_total": "_lock", "_preempt_total": "_lock",
        "_forwarded": "_lock", "_admitted_total": "_lock",
        "_last_retry_s": "_lock", "_breaches": "_lock",
    }

    def __init__(self, routers: Dict[str, object], *,
                 queue_cap: Optional[int] = None,
                 rate_rps: Optional[float] = None,
                 burst: Optional[float] = None,
                 retry_s: Optional[float] = None,
                 backlog: Optional[int] = None,
                 hold_ticks: Optional[int] = None,
                 window: Optional[int] = None,
                 rates: Optional[Dict[str, Tuple[float, float]]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not routers:
            raise MpiError(ErrorClass.ERR_ARG,
                           "front door needs at least one pool router")
        self.routers = dict(routers)
        # config resolves once at construction (var or explicit kwarg)
        self.queue_cap = int(_queue_cap_var.value
                             if queue_cap is None else queue_cap)
        self.rate_rps = float(_rate_var.value
                              if rate_rps is None else rate_rps)
        self.burst = float(_burst_var.value if burst is None else burst)
        self.retry_s = float(_retry_s_var.value
                             if retry_s is None else retry_s)
        self.backlog = int(_backlog_var.value
                           if backlog is None else backlog)
        self.hold_ticks = int(_hold_ticks_var.value
                              if hold_ticks is None else hold_ticks)
        window = int(_window_var.value if window is None else window)
        self._clock = clock
        self._lock = threading.Lock()
        self._q: Dict[Tuple[str, str], collections.deque] = {
            (pool, cls): collections.deque()
            for pool in self.routers for cls in SLO_CLASSES}
        #: per-tenant (rate, burst) overrides; tenants not listed use
        #: the fd_rate_rps/fd_burst defaults
        self._rates = dict(rates or {})
        self._buckets: Dict[str, TokenBucket] = {}
        #: SLO tier is a tenant property: the first class a tenant
        #: submits with sticks, so each scheduler tenant queue stays
        #: arrival-ordered even though the door forwards interactive
        #: ahead of batch
        self._tenant_class: Dict[str, str] = {}
        self._lat = {pool: collections.deque(maxlen=max(window,
                                                        _MIN_WINDOW))
                     for pool in self.routers}
        self._hold = {pool: 0 for pool in self.routers}
        self._shed_by: Dict[str, int] = {}
        self._shed_total = 0
        self._preempt_total = 0
        self._forwarded = 0
        self._admitted_total = 0
        self._breaches = 0
        self._last_retry_s = 0.0
        self._slo_var = None
        telemetry.register_source("frontdoor", self.stats)
        _arm(self)

    # -- admission ---------------------------------------------------------

    def submit(self, tenant: str, model: str = "", prompt_len: int = 0,
               max_new_tokens: int = 8, slo: str = SLO_INTERACTIVE,
               prompt=None, rid: Optional[int] = None) -> Decision:
        """Ask the door for admission.  Returns a ``Decision``: either
        an admitted ``ServeRequest`` (door-held until forwarded — its
        ``arrival_ns`` stamps NOW, so door wait counts toward latency)
        or a shed with a deterministic retry-after."""
        cls = str(slo or SLO_INTERACTIVE)
        if cls not in SLO_CLASSES:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"unknown SLO class {cls!r} (want one of "
                           f"{SLO_CLASSES})")
        pool = str(model)
        if pool not in self.routers:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"unknown pool {pool!r} (have "
                           f"{sorted(self.routers)})")
        tenant = str(tenant)
        now = self._clock()
        with self._lock:
            bound = self._tenant_class.setdefault(tenant, cls)
            if bound != cls:
                raise MpiError(
                    ErrorClass.ERR_ARG,
                    f"tenant {tenant!r} is bound to SLO class "
                    f"{bound!r}; per-tenant FIFO order in the "
                    f"scheduler requires one class per tenant")
            bucket = self._bucket_locked(tenant, now)
            if bucket is not None:
                wait = bucket.try_take(now)
                if wait > 0.0:
                    return self._shed_locked(tenant, pool, cls, wait,
                                             "rate")
            q = self._q[(pool, cls)]
            if len(q) >= self.queue_cap:
                return self._shed_locked(tenant, pool, cls,
                                         self.retry_s, "queue")
            req = ServeRequest(prompt_len, max_new_tokens, rid=rid,
                               tenant=tenant, model=pool, prompt=prompt,
                               slo=cls)
            q.append(req)
            self._admitted_total += 1
        return Decision(req, 0.0, "admitted")

    def _bucket_locked(self, tenant: str,
                       now: float) -> Optional[TokenBucket]:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate, burst = self._rates.get(tenant,
                                          (self.rate_rps, self.burst))
            if rate <= 0.0:
                return None
            bucket = TokenBucket(rate, burst, now=now)
            self._buckets[tenant] = bucket
        return bucket

    def _shed_locked(self, tenant: str, pool: str, cls: str,
                     retry_after_s: float, reason: str) -> Decision:
        retry_after_s = max(1e-6, float(retry_after_s))
        key = f"{tenant}/{cls}"
        self._shed_by[key] = self._shed_by.get(key, 0) + 1
        self._shed_total += 1
        self._last_retry_s = retry_after_s
        spc.record("serve_shed")
        trace.instant("frontdoor_shed", "serving", {
            "tenant": tenant, "pool": pool, "slo": cls,
            "reason": reason,
            "retry_after_ms": round(retry_after_s * 1e3, 3)})
        return Decision(None, retry_after_s, reason)

    # -- pump (rides the fleet tick; rank 0 only, no threads) --------------

    def pump(self) -> None:
        """One admission cycle per pool: age the batch hold, check the
        breach ladder, forward door-held work while the scheduler is
        shallow (interactive first)."""
        for pool, router in self.routers.items():
            with self._lock:
                if self._hold[pool] > 0:
                    self._hold[pool] -= 1
            self._check_breach(pool, router)
            self._forward(pool, router)

    def _target_ms(self) -> float:
        if self._slo_var is None:
            self._slo_var = registry.lookup("otpu_serving_slo_p99_ms")
        return float(self._slo_var.value or 0.0) if self._slo_var \
            else 0.0

    def _check_breach(self, pool: str, router) -> None:
        target = self._target_ms()
        if target <= 0.0:
            return
        with self._lock:
            if self._hold[pool] > 0:
                # a recent preemption is still absorbing — don't stack
                return
            lat = self._lat[pool]
            n = len(lat)
            if n < _MIN_WINDOW:
                return
            snd = sorted(lat)
            p99 = snd[min(n - 1, int(0.99 * n))]
            if p99 <= target:
                return
        self._preempt(pool, router, p99, target)

    def _preempt(self, pool: str, router, p99: float,
                 target: float) -> None:
        """Interactive p99 breached: requeue the pool's RUNNING batch
        work (never dropped — the scheduler keeps its decoded tokens),
        withdraw its QUEUED batch work back behind the door, and hold
        batch forwarding so the freed slots drain interactive."""
        sched = router.sched
        victims = [r for r in sched.running() if r.slo == SLO_BATCH]
        if victims:
            sched.requeue(victims)
        withdrawn = sched.withdraw(SLO_BATCH)
        with self._lock:
            self._hold[pool] = self.hold_ticks
            self._breaches += 1
            if withdrawn:
                # withdrawn work is older than anything door-held —
                # re-insert at the FRONT in reverse arrival order so
                # the door queue stays arrival-sorted
                q = self._q[(pool, SLO_BATCH)]
                for r in sorted(withdrawn, key=lambda r: r.arrival_ns,
                                reverse=True):
                    q.appendleft(r)
            if victims:
                self._preempt_total += len(victims)
            # the breach window served its purpose — reset it so the
            # next verdict is computed from post-preemption completions
            self._lat[pool].clear()
        if victims:
            spc.record("serve_preempt", len(victims))
        trace.instant("frontdoor_preempt", "serving", {
            "pool": pool, "p99_ms": round(p99, 3),
            "target_ms": round(target, 3),
            "preempted": len(victims), "withdrawn": len(withdrawn),
            "hold_ticks": self.hold_ticks})

    def _forward(self, pool: str, router) -> None:
        sched = router.sched
        while sched.depth() < self.backlog:
            req = None
            with self._lock:
                hold = self._hold[pool] > 0
                for cls in SLO_CLASSES:
                    if cls == SLO_BATCH and hold:
                        continue
                    q = self._q[(pool, cls)]
                    if q:
                        req = q.popleft()
                        break
            if req is None:
                return
            sched.submit(req)
            with self._lock:
                self._forwarded += 1

    # -- breach-detector feed (router._finish via module observe()) --------

    def observe(self, pool: str, slo: str, dur_ms: float) -> None:
        if slo != SLO_INTERACTIVE:
            return
        dq = self._lat.get(pool)
        if dq is None:
            return
        with self._lock:
            dq.append(float(dur_ms))

    # -- introspection -----------------------------------------------------

    def depth(self) -> int:
        """Requests currently held behind the door (all pools/classes).
        The driver's drain condition: fleet idle AND door empty AND no
        pending retries."""
        with self._lock:
            return sum(len(q) for q in self._q.values())

    def stats(self) -> dict:
        """Telemetry source for the ``frontdoor`` schema key."""
        with self._lock:
            queued = {f"{pool or '-'}/{cls}": len(q)
                      for (pool, cls), q in self._q.items() if q}
            holds = {p or "-": h for p, h in self._hold.items() if h}
            return {
                "queue_cap": self.queue_cap,
                "queued": queued,
                "admitted": self._admitted_total,
                "forwarded": self._forwarded,
                "shed": self._shed_total,
                "shed_by": dict(self._shed_by),
                "preempts": self._preempt_total,
                "breaches": self._breaches,
                "holds": holds,
                "last_retry_ms": round(self._last_retry_s * 1e3, 3),
                "buckets": {t: round(b.tokens, 3)
                            for t, b in sorted(self._buckets.items())},
            }

    def check_invariants(self) -> None:
        """Soak-time assertions: bounded queues, arrival order, class
        purity of every door queue."""
        with self._lock:
            for (pool, cls), q in self._q.items():
                assert len(q) <= self.queue_cap, \
                    f"door queue {pool}/{cls} over cap: {len(q)}"
                arr = [r.arrival_ns for r in q]
                assert arr == sorted(arr), \
                    f"door queue {pool}/{cls} not arrival-ordered"
                for r in q:
                    assert r.slo == cls, \
                        f"class mix in door queue {pool}/{cls}"
                    assert r.state is RequestState.QUEUED, \
                        f"non-QUEUED request behind the door: {r.rid}"

    def close(self) -> None:
        """Disarm the module hooks.  Door-held requests stay owned by
        whoever drains the fleet (shutdown abandons them like the
        scheduler abandons its queue)."""
        disarm(self)
