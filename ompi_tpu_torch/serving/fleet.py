"""serving/fleet — the multi-tenant serving platform control plane.

Copy of ``ompi_tpu/serving/fleet.py`` with its imports re-pointed: the same
pool specs, admission, recovery, capacity changes and autoscale policy,
under the reference's names, MCA vars, SPC counters, telemetry source
(``fleet``) and trace instant (``fleet_scale``).  The toy model and the KV
slabs stay numpy on the host, so the fleet launches no kernel; its comm
comes from ``ompi_tpu_torch.init()`` (the card's world unless the caller
names ``device="cpu"``).  An autoscaled worker takes its device as its
first argument (``python -m ompi_tpu_torch.serving.worker cuda``), so
``spawn_argv`` names it.

One router and one worker pool serve one model.  A frontier is a
*fleet*: several models and tenants sharing the workers of one job.
This module is the control plane that composes the serving machinery
into that story:

* **named per-model pools** — the fleet partitions the worker ranks
  into pools (one :class:`~ompi_tpu_torch.serving.router.Router` each, all
  on the SHARED communicator), published as ``mpi://serving/pool/
  <model>`` process sets (``tpurun --pool model:ranks`` pre-publishes
  them; :func:`pool_specs_from_psets` resolves placement the way
  ``roles()`` resolves the router).  A pool's prefill and decode
  stages are sized independently (``prefill=``/``decode=`` of
  :class:`PoolSpec` — a prefill rank streams KV slabs to every decode
  rank mapped onto it);
* **fair-share admission** — every request carries a tenant; each
  pool's scheduler runs strict FIFO within a tenant and weighted
  round-robin across tenants (the checkable no-starvation guarantee of
  ``scheduler.py``), so one tenant's burst cannot starve another;
* **prefix-cache-aware routing** — each pool owns a
  :class:`~ompi_tpu_torch.serving.prefix_cache.PrefixRegistry`; requests
  whose prompt shares a registered prefix route to the worker already
  holding those KV blocks and skip the prefill (worker-verified
  generation — stale entries are perf misses, never correctness bugs);
* **telemetry-driven autoscaling** — :class:`FleetAutoscaler` replaces
  the queue-depth watermark with a policy loop over
  ``runtime/telemetry.py`` samples: per-pool scheduler depth, the
  per-pool interval p99 out of the sample's histogram deltas (the SLO
  signal), and stale-rank flags (a worker whose sample seq stopped
  advancing).  Scale-up enlists a parked reserve rank when one exists
  and otherwise spawns a fresh worker via ``dpm.spawn`` (verified
  against the dynamic ``mpi://job/<id>`` pset, merged parents-first);
  scale-down drains an idle worker, removes it from the pool pset and
  parks it in the reserve — the rank stays in the communicator
  (collectives like the next spawn still include it) but holds no pool
  work, modelling released capacity.  Cooldown and the max-workers cap
  are **per pool**: model A absorbing its scale-up must not block a
  needed spawn for model B;
* **one recovery** — pool routers run ``manage_recovery=False``: a
  worker death anywhere revokes the shared comm ONCE, the fleet
  shrinks it once, recomputes every pool's table from surviving world
  ranks, invalidates the prefix registries, and requeues in-flight
  requests — zero admitted requests dropped, fleet-wide.

Everything the fleet decides publishes through the telemetry ``fleet``
SCHEMA key (pool tables, prefix hit/miss, autoscale decisions) so a
reader of the coord KV's samples sees the fleet live, and every scale
decision lands in the otpu-trace ring as a ``fleet_scale`` instant
naming its driving signal.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
from ompi_tpu_torch.api.errors import (ErrorClass, MpiError, ProcFailedError,
                                 RevokedError)
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime import spc, trace
from ompi_tpu_torch.serving.prefix_cache import PrefixRegistry
from ompi_tpu_torch.serving.router import (POOL_HIST_PREFIX, Router)
from ompi_tpu_torch.serving.scheduler import ContinuousBatchScheduler
from ompi_tpu_torch.serving.worker import TAG_CMD

#: pool process sets: ``mpi://serving/pool/<model>`` (tpurun --pool)
PSET_POOL_PREFIX = "mpi://serving/pool/"

_cooldown_var = registry.register(
    "serving", None, "scale_cooldown", vtype=VarType.INT, default=8,
    help="Autoscale cooldown in policy evaluations, tracked PER POOL: "
         "after a pool scales, that pool sits out this many policy "
         "steps so the change can absorb — other pools' decisions are "
         "never blocked by it")
_patience_var = registry.register(
    "serving", None, "scale_patience", vtype=VarType.INT, default=3,
    help="Consecutive policy evaluations a pool's queue depth must "
         "exceed the high watermark before a depth-driven scale-up")
_slo_var = registry.register(
    "serving", None, "slo_p99_ms", vtype=VarType.FLOAT, default=0.0,
    help="Per-pool p99 request-latency SLO in milliseconds, read from "
         "the live telemetry sample's per-pool histogram delta; an "
         "interval p99 above it triggers a telemetry-driven scale-up. "
         "0 (the default) disables the SLO signal")
_idle_var = registry.register(
    "serving", None, "idle_patience", vtype=VarType.INT, default=50,
    help="Consecutive policy evaluations a pool must be completely "
         "idle (no queue, no running requests) before one worker is "
         "drained and parked in the reserve")
_poll_var = registry.register(
    "serving", None, "poll_ticks", vtype=VarType.INT, default=25,
    help="Engine ticks between autoscaler policy evaluations (each "
         "evaluation polls the telemetry samples once)")


class PoolSpec:
    """Static description of one per-model pool.

    ``workers`` are communicator ranks; ``prefill``/``decode`` split
    them into independently sized stage pools (omit both for colocated
    serving).  Scheduler budgets are per pool — two models share the
    job but never a batch."""

    def __init__(self, name: str, workers, prefill=None, decode=None,
                 max_batch: int = 8, max_batch_tokens: int = 1 << 14,
                 slots: Optional[int] = None, decode_chunk: int = 4,
                 kv_elems: int = 256, experts: int = 0) -> None:
        self.name = str(name)
        self.workers = [int(w) for w in workers]
        if not self.workers:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"pool {name!r} needs at least one worker")
        self.prefill = [int(w) for w in prefill] if prefill else None
        self.decode = [int(w) for w in decode] if decode else None
        if (self.prefill is None) != (self.decode is None):
            raise MpiError(ErrorClass.ERR_ARG,
                           f"pool {name!r}: prefill and decode pools "
                           "must be given together")
        self.max_batch = int(max_batch)
        self.max_batch_tokens = int(max_batch_tokens)
        self.slots = slots
        self.decode_chunk = int(decode_chunk)
        self.kv_elems = int(kv_elems)
        #: > 0: an expert-sharded MoE decode pool — each decode worker
        #: homes a contiguous expert range (parallel/moe sharding) and
        #: the router prefers a request's expert home on prefix miss
        self.experts = int(experts)


def pool_specs_from_psets(comm) -> list:
    """Resolve :class:`PoolSpec` tables from the published
    ``mpi://serving/pool/<model>`` process sets (``tpurun --pool``),
    world ranks mapped into ``comm`` — the pset-driven placement path,
    mirroring :func:`ompi_tpu_torch.serving.roles`."""
    client = getattr(comm.rte, "client", None)
    if client is None:
        return []
    try:
        names = [r["name"] for r in client.pset_list()
                 if str(r["name"]).startswith(PSET_POOL_PREFIX)]
    except Exception:
        return []
    in_comm = {w: i for i, w in enumerate(comm.group.world_ranks)}
    specs = []
    for pname in sorted(names):
        entry = client.pset_get(pname)
        members = sorted(in_comm[int(m)] for m in entry["members"]
                         if int(m) in in_comm)
        if members:
            specs.append(PoolSpec(pname[len(PSET_POOL_PREFIX):],
                                  members))
    return specs


class FleetController:
    """The fleet control plane (see module doc): per-model pools over
    one shared communicator, fair-share tenant admission, prefix-aware
    routing, one recovery, and the telemetry autoscaler.

    Pool/reserve tables are mutated on the engine-tick thread and
    snapshotted by the telemetry sampler thread through :meth:`stats`
    — the mutable tables are declared ``_guarded_by`` the fleet lock
    (sends never happen under it)."""

    _guarded_by = {"_pool_world": "_lock", "_reserve": "_lock",
                   "_decision_log": "_lock"}

    def __init__(self, comm, pools: Optional[list] = None,
                 tenants: Optional[dict] = None,
                 spawn_argv: Optional[list] = None,
                 autoscale: Optional[dict] = None,
                 frontdoor: Optional[dict] = None,
                 publish_psets: bool = True) -> None:
        comm.set_errhandler(ERRORS_RETURN)
        self.comm = comm
        if pools is None:
            pools = pool_specs_from_psets(comm)
        if not pools:
            raise MpiError(ErrorClass.ERR_ARG,
                           "fleet needs at least one pool (explicit "
                           "PoolSpec list, or tpurun --pool psets)")
        seen: set = set()
        for spec in pools:
            overlap = seen & set(spec.workers)
            if overlap:
                raise MpiError(ErrorClass.ERR_ARG,
                               f"pool {spec.name!r} shares workers "
                               f"{sorted(overlap)} with another pool")
            seen |= set(spec.workers)
        self.tenants = dict(tenants) if tenants else None
        self.spawn_argv = list(spawn_argv) if spawn_argv else None
        self._lock = threading.Lock()
        self._specs = {s.name: s for s in pools}
        self.routers: dict = {}
        #: pool membership in WORLD ranks — the stable identity across
        #: shrinks and merges (comm ranks are recomputed from it)
        self._pool_world: dict = {}
        self._reserve: list = []       # parked world ranks (capacity)
        self._decision_log: collections.deque = collections.deque(
            maxlen=64)
        self._lost_and_requeued = 0
        for spec in pools:
            reg = PrefixRegistry()
            sched = ContinuousBatchScheduler(
                max_batch=spec.max_batch,
                max_batch_tokens=spec.max_batch_tokens,
                slots=spec.slots, tenants=self.tenants)
            self.routers[spec.name] = Router(
                comm, scheduler=sched, workers=spec.workers,
                prefill_ranks=spec.prefill, decode_ranks=spec.decode,
                prefix_registry=reg, pool=spec.name,
                experts=spec.experts,
                manage_recovery=False, decode_chunk=spec.decode_chunk,
                kv_elems=spec.kv_elems)
            with self._lock:
                self._pool_world[spec.name] = [
                    int(comm.group.world_rank(w)) for w in spec.workers]
        self.me = next(iter(self.routers.values())).me
        self._publish = bool(publish_psets)
        self._publish_pool_psets()
        self.autoscaler = FleetAutoscaler(self, **(autoscale or {}))
        #: the admission plane is strictly opt-in (a kwargs dict, {} for
        #: defaults): with frontdoor=None nothing here runs, no queue
        #: objects exist, and frontdoor.enabled stays False — the
        #: disabled-is-identity pin in test_perf_guard
        self.frontdoor = None
        if frontdoor is not None:
            from ompi_tpu_torch.serving.frontdoor import FrontDoor

            self.frontdoor = FrontDoor(self.routers, **frontdoor)
        from ompi_tpu_torch.runtime import telemetry

        telemetry.register_source("fleet", self.stats)

    # -- placement ---------------------------------------------------------
    def _publish_pool_psets(self) -> None:
        """(Re-)advertise every pool's world-rank membership as its
        ``mpi://serving/pool/<model>`` pset — the leave-pset half of
        retirement and the join half of a scale-up both land here."""
        if not self._publish:
            return
        client = getattr(self.comm.rte, "client", None)
        if client is None:
            return
        with self._lock:
            snapshot = {n: list(m) for n, m in self._pool_world.items()}
        for name, members in snapshot.items():
            try:
                client.pset_publish(PSET_POOL_PREFIX + name, members,
                                    source="user")
            except Exception:
                return                 # coord gone: psets are advisory

    def _comm_rank_of(self, world_rank: int) -> Optional[int]:
        try:
            return self.comm.group.world_ranks.index(int(world_rank))
        except ValueError:
            return None

    def pool_workers(self) -> dict:
        """{pool: [comm ranks]} snapshot (tests, stats)."""
        return {name: list(r.workers) for name, r in self.routers.items()}

    # -- public API --------------------------------------------------------
    def submit(self, tenant: str, model: str, prompt_len: int = 0,
               max_new_tokens: int = 8, prompt=None, rid=None,
               slo: str = ""):
        """Admit one request for ``tenant`` against ``model``'s pool
        (fair-share queued; prompt tokens, when given, feed the
        prefix-cache router).  This path bypasses the front door even
        when one is armed — callers who want admission control submit
        via ``fleet.frontdoor.submit`` and honor its Decision."""
        router = self.routers.get(str(model))
        if router is None:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"no serving pool for model {model!r} "
                           f"(pools: {sorted(self.routers)})")
        return router.submit(prompt_len or 0, max_new_tokens,
                             rid=rid, tenant=tenant, prompt=prompt,
                             slo=slo)

    def completed(self) -> list:
        out = []
        for router in self.routers.values():
            out.extend(router.completed())
        return out

    @property
    def lost_and_requeued(self) -> int:
        return self._lost_and_requeued + sum(
            r.lost_and_requeued for r in self.routers.values())

    def depth(self) -> int:
        return sum(r.sched.depth() for r in self.routers.values())

    def running(self) -> list:
        out = []
        for router in self.routers.values():
            out.extend(router.sched.running())
        return out

    def tick(self) -> None:
        """One fleet engine tick: every pool router ticks, then the
        autoscaler evaluates.  Any ULFM error anywhere routes through
        the ONE shared recovery."""
        try:
            if self.frontdoor is not None:
                # admission first: forwards land before this tick's
                # admit round, and the breach ladder sees last tick's
                # completions
                self.frontdoor.pump()
            for router in self.routers.values():
                router.tick()
            self.autoscaler.step()
        except (RevokedError, ProcFailedError):
            self._recover()

    def serve_until_drained(self, max_ticks: int = 100000,
                            check_invariants: bool = False) -> list:
        ticks = 0
        while True:
            busy = any(r.sched.depth() or r.sched.running()
                       for r in self.routers.values())
            if self.frontdoor is not None and self.frontdoor.depth():
                busy = True        # door-held work still needs forwarding
            if not busy:
                break
            self.tick()
            if check_invariants:
                for router in self.routers.values():
                    router.sched.check_invariants()
                if self.frontdoor is not None:
                    self.frontdoor.check_invariants()
            ticks += 1
            if ticks >= max_ticks:
                raise MpiError(ErrorClass.ERR_INTERN,
                               f"fleet did not drain in {max_ticks} "
                               "ticks (a request starved)")
        return self.completed()

    def shutdown(self) -> None:
        """Stop every worker this fleet can reach — pool members AND
        parked reserve ranks (they idle on the same serve loop)."""
        if self.frontdoor is not None:
            self.frontdoor.close()
        with self._lock:
            reserve = list(self._reserve)
        targets = set()
        for router in self.routers.values():
            targets.update(router.workers)
        for wr in reserve:
            cr = self._comm_rank_of(wr)
            if cr is not None:
                targets.add(cr)
        for w in sorted(targets):
            try:
                self.comm.send_obj(("stop",), w, TAG_CMD)
            except MpiError:
                pass

    # -- recovery (ONE shrink for the whole fleet) -------------------------
    def _recover(self) -> None:
        """Fleet-wide serve-through-failure: revoke + shrink the shared
        comm exactly once, recompute every pool (and the reserve) from
        the surviving world ranks, rebind every router (which
        invalidates its prefix registry and requeues its in-flight
        requests), re-publish the pool psets."""
        try:
            self.comm.revoke()
        except MpiError:
            pass
        new = self.comm.shrink()
        new.set_errhandler(ERRORS_RETURN)
        self.comm = new
        surviving = {int(w): i for i, w in
                     enumerate(new.group.world_ranks)}
        with self._lock:
            for name in self._pool_world:
                self._pool_world[name] = [
                    wr for wr in self._pool_world[name]
                    if wr in surviving]
            self._reserve = [wr for wr in self._reserve
                             if wr in surviving]
            tables = {name: [surviving[wr] for wr in members]
                      for name, members in self._pool_world.items()}
        for name, router in self.routers.items():
            if not tables[name]:
                raise MpiError(
                    ErrorClass.ERR_PROC_FAILED,
                    f"pool {name!r} lost its last worker — the fleet "
                    "cannot serve this model (scale it up first)")
            router.rebind(new, tables[name])
        self.me = next(iter(self.routers.values())).me
        self._publish_pool_psets()

    # -- capacity changes (autoscaler actions) -----------------------------
    def enlist(self, pool: str) -> Optional[int]:
        """Scale-up from the parked reserve: move one reserve rank into
        ``pool``'s table (cheap — no spawn, the rank is already in the
        communicator idling on its serve loop)."""
        with self._lock:
            while self._reserve:
                wr = self._reserve.pop(0)
                cr = self._comm_rank_of(wr)
                if cr is None:
                    continue           # died while parked
                self._pool_world[pool].append(wr)
                break
            else:
                return None
        router = self.routers[pool]
        router.workers = sorted(set(router.workers) | {cr})
        spc.record("serve_enlists")
        self._publish_pool_psets()
        return cr

    def retire(self, pool: str) -> Optional[int]:
        """Scale-down: drain → leave pset → park.  Picks a pool worker
        with nothing running (drained by construction — the policy only
        retires from an idle pool), removes it from the pool table and
        pset, invalidates its prefix-registry entries, and parks its
        rank in the reserve.  The rank stays in the communicator —
        collectives (the next spawn) still include it — but holds no
        pool work: released capacity, re-enlistable for free.

        Stage pools retire STAGE-AWARE: colocated extras go first,
        then the larger of the two stage pools, and the last prefill
        or last decode rank is never taken — removing either would
        wedge the pool with live workers still in it."""
        router = self.routers[pool]
        busy = {r.worker for r in router.sched.running()}
        candidates = [w for w in router.workers if w not in busy]
        if router.stages:
            pre, dec, extra = router._stage_split()
            keep = set()                       # never-take set
            if len(pre) <= 1:
                keep.update(pre)
            if len(dec) <= 1:
                keep.update(dec)
            larger = dec if len(dec) >= len(pre) else pre
            # preference order: colocated extras, then the larger
            # stage pool's newest rank, then anything else legal
            candidates = (
                [w for w in extra if w in candidates]
                + [w for w in reversed(larger)
                   if w in candidates and w not in keep]
                + [w for w in candidates
                   if w not in extra and w not in larger
                   and w not in keep])
            if not candidates:
                return None
            victim = candidates[0]
        else:
            if not candidates or len(router.workers) <= 1:
                return None
            victim = candidates[-1]    # newest-joined rank leaves first
        router.workers = [w for w in router.workers if w != victim]
        if router.registry is not None:
            router.registry.invalidate_worker(victim)
        wr = int(self.comm.group.world_rank(victim))
        with self._lock:
            self._pool_world[pool] = [w for w in self._pool_world[pool]
                                      if w != wr]
            self._reserve.append(wr)
        spc.record("serve_scaledowns")
        self._publish_pool_psets()
        return victim

    def spawn_into(self, pool: str, n: int = 1) -> list:
        """Scale-up by process spawn: every live rank in the shared
        comm participates in ``MPI_Comm_spawn`` (told via a ``scale``
        command this tick), the children are verified against the
        dynamic ``mpi://job/<id>`` pset, merged parents-first (every
        existing rank keeps its rank), and the fresh ranks join
        ``pool``'s table and pset."""
        if self.spawn_argv is None:
            return []
        argv = self.spawn_argv
        targets = set()
        for router in self.routers.values():
            targets.update(router.workers)
        with self._lock:
            for wr in self._reserve:
                cr = self._comm_rank_of(wr)
                if cr is not None:
                    targets.add(cr)
        for w in sorted(targets):
            self.comm.send_obj(("scale", argv, n), w, TAG_CMD)
        inter = self.comm.spawn(argv, n, root=self.me)
        client = getattr(self.comm.rte, "client", None)
        job = getattr(inter, "spawn_job", None)
        if client is not None and job is not None:
            entry = client.pset_get(f"mpi://job/{job}")
            members = sorted(int(m) for m in entry["members"])
            if members != sorted(inter.remote_group.world_ranks):
                raise MpiError(
                    ErrorClass.ERR_SPAWN,
                    f"mpi://job/{job} pset {members} does not match "
                    "the spawned intercomm")
        full = inter.merge(high=False)
        full.set_errhandler(ERRORS_RETURN)
        self.comm = full
        for router in self.routers.values():
            router.comm = full         # ranks preserved: tables stand
        new_ranks = list(range(full.size - n, full.size))
        router = self.routers[pool]
        router.workers = sorted(set(router.workers) | set(new_ranks))
        with self._lock:
            self._pool_world[pool].extend(
                int(full.group.world_rank(r)) for r in new_ranks)
        spc.record("serve_scaleups")
        self._publish_pool_psets()
        return new_ranks

    # -- observability -----------------------------------------------------
    def note_decision(self, decision: dict) -> None:
        with self._lock:
            self._decision_log.append(decision)

    def stats(self) -> Optional[dict]:
        """The telemetry ``fleet`` source: pool tables + queue depths,
        prefix-registry hit/miss, reserve size, recent autoscale
        decisions.  Called on the sampler thread — everything it reads
        is either under the fleet lock or a locked snapshot of its
        own."""
        pools = {}
        for name, router in self.routers.items():
            st = router.sched.stats()
            entry = {"workers": len(router.workers),
                     "queued": st["queued"],
                     "running": st["running"],
                     "prefills": router.prefill_count,
                     "prefix_hits": router.prefix_hit_count}
            if "tenants" in st:
                entry["tenants"] = st["tenants"]
            if router.registry is not None:
                entry["prefix"] = router.registry.stats()
            if router.experts:
                # expert placement snapshot: {expert: home worker} —
                # recomputed from the live table, so a shrink shows
                # the re-shard here immediately
                entry["experts"] = {str(e): w for e, w in
                                    router.expert_table().items()}
            pools[name] = entry
        # otpu-req SLO plane: fold each pool's worst-tenant burn rate
        # into its entry (the controller rank runs every router, so
        # its SLO accountant holds every pool's rolling window)
        from ompi_tpu_torch.runtime import telemetry

        slo = telemetry.slo_snapshot()
        if slo:
            for name, tenants in (slo.get("pools") or {}).items():
                entry = pools.get(name)
                if entry is not None and tenants:
                    entry["slo_burn"] = max(
                        float(t.get("burn", 0.0))
                        for t in tenants.values())
        with self._lock:
            reserve = len(self._reserve)
            decisions = list(self._decision_log)[-8:]
        return {"pools": pools, "reserve": reserve,
                "decisions": decisions,
                "autoscale": self.autoscaler.stats()}


class FleetAutoscaler:
    """The telemetry-driven scaling policy (see module doc).

    Every ``poll_ticks`` engine ticks the policy polls one round of
    telemetry samples — from the coordination-service KV when the job
    has one (each rank's sampler publishes there; the same data
    ``otpu_top`` renders), else from an in-process sampler snapshot —
    and evaluates each pool against three signals, most urgent first:

    1. **p99 SLO** (telemetry): the pool's interval p99 out of the
       router rank sample's ``serve_pool_<model>`` histogram delta
       exceeds ``slo_p99_ms``;
    2. **stale rank** (telemetry): a pool worker's sample seq stopped
       advancing — wedged or dying; capacity is added ahead of the
       failure detector's verdict;
    3. **queue depth** (the legacy watermark, now per pool): depth
       above ``depth_high`` for ``patience`` consecutive evaluations.

    Cooldown and the max-workers cap are tracked PER POOL — one pool
    absorbing its scale-up never blocks another pool's needed spawn.
    Scale-down: a pool completely idle for ``idle_patience``
    evaluations drains one worker into the shared reserve."""

    def __init__(self, fleet: FleetController,
                 depth_high: Optional[int] = None,
                 patience: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 cooldown: Optional[int] = None,
                 max_workers=None,
                 min_workers: int = 1,
                 idle_patience: Optional[int] = None,
                 poll_ticks: Optional[int] = None,
                 watch_stale: bool = True) -> None:
        self.fleet = fleet
        self.depth_high = depth_high
        self.patience = int(patience if patience is not None
                            else _patience_var.value or 3)
        self.slo_p99_ms = float(slo_p99_ms if slo_p99_ms is not None
                                else _slo_var.value or 0.0)
        self.cooldown = int(cooldown if cooldown is not None
                            else _cooldown_var.value or 8)
        #: per-pool cap: int applies to every pool, dict per pool
        self._max_workers = max_workers
        self.min_workers = int(min_workers)
        self.idle_patience = int(idle_patience if idle_patience
                                 is not None else _idle_var.value or 50)
        self.poll_ticks = max(1, int(poll_ticks if poll_ticks
                                     is not None
                                     else _poll_var.value or 25))
        self.watch_stale = bool(watch_stale)
        self._tick = 0
        self._cooling: dict = {}       # pool -> evaluations left
        self._over: dict = {}          # pool -> consecutive deep polls
        self._idle: dict = {}          # pool -> consecutive idle polls
        self._ups = 0
        self._downs = 0
        self._last_signal: Optional[str] = None
        self._local_sampler = None
        self._seq_seen: dict = {}      # world rank -> (seq, monotonic)

    def max_workers_of(self, pool: str) -> Optional[int]:
        if isinstance(self._max_workers, dict):
            return self._max_workers.get(pool)
        return self._max_workers

    def stats(self) -> dict:
        return {"ups": self._ups, "downs": self._downs,
                "last_signal": self._last_signal,
                "cooling": {p: c for p, c in self._cooling.items()
                            if c > 0}}

    # -- telemetry input ---------------------------------------------------
    def _poll_samples(self) -> dict:
        """{world rank: latest telemetry sample}.  Inside a job the
        coord KV has every rank's published sample (the otpu_top
        surface); without a coord service an in-process sampler
        snapshot stands in — same schema, local ranks only."""
        from ompi_tpu_torch.runtime import telemetry

        client = getattr(self.fleet.comm.rte, "client", None)
        if client is not None:
            import json

            out = {}
            for wr in self.fleet.comm.group.world_ranks:
                try:
                    raw = client.get(int(wr), telemetry._KV_KEY,
                                     wait=False)
                except Exception:
                    return {}
                if raw:
                    try:
                        out[int(wr)] = json.loads(raw)
                    except (TypeError, ValueError):
                        pass
            return out
        if self._local_sampler is None:
            rank = int(getattr(self.fleet.comm.rte, "my_world_rank", 0)
                       or 0)
            self._local_sampler = telemetry.Sampler(rank, 1)
        sample = self._local_sampler._sample_once()
        return {sample["rank"]: sample}

    def _stale_ranks(self, samples: dict) -> set:
        """World ranks whose sample seq stopped advancing for longer
        than 3 of their own sampling intervals — wedged, dying, or
        their sampler lost the coord (the otpu_top staleness rule)."""
        if not self.watch_stale:
            return set()
        now = time.monotonic()
        stale: set = set()
        for wr, sample in samples.items():
            seq = int(sample.get("seq", 0))
            iv_s = max(0.05,
                       float(sample.get("interval_ms") or 0) / 1e3)
            last = self._seq_seen.get(wr)
            if last is None or last[0] != seq:
                self._seq_seen[wr] = (seq, now)
                continue
            if now - last[1] > 3 * iv_s:
                stale.add(wr)
        return stale

    def _pool_p99_ms(self, name: str, samples: dict) -> float:
        """The pool's interval p99 (ms) from the ROUTER rank's sample
        histogram delta — the per-coll p99 signal of the live plane."""
        me_world = None
        try:
            me_world = int(self.fleet.comm.group.world_rank(
                self.fleet.me))
        except Exception:
            pass
        sample = samples.get(me_world)
        if sample is None and samples:
            sample = next(iter(samples.values()))
        if not sample:
            return 0.0
        cell = (sample.get("hist") or {}).get(POOL_HIST_PREFIX + name)
        if not cell:
            return 0.0
        return float(cell.get("p99_us", 0.0)) / 1000.0

    # -- the policy loop ---------------------------------------------------
    def step(self) -> None:
        """Called once per fleet tick; evaluates every ``poll_ticks``."""
        self._tick += 1
        if self._tick % self.poll_ticks:
            return
        samples = self._poll_samples()
        stale = self._stale_ranks(samples)
        for name, router in self.fleet.routers.items():
            self._evaluate(name, router, samples, stale)

    def _evaluate(self, name: str, router, samples: dict,
                  stale: set) -> None:
        cooling = self._cooling.get(name, 0)
        if cooling > 0:
            # PER-POOL cooldown: only THIS pool sits the round out
            self._cooling[name] = cooling - 1
            return
        st = router.sched.stats()
        depth, running = st["queued"], st["running"]

        # ---- scale up (signals most-urgent first) ----
        signal, value = None, 0.0
        p99 = self._pool_p99_ms(name, samples)
        if self.slo_p99_ms > 0 and p99 > self.slo_p99_ms:
            signal, value = "p99", p99
        if signal is None and stale:
            pool_world = {int(self.fleet.comm.group.world_rank(w))
                          for w in router.workers}
            wedged = stale & pool_world
            if wedged:
                signal, value = "stale_rank", float(len(wedged))
        if signal is None and self.depth_high is not None:
            if depth > self.depth_high:
                self._over[name] = self._over.get(name, 0) + 1
                if self._over[name] >= self.patience:
                    signal, value = "depth", float(depth)
            else:
                self._over[name] = 0
        if signal is not None:
            self._over[name] = 0
            self._idle[name] = 0
            cap = self.max_workers_of(name)
            if cap is not None and len(router.workers) >= cap:
                return                 # per-pool cap: full, stay put
            self._scale_up(name, signal, value)
            return

        # ---- scale down (drain an idle pool into the reserve) ----
        if depth == 0 and running == 0:
            self._idle[name] = self._idle.get(name, 0) + 1
            if (self._idle[name] >= self.idle_patience
                    and len(router.workers) > self.min_workers):
                self._idle[name] = 0
                victim = self.fleet.retire(name)
                if victim is not None:
                    self._downs += 1
                    self._note(name, "down", "idle", float(victim))
                    self._cooling[name] = self.cooldown
        else:
            self._idle[name] = 0

    def _scale_up(self, name: str, signal: str, value: float) -> None:
        added = self.fleet.enlist(name)
        how = "enlist"
        if added is None:
            spawned = self.fleet.spawn_into(name, 1)
            if not spawned:
                return                 # no reserve, no spawn path
            added = spawned[0]
            how = "spawn"
        self._ups += 1
        self._cooling[name] = self.cooldown
        self._note(name, "up", signal, value, how=how, rank=added)

    def _note(self, pool: str, direction: str, signal: str,
              value: float, **extra) -> None:
        """Record one decision everywhere the acceptance looks: the
        otpu-trace ring (a ``fleet_scale`` instant naming the driving
        signal), the fleet's bounded decision log (telemetry sample),
        and the autoscaler's own counters."""
        self._last_signal = signal
        decision = {"pool": pool, "dir": direction, "signal": signal,
                    "value": round(float(value), 3)}
        decision.update(extra)
        trace.instant("fleet_scale", "serving", dict(decision))
        self.fleet.note_decision(decision)
