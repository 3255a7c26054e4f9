"""serving/router — the request-router rank.

Copy of ``ompi_tpu/serving/router.py`` with its imports re-pointed: the
same stage split, worker choice, expert table, tick, request trace
(``serve_req`` spans and flows under the reference's names), ULFM
recovery with requeue and ``comm.spawn`` autoscaling.

The router owns admission (the continuous-batching scheduler), the
worker table, and the engine clock.  Every :meth:`Router.tick`:

1. **recover** — if the FT layer knows a worker died, revoke the comm
   (so every survivor unblocks with RevokedError), shrink to the
   ``mpi://surviving`` set, re-shard the worker table, and requeue the
   dead worker's in-flight requests — zero admitted requests dropped;
2. **admit** — the scheduler evicts finished sequences and admits
   queued ones into the freed batch space (strict FIFO), each admission
   getting a worker (least-loaded) and a KV slot;
3. **dispatch** — ONE coalesced command message per active worker:
   colocated workers get ``("work", batch, free_rids)``, disaggregated
   stage pairs get ``("prefill", epoch, ...)`` to the prefill rank and
   ``("kv", epoch, ...)`` to its decode peer before the decode work;
4. **collect** — one coalesced result message per dispatched worker;
   each completed sequence is verified (deterministic toy model),
   recorded into the ``serve_request`` otpu-trace latency histogram,
   and marked done so step 2 evicts it next tick;
5. **autoscale** — queue depth above the watermark for
   ``scale_patience`` consecutive ticks triggers ``MPI_Comm_spawn`` of
   ``scale_step`` fresh workers (collective: the workers were told in
   the same tick), verified against the dynamic ``mpi://job/<id>``
   pset, merged parents-first so every rank keeps its rank.

Deployment shapes: ``stages=False`` (default) runs colocated
prefill+decode workers; ``stages=True`` pairs the worker list — first
half prefill, second half decode — and streams KV slabs pair-wise.
After a failure the router always falls back to colocated (a pair may
have lost one side), matching the workers' own recovery.
"""
from __future__ import annotations

import collections
from typing import Optional

from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
from ompi_tpu_torch.api.errors import (ErrorClass, MpiError, ProcFailedError,
                                       RevokedError)
from ompi_tpu_torch.runtime import spc, telemetry, trace
from ompi_tpu_torch.serving import frontdoor as frontdoor_mod
from ompi_tpu_torch.serving import prefix_cache
from ompi_tpu_torch.serving.scheduler import (ContinuousBatchScheduler,
                                              RequestState, ServeRequest)
from ompi_tpu_torch.serving.worker import TAG_CMD, TAG_RES, toy_token

_HIST = "serve_request"
#: per-tenant / per-pool latency-histogram family name prefixes (the
#: driver's per-tenant report and the fleet autoscaler's per-pool p99
#: signal read these; hist_reset per family keeps populations apart)
TENANT_HIST_PREFIX = "serve_tenant_"
POOL_HIST_PREFIX = "serve_pool_"


class Router:
    """Admission + dispatch + recovery for one serving communicator.

    A fleet pool is exactly one Router: ``prefill_ranks`` /
    ``decode_ranks`` size the two stage pools independently (a prefill
    rank streams to every decode rank mapped onto it), ``pool`` names
    the per-pool latency-histogram family, ``prefix_registry`` makes
    routing prefix-cache-aware, and ``manage_recovery=False`` defers
    ULFM recovery to the :class:`~ompi_tpu_torch.serving.fleet.
    FleetController` that owns the shared communicator (several pool
    routers must not each shrink it)."""

    def __init__(self, comm, scheduler: Optional[ContinuousBatchScheduler]
                 = None, stages: bool = False, decode_chunk: int = 4,
                 kv_elems: int = 256,
                 workers: Optional[list] = None,
                 prefill_ranks: Optional[list] = None,
                 decode_ranks: Optional[list] = None,
                 prefix_registry=None,
                 pool: Optional[str] = None,
                 experts: int = 0,
                 manage_recovery: bool = True,
                 scale_watermark: Optional[int] = None,
                 scale_step: int = 1, scale_patience: int = 3,
                 scale_cooldown: int = 50,
                 scale_max_workers: Optional[int] = None,
                 scale_argv: Optional[list] = None) -> None:
        from ompi_tpu_torch import serving as _pkg

        comm.set_errhandler(ERRORS_RETURN)
        self.comm = comm
        self.me, self.workers = _pkg.roles(comm)
        if workers is not None:        # explicit table (tests, subsets)
            self.workers = [int(w) for w in workers if int(w) != self.me]
        if not self.workers:
            raise MpiError(ErrorClass.ERR_ARG,
                           "serving needs at least one worker rank")
        self.sched = scheduler or ContinuousBatchScheduler()
        self.stages = bool(stages) or bool(prefill_ranks)
        self.decode_chunk = int(decode_chunk)
        self.kv_elems = int(kv_elems)
        self.pool = pool
        self.registry = prefix_registry
        #: expert-sharded decode pool (parallel/moe serving): > 0 means
        #: the pool's decode workers each HOME a contiguous expert
        #: range and fresh admissions prefer their expert's home rank
        self.experts = int(experts)
        self.manage_recovery = bool(manage_recovery)
        # explicit stage pools (fleet: sized independently); None means
        # the legacy half-split of the worker list
        self._prefill = [int(w) for w in prefill_ranks] \
            if prefill_ranks else None
        self._decode = [int(w) for w in decode_ranks] \
            if decode_ranks else None
        self.scale_watermark = scale_watermark
        self.scale_step = int(scale_step)
        self.scale_patience = int(scale_patience)
        self.scale_cooldown = int(scale_cooldown)
        # more workers than batch slots can never be busy — the default
        # cap keeps a persistent backlog from spawning an idle fleet
        self.scale_max_workers = (int(scale_max_workers)
                                  if scale_max_workers is not None
                                  else self.sched.max_batch)
        self.scale_argv = list(scale_argv) if scale_argv else None
        self._over_watermark = 0
        self._scale_cooling = 0
        #: (prefill rank, decode rank) -> last KV epoch (per PAIRING,
        #: not per pair index: independent pool sizing means one
        #: prefill rank can hold several slab pairings)
        self._pair_epoch: dict = {}
        self._completed: list = []
        # eviction notices: recently finished rids, re-sent with every
        # work dispatch (worker-side pops are idempotent, so repeats
        # are harmless and no notice can be misrouted across a shrink)
        self._recent_done: collections.deque = collections.deque(
            maxlen=64)
        self._lost_and_requeued = 0
        #: worker-reported full-prefill and prefill-skipped counts,
        #: accumulated ROUTER-side (SPC counters are per process; in a
        #: multi-process job only the reports can tell the router what
        #: the prefix cache actually saved — the acceptance's
        #: "prefill-stage count delta" reads these)
        self.prefill_count = 0
        self.prefix_hit_count = 0
        if self.stages and len(self.workers) < 2:
            raise MpiError(ErrorClass.ERR_ARG,
                           "disaggregated serving needs >= 2 workers "
                           "(prefill + decode)")

    # -- worker table ------------------------------------------------------
    def _stage_split(self) -> tuple:
        """(prefill ranks, decode ranks, extra ranks) — decode rank
        ``i`` streams from prefill rank ``i % P`` (P may differ from D:
        the pools are sized independently); ``extra`` (ranks in neither
        explicit pool, or the odd leftover of the legacy half-split)
        serves colocated, so no rank is silently idle.  Colocated mode
        decodes everywhere."""
        if not self.stages:
            return [], list(self.workers), []
        if self._prefill is not None:
            pre = [w for w in self._prefill if w in self.workers]
            dec = [w for w in (self._decode or []) if w in self.workers]
            extra = [w for w in self.workers
                     if w not in pre and w not in dec]
            return pre, dec, extra
        half = len(self.workers) // 2
        return (self.workers[:half], self.workers[half:half * 2],
                self.workers[half * 2:])

    def _prefill_of(self, decode_rank: int, prefill_ranks,
                    decode_ranks) -> int:
        """The prefill rank paired with ``decode_rank`` (static map:
        decode index i -> prefill index i mod P)."""
        return prefill_ranks[decode_ranks.index(decode_rank)
                             % len(prefill_ranks)]

    def _pick_worker(self, decode_ranks) -> int:
        """Least-loaded decode/colocated rank (running-request count)."""
        load = {w: 0 for w in decode_ranks}
        for r in self.sched.running():
            if r.worker in load:
                load[r.worker] += 1
        return min(decode_ranks, key=lambda w: (load[w], w))

    # -- expert-sharded decode pool (parallel/moe serving) -----------------
    def expert_of(self, req) -> int:
        """Deterministic expert for a request: a rolling integer hash
        of the prompt tokens (the request's content decides its hot
        expert, mirroring MoE gating), rid-based when there is no
        prompt.  Pure modular arithmetic — PYTHONHASHSEED-proof, the
        parallel/moe gating discipline."""
        toks = req.prompt or []
        acc = len(toks)
        for t in toks:
            acc = (acc * 8191 + int(t)) % (1 << 30)
        if not toks:
            acc = int(req.rid or 0)
        return acc % self.experts

    def expert_table(self) -> dict:
        """{expert: home worker rank} over the CURRENT decode ranks —
        contiguous ``partition`` slices, the same one-notion-of-
        sharding the MoE trainer uses, so re-binding after a shrink
        re-shards the experts over the survivors automatically."""
        from ompi_tpu_torch.parallel.elastic import partition

        _pre, dec, extra = self._stage_split()
        homes = dec + extra
        table = {}
        if not self.experts or not homes:
            return table
        for i, w in enumerate(homes):
            lo, hi = partition(i, len(homes), self.experts)
            for e in range(lo, hi):
                table[e] = w
        return table

    def _assign(self, req, decode_ranks, extra_ranks,
                prefill_ranks) -> None:
        """Pick the worker for a fresh admission — prefix-cache-aware
        when a registry is configured and the request carries prompt
        tokens: the deepest registered block's holder wins (for a
        stage pool, the decode rank mapped onto the holding PREFILL
        rank), with the ``(hash, generation)`` hint attached for the
        worker to verify; then the request's EXPERT home rank when the
        pool is expert-sharded (cached KV beats expert-weight affinity
        — a hit skips the prefill outright, re-routing an expert costs
        only locality); everything else, least-loaded."""
        candidates = decode_ranks + extra_ranks
        if self.registry is not None and req.prompt:
            if req.hashes is None:
                req.hashes = prefix_cache.block_hashes(req.prompt)
            hit = self.registry.lookup(req.hashes)
            if hit is not None:
                target = None
                if hit.worker in candidates:
                    target = hit.worker
                elif hit.worker in prefill_ranks and decode_ranks:
                    # holder is a prefill rank: route to the least-
                    # loaded decode rank IT streams to
                    fed = [d for d in decode_ranks
                           if self._prefill_of(d, prefill_ranks,
                                               decode_ranks)
                           == hit.worker]
                    if fed:
                        target = self._pick_worker(fed)
                if target is not None:
                    req.worker = target
                    req.hint = (hit.hash, hit.generation, hit.blocks)
                    return
                # holder no longer routable (retired / re-sharded
                # between insert and lookup): drop the stale entries
                self.registry.invalidate_worker(hit.worker)
            spc.record("serve_prefix_misses")
        if self.experts:
            home = self.expert_table().get(self.expert_of(req))
            if home in candidates:
                req.worker = home
                return
        req.worker = self._pick_worker(candidates)

    # -- public API --------------------------------------------------------
    def submit(self, prompt_len: int, max_new_tokens: int,
               rid: Optional[int] = None, tenant: str = "",
               prompt=None, slo: str = "") -> ServeRequest:
        return self.sched.submit(
            ServeRequest(prompt_len, max_new_tokens, rid=rid,
                         tenant=tenant, model=self.pool or "",
                         prompt=prompt, slo=slo))

    def completed(self) -> list:
        return list(self._completed)

    @property
    def lost_and_requeued(self) -> int:
        """Requests returned to the queue by failure recovery (the
        serve-through-failure tests assert these all complete)."""
        return self._lost_and_requeued

    def tick(self) -> None:
        """One engine tick (see module doc).  Any ULFM error inside the
        tick routes through recovery and the tick retries cleanly on
        the shrunken communicator at the next call; a fleet-owned
        router (``manage_recovery=False``) re-raises instead — the
        fleet controller shrinks the SHARED comm exactly once and
        rebinds every pool."""
        try:
            self._tick_inner()
        except (RevokedError, ProcFailedError):
            if not self.manage_recovery:
                raise
            self._recover()

    def serve_until_drained(self, max_ticks: int = 100000,
                            check_invariants: bool = False) -> list:
        """Tick until every submitted request completed (tests/driver);
        returns the completed list."""
        ticks = 0
        while True:
            with_work = (self.sched.depth() or self.sched.running()
                         or None)
            if with_work is None:
                break
            self.tick()
            if check_invariants:
                self.sched.check_invariants()
            ticks += 1
            if ticks >= max_ticks:
                raise MpiError(ErrorClass.ERR_INTERN,
                               f"serving did not drain in {max_ticks} "
                               "ticks (a request starved)")
        return self.completed()

    def shutdown(self) -> None:
        """Tell every worker to exit its serve loop."""
        for w in list(self.workers):
            try:
                self.comm.send_obj(("stop",), w, TAG_CMD)
            except MpiError:
                pass                   # a dead worker needs no stop

    # -- the tick ----------------------------------------------------------
    def _tick_inner(self) -> None:
        if self._failed_workers():
            raise ProcFailedError("worker failure detected", ())
        admitted, _evicted = self.sched.tick()
        prefill_ranks, decode_ranks, extra_ranks = self._stage_split()

        # worker assignment for fresh admissions (decode pairs + any
        # colocated leftover share the load; prefix-cache hits override
        # least-loaded with affinity)
        for req in admitted:
            self._assign(req, decode_ranks, extra_ranks, prefill_ranks)

        running = self.sched.running()
        if not running:
            self._maybe_autoscale()
            return

        # stage round: stream this tick's new KV blocks pairing-wise;
        # a fresh request on an extra (colocated) rank prefills with
        # its work command instead
        fresh = [r for r in running if not r.prefilled]
        paired = [r for r in fresh if r.worker in decode_ranks] \
            if self.stages else []
        if paired:
            per_pair: dict = {}   # (prefill rank, decode rank) -> reqs
            for r in paired:
                pre = self._prefill_of(r.worker, prefill_ranks,
                                       decode_ranks)
                per_pair.setdefault((pre, r.worker), []).append(r)
            for (pre, dec), reqs in sorted(per_pair.items()):
                # epochs are PER PAIRING: each slab pairing counts its
                # own consecutive rounds (a global counter would desync
                # a pairing that sat out a round)
                epoch = self._pair_epoch.get((pre, dec), -1) + 1
                self._pair_epoch[(pre, dec)] = epoch
                if trace.requests_enabled:
                    # otpu-req hop 0 opens at the dispatch decision
                    # (router -> prefill shard; the prefill rank closes
                    # it at command receipt).  The stamp is written
                    # exactly once and _finish's stage decomposition
                    # reuses it — never a second now() for this instant
                    for r in reqs:
                        r.dispatch_ns = trace.now()
                        trace.flow_start("serve_req", (r.rid, 0),
                                         r.dispatch_ns)
                self.comm.send_obj(
                    ("prefill", dec, epoch,
                     [(r.rid, r.slot, r.prompt_len,
                       self._fresh_hashes(r), r.hint) for r in reqs]),
                    pre, TAG_CMD)
                self.comm.send_obj(
                    ("kv", epoch,
                     [(r.rid, r.slot) for r in reqs]),
                    dec, TAG_CMD)
            # prefill acks, then decode-side kv acks — order-free drain
            for (pre, dec) in sorted(per_pair):
                msg = self._expect(pre, "prefilled")
                self._fold_preport(pre, msg[3])
                self._expect(dec, "kv_ready")
                if trace.requests_enabled:
                    # kv_ready means the decode side holds the slab:
                    # the decode window of every request in this
                    # pairing opens here
                    for r in per_pair[(pre, dec)]:
                        r.decode_ns = trace.now()
        # a fresh COLOCATED request prefills with its first work cmd —
        # that cmd carries the prefix hashes + routing hint (paired
        # requests already streamed theirs above)
        fresh_colocated = {r.rid for r in fresh
                           if not (self.stages
                                   and r.worker in decode_ranks)}
        for r in fresh:
            r.prefilled = True         # paired: streamed above;
        #                                colocated: rides the work cmd

        # decode micro-batches: one coalesced cmd per active worker
        per_worker: dict = {}
        for r in running:
            n = min(self.decode_chunk, r.remaining)
            if n > 0:
                first = r.rid in fresh_colocated
                if first and trace.requests_enabled:
                    # colocated hop 0: the work cmd carries the
                    # prefill, and decode starts in the same dispatch —
                    # both stage stamps coincide by construction
                    r.dispatch_ns = r.decode_ns = trace.now()
                    trace.flow_start("serve_req", (r.rid, 0),
                                     r.dispatch_ns)
                entry = (r.rid, r.prompt_len, len(r.tokens), n,
                         self._fresh_hashes(r) if first else (),
                         r.hint if first else None)
                per_worker.setdefault(r.worker, []).append(entry)
            elif r.state is not RequestState.DONE:
                # fully decoded but never marked (e.g. a recovery replay
                # raced completion): retire it instead of starving
                self._finish(r)
        free_rids = list(self._recent_done)
        for w, batch in sorted(per_worker.items()):
            self.comm.send_obj(("work", batch, free_rids), w, TAG_CMD)
        by_rid = {r.rid: r for r in running}
        for w in sorted(per_worker):
            msg = self._expect(w, "res")
            results = msg[1]
            self._fold_preport(w, msg[2])
            for rid, toks in results:
                req = by_rid.get(rid)
                if req is None:
                    continue           # finished during recovery replay
                base = len(req.tokens)
                for i, tok in enumerate(toks):
                    if tok != toy_token(rid, base + i):
                        raise MpiError(
                            ErrorClass.ERR_INTERN,
                            f"rid {rid} token {base + i} corrupted")
                req.tokens.extend(toks)
                if trace.requests_enabled:
                    req.last_res_ns = trace.now()
                if req.remaining <= 0:
                    self._finish(req)
        self._maybe_autoscale()

    def _fresh_hashes(self, req) -> tuple:
        """The prompt's block-hash chain for a first dispatch (the
        worker installs these in its prefix store), () when prefix
        routing is off or the request carries no tokens."""
        if self.registry is None or not req.prompt:
            return ()
        if req.hashes is None:
            req.hashes = prefix_cache.block_hashes(req.prompt)
        return req.hashes

    def _fold_preport(self, worker: int, report) -> None:
        """Fold a worker's prefix report into the routing registry:
        freshly installed blocks become routable at the worker's
        CURRENT generation, evicted blocks are forgotten (idempotent —
        the report rides every reply like the KV eviction notices)."""
        if report is None:
            return
        self.prefill_count += int(report.get("prefills", 0))
        self.prefix_hit_count += int(report.get("hits", 0))
        if self.registry is None:
            return
        gen = int(report.get("gen", 0))
        installed = report.get("installed") or ()
        if installed:
            self.registry.insert(installed, worker, gen)
        evicted = report.get("evicted") or ()
        if evicted:
            self.registry.forget(evicted, worker)

    def _expect(self, worker: int, kind: str):
        """Receive one reply from ``worker`` and check its kind;
        returns the whole message."""
        msg = self.comm.recv_obj(worker, TAG_RES)
        if msg[0] != kind:
            raise MpiError(ErrorClass.ERR_INTERN,
                           f"expected {kind!r} from worker {worker}, "
                           f"got {msg[0]!r}")
        return msg

    def _finish(self, req: ServeRequest) -> None:
        if req.state is RequestState.DONE:
            return                     # a replay must not double-count
        self.sched.mark_done(req)
        self._completed.append(req)
        self._recent_done.append(req.rid)   # KV eviction notice
        # single-stamp discipline: mark_done stamped done_ns — a second
        # now() here would hand the SLO plane a different e2e than the
        # one the stage spans decompose (the otpu-req audit's
        # double-read family)
        dur = (req.done_ns or trace.now()) - req.arrival_ns
        telemetry.slo_observe(self.pool or "", req.tenant, dur / 1e6)
        if frontdoor_mod.enabled:
            # the admission plane watches the SAME signal the SLO
            # accountant and autoscaler read — one escalation ladder
            frontdoor_mod.observe(self.pool or "", req.slo, dur / 1e6)
        if trace.enabled:
            # request latency (arrival -> last token) into the log2
            # histogram the percentile estimator reads; "size" is the
            # token footprint so the bins separate small/large requests.
            # Tenant and pool get their OWN histogram families — their
            # percentile populations never merge (the driver resets
            # each family per run), which is what per-tenant p99
            # reporting and the per-pool autoscaling signal read.
            trace.hist_record(_HIST, req.cost, dur)
            if req.tenant:
                trace.hist_record(TENANT_HIST_PREFIX + req.tenant,
                                  req.cost, dur)
            if self.pool:
                trace.hist_record(POOL_HIST_PREFIX + self.pool,
                                  req.cost, dur)
        if trace.requests_enabled:
            self._trace_request(req)

    def _trace_request(self, req: ServeRequest) -> None:
        """Emit the router-side otpu-req stage spans and close the
        request's flow chain.  Four spans, all from lifecycle stamps
        written exactly once on the hot path (queue: arrival -> admit;
        dispatch: admit -> first cmd out; decode: decode window open ->
        last token result; stream: last result -> done); the worker
        ranks contribute req_prefill / req_kv, and ``otpu_analyze
        --requests`` folds all six into the per-request decomposition.
        A requeued-and-replayed request may lack pre-failure stamps —
        emit what is known, never invent an interval."""
        args = {"rid": req.rid, "tenant": req.tenant,
                "pool": self.pool or "", "worker": req.worker}
        n = 0
        if req.admit_ns is not None:
            trace.span("req_queue", "serve_req", req.arrival_ns,
                       req.admit_ns, args=args)
            n += 1
            if req.dispatch_ns is not None:
                trace.span("req_dispatch", "serve_req", req.admit_ns,
                           req.dispatch_ns, args=args)
                n += 1
        if req.decode_ns is not None and req.last_res_ns is not None:
            trace.span("req_decode", "serve_req", req.decode_ns,
                       req.last_res_ns, args=args)
            trace.span("req_stream", "serve_req", req.last_res_ns,
                       req.done_ns or req.last_res_ns, args=args)
            n += 2
        trace.flow_finish("serve_req", (req.rid, 2), req.done_ns)
        spc.record("req_traced")
        if n:
            spc.record("req_stages", n)

    # -- failure handling --------------------------------------------------
    def _failed_workers(self) -> list:
        from ompi_tpu_torch.ft import state as ft_state

        out = []
        for w in self.workers:
            if ft_state.is_failed(self.comm.group.world_rank(w)):
                out.append(w)
        return out

    def _recover(self) -> None:
        """Serve-through-failure, router side: revoke (unblocks every
        survivor into its own recovery), shrink, re-shard, requeue."""
        try:
            self.comm.revoke()
        except MpiError:
            pass                       # already revoked is fine
        new = self.comm.shrink()
        from ompi_tpu_torch import serving as _pkg

        workers = _pkg.roles(new)[1]
        self.rebind(new, workers)

    def rebind(self, new_comm, workers, prefill_ranks=None,
               decode_ranks=None) -> None:
        """Re-home this router onto a replacement communicator (the
        tail of both recovery paths: standalone after its own shrink,
        or fleet-driven after the controller shrank the SHARED comm
        once and recomputed every pool's table).  Re-shards the worker
        table, invalidates the prefix registry (comm ranks just
        re-numbered — every routed worker id is suspect), and requeues
        EVERY in-flight request: results in transit on the revoked comm
        are gone, and decode is deterministic so a replay from
        tokens_done is bit-identical."""
        new_comm.set_errhandler(ERRORS_RETURN)
        self.comm = new_comm
        from ompi_tpu_torch import serving as _pkg

        self.me = _pkg.roles(new_comm)[0]
        self.workers = [int(w) for w in workers if int(w) != self.me]
        if prefill_ranks or decode_ranks:
            self._prefill = [int(w) for w in prefill_ranks or ()]
            self._decode = [int(w) for w in decode_ranks or ()]
            self.stages = bool(self._prefill and self._decode)
        else:
            self.stages = False        # pairs may have lost a side
            self._prefill = self._decode = None
        self._pair_epoch.clear()
        if self.registry is not None:
            self.registry.invalidate_all()
        running = self.sched.running()
        self._lost_and_requeued += len(running)
        self.sched.requeue(running)

    # -- autoscaling -------------------------------------------------------
    def _maybe_autoscale(self) -> None:
        if self.scale_watermark is None or self.scale_argv is None:
            return
        if getattr(self.comm.rte, "client", None) is None:
            return
        if self._scale_cooling > 0:    # let the last scale-up absorb
            self._scale_cooling -= 1
            return
        if len(self.workers) >= self.scale_max_workers:
            return
        if self.sched.depth() <= self.scale_watermark:
            self._over_watermark = 0
            return
        self._over_watermark += 1
        if self._over_watermark < self.scale_patience:
            return
        self._over_watermark = 0
        self._scale_cooling = self.scale_cooldown
        self._scale_up(self.scale_step)

    def _scale_up(self, n: int) -> None:
        """Spawn ``n`` fresh worker processes and fold them into the
        serving communicator (collective with the current workers)."""
        for w in self.workers:
            self.comm.send_obj(("scale", self.scale_argv, n), w, TAG_CMD)
        inter = self.comm.spawn(self.scale_argv, n, root=self.me)
        client = getattr(self.comm.rte, "client", None)
        job = getattr(inter, "spawn_job", None)
        if client is not None and job is not None:
            # the dynamic pset IS the membership contract: the children
            # we merge with must be exactly the job's published set
            entry = client.pset_get(f"mpi://job/{job}")
            members = sorted(int(m) for m in entry["members"])
            if members != sorted(inter.remote_group.world_ranks):
                raise MpiError(
                    ErrorClass.ERR_SPAWN,
                    f"mpi://job/{job} pset {members} does not match the "
                    "spawned intercomm")
        full = inter.merge(high=False)  # parents first: router keeps rank
        full.set_errhandler(ERRORS_RETURN)
        self.comm = full
        new_ranks = list(range(full.size - n, full.size))
        self.workers = sorted(set(self.workers) | set(new_ranks))
        spc.record("serve_scaleups")
