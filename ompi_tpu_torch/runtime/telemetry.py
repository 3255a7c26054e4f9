"""otpu-top telemetry plane — the per-rank live sampler.

Copy of ``ompi_tpu/runtime/telemetry.py`` with its imports re-pointed: the
sample schema, the source names and the coord KV key are the reference's.
The port's sources are btl/tcp (``tcp``), the staging pool (``staging``),
the progress engine (``progress``), the profiler (``profile``), the serving
scheduler (``serving``), the front door (``frontdoor``) and the fleet's
control plane (``fleet``, ``serving/fleet.py``).  Serving's router feeds
:class:`SloAccountant` (``slo_observe``) with every completed request.

Every observability surface before this one is post-mortem (otpu-trace
exports at finalize, monitoring dumps at exit) or in-process (SPC/pvar
reads need code running inside the rank).  This module closes the gap:
a flag-guarded sampler thread wakes every ``otpu_telemetry_interval_ms``
(deterministically jittered per rank so N ranks don't stampede the
coord service in phase), snapshots

- the SPC counters (cumulative nonzero values + per-interval deltas),
- the otpu-trace latency histograms through the snapshot/delta API
  (``trace.hist_snapshot`` — the live populations are never reset, so
  percentile pvars and the finalize export keep their full-run view),
- every registered component source (tcp out-queue depth, staging-pool
  occupancy, serving scheduler queue, progress callback count),

and publishes one compact JSON sample per rank into the CoordServer KV
space (key ``otpu_telemetry``) over a dedicated idempotent-retry
``CoordClient`` — the self-healing RPC layer, on its own
connection so a sampler publish can never queue behind (or stall) the
application's shared client.  ``tools/otpu_top.py`` attaches to the
coord service from outside the job and renders the samples live.

**Schema discipline**: every top-level key a sample may carry is
declared in :data:`SCHEMA`; component sources register under one of
those names through :func:`register_source` and the otpu-lint
observability pass statically rejects a literal source name outside the
schema (the SPC ``_COUNTERS`` convention, applied to telemetry keys).

**Cost contract**: ``enabled`` is a module bool, False unless
:func:`start` found a positive interval — with the sampler off no
thread exists, no snapshot is ever taken, and ``register_source`` is
one dict insert at component init (pinned by
``test_perf_guard.test_telemetry_disabled_zero_overhead``).  Enabled,
the whole cost is one snapshot + one KV put per interval; the sampled
hot paths are never touched (pinned sub-interval overhead on the 4KB
allreduce loop by ``test_telemetry_enabled_overhead_bounded``).
"""
from __future__ import annotations

import json
import random
import threading
import time
import weakref
from typing import Any, Callable, Optional

from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime.hotpath import hot_path

#: Declared sample schema: every top-level key a published telemetry
#: sample may carry, with its meaning (``otpu_info --telemetry``
#: enumerates this table; the otpu-lint observability pass enforces
#: that ``register_source`` names come from it).
SCHEMA = {
    "seq": "monotonic per-rank sample number (stale-rank detection)",
    "t": "rank wall-clock at sample time (seconds since epoch)",
    "rank": "world rank that published the sample",
    "interval_ms": "configured sampling interval of this rank",
    "spc": "cumulative nonzero SPC counters (runtime/spc.py)",
    "spc_delta": "SPC counter deltas since the previous sample",
    "hist": "per-collective interval n/sum_us/p50_us/p99_us from the "
            "otpu-trace latency-histogram deltas",
    "progress": "progress-engine registered callback count",
    "tcp": "tcp btl out-queue depth/bytes and live connection count",
    "staging": "staging-pool occupancy: pooled bytes, checkouts, "
               "hits/misses",
    "serving": "continuous-batching scheduler queue/running/done depth",
    "chaos": "injected-fault totals of an armed chaos engine",
    "profile": "otpu-prof host-overhead estimates: interval stage-clock "
               "deltas plus sampling-profiler phase/GIL fractions "
               "(runtime/profile.py)",
    "fleet": "serving-fleet control plane: per-pool worker/queue "
             "tables, prefix-cache hit/miss, reserve size, and recent "
             "autoscale decisions (serving/fleet.py)",
    "slo": "per-pool/per-tenant rolling-window SLO accounting against "
           "otpu_serving_slo_p99_ms: goodput (within-SLO completions "
           "per second), breach counts, and error-budget burn rate "
           "(this module's SloAccountant; otpu-req)",
    "moe": "MoE expert-parallel layer: per-step dispatch/dropped token "
           "totals, expert count and capacity, and the latest per-step "
           "load-imbalance factor (parallel/moe.py)",
    "frontdoor": "serving admission plane: per-class queue depths and "
                 "caps, per-tenant token-bucket levels, shed/preempt "
                 "totals with the last retry-after hint, and the "
                 "interactive-p99 ladder state (serving/frontdoor.py)",
}

#: keys the sampler itself produces; component sources may only claim
#: the remaining schema names
_BUILTIN = ("seq", "t", "rank", "interval_ms", "spc", "spc_delta",
            "hist")

_KV_KEY = "otpu_telemetry"

_interval_var = registry.register(
    "telemetry", None, "interval_ms", vtype=VarType.INT, default=0,
    help="Live-telemetry sampling interval in milliseconds; 0 (the "
         "default) disables the sampler entirely — no thread is "
         "started and the hot paths are never touched.  250 is a "
         "reasonable operational cadence for otpu_top")
_jitter_var = registry.register(
    "telemetry", None, "jitter", vtype=VarType.FLOAT, default=0.2,
    help="Per-rank deterministic jitter fraction applied to each "
         "sampling sleep (rank-seeded, so N ranks spread their coord "
         "KV publishes instead of stampeding in phase)")

#: THE guard: False means no sampler thread exists and nothing below
#: ever runs (the trace/chaos module-bool discipline)
enabled = False
_sampler: Optional["Sampler"] = None

_lock = threading.Lock()
#: name -> provider: a plain callable, or a WeakMethod for bound
#: methods (see register_source)
_sources: dict[str, Any] = {}

#: otpu-lint lock-discipline contract: the source registry is mutated
#: from component init threads and snapshotted by the sampler thread
_GUARDED_BY = {"_sources": "_lock"}


def register_source(name: str, fn: Callable[[], Optional[dict]]) -> None:
    """Register a component stat provider under a :data:`SCHEMA` key.

    ``fn`` is called ONLY by the sampler thread, once per interval; it
    must return a small JSON-serializable dict (or None to skip this
    sample).  Registration is one dict insert — components register
    unconditionally at init and pay nothing while the sampler is off.
    A name outside the declared schema is a loud error (the otpu-lint
    observability pass also rejects it statically).

    Bound methods are held through ``weakref.WeakMethod``: the registry
    must neither keep a torn-down component alive nor publish a dead
    object's frozen stats as live data — when the owner is collected
    the source silently drops out.  (Long-lived components with an
    explicit teardown — the tcp btl, chaos — also
    :func:`unregister_source` there.)"""
    if name not in SCHEMA or name in _BUILTIN:
        from ompi_tpu_torch.base.output import show_help

        show_help("help-telemetry", "bad-source", name=name,
                  allowed=sorted(set(SCHEMA) - set(_BUILTIN)))
        raise ValueError(f"telemetry source {name!r} is not a declared "
                         "SCHEMA key")
    entry: Any = fn
    if hasattr(fn, "__self__"):
        entry = weakref.WeakMethod(fn)
    with _lock:
        _sources[name] = entry


def unregister_source(name: str) -> None:
    with _lock:
        _sources.pop(name, None)


class Sampler:
    """The per-rank sampler thread (see module docstring).

    State written by the sampling loop is thread-confined; ``_stop``
    is the only cross-thread signal."""

    def __init__(self, rank: int, interval_ms: int) -> None:
        self.rank = int(rank)
        self.interval_ms = max(1, int(interval_ms))
        self._seq = 0
        self._last_spc: dict = {}
        self._last_hist: dict = {}
        self._stop = threading.Event()
        self._jitter = random.Random(f"telemetry:{self.rank}")
        self._thread = threading.Thread(
            target=self._run, name="otpu-telemetry", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    @hot_path
    def _sample_once(self) -> dict:
        """Build one schema'd sample dict (no publish, no blocking —
        the allocation-budgeted half the perf pins cover)."""
        from ompi_tpu_torch.runtime import spc, trace

        self._seq += 1
        spc_now = spc.counters()
        spc_delta = {}
        for k, v in spc_now.items():
            d = v - self._last_spc.get(k, 0)
            if d:
                spc_delta[k] = d
        self._last_spc = spc_now
        hist_now = trace.hist_snapshot()
        hist = trace.hist_delta_stats(self._last_hist, hist_now)
        self._last_hist = hist_now
        sample = {
            "seq": self._seq,
            "t": time.time(),
            "rank": self.rank,
            "interval_ms": self.interval_ms,
            "spc": {k: v for k, v in spc_now.items() if v},
            "spc_delta": spc_delta,
            "hist": hist,
        }
        with _lock:
            sources = dict(_sources)
        for name, entry in sources.items():
            fn = entry() if isinstance(entry, weakref.WeakMethod) \
                else entry
            if fn is None:
                # owner collected: drop THIS entry only — a fresh
                # registration under the same name since the snapshot
                # (re-shard built a new scheduler) must survive
                with _lock:
                    if _sources.get(name) is entry:
                        del _sources[name]
                continue
            try:
                val = fn()
            except Exception:
                continue          # a broken source must not kill sampling
            if val is not None:
                sample[name] = val
        return sample

    def _run(self) -> None:
        from ompi_tpu_torch.base.output import show_help
        from ompi_tpu_torch.rte.coord import CoordClient
        from ompi_tpu_torch.runtime import spc

        try:
            client = CoordClient()
        except Exception:
            return                # no coord service: nothing to publish to
        jit = float(_jitter_var.value or 0.0)
        try:
            while not self._stop.is_set():
                sleep_s = (self.interval_ms / 1e3) * (
                    1.0 + jit * (2.0 * self._jitter.random() - 1.0))
                if self._stop.wait(sleep_s):
                    break
                sample = self._sample_once()
                try:
                    client.put(self.rank, _KV_KEY, json.dumps(sample))
                    spc.record("telemetry_samples")
                except Exception:
                    # coord gone mid-job (it already exhausted the
                    # idempotent-retry ladder): stop sampling loudly
                    # once instead of spinning on a dead service
                    show_help("help-telemetry", "publish-failed",
                              rank=self.rank)
                    return
        finally:
            try:
                client.close()
            except Exception:
                pass


# -- SLO accounting (otpu-req) -------------------------------------------

#: error budget of a p99 SLO: 1% of requests may breach the latency
#: target.  Burn rate is the observed breach fraction divided by this
#: allowance — 1.0 means the window consumed its budget exactly, above
#: it the budget is burning down (the SRE burn-rate convention).
SLO_BUDGET = 0.01

_slo_window_var = registry.register(
    "serving", None, "slo_window_s", vtype=VarType.FLOAT, default=60.0,
    help="Rolling window in seconds of the SLO accountant: goodput, "
         "breach counts and error-budget burn rate are computed over "
         "completions no older than this (full-run totals are kept "
         "alongside).  The accountant itself is inert until "
         "otpu_serving_slo_p99_ms sets a latency target")


class SloAccountant:
    """Per-(pool, tenant) rolling-window SLO accounting.

    Fed one ``observe`` per completed serving request by the router's
    finish path; publishes through the ``slo`` SCHEMA key, renders as
    the otpu_top burn column, and rides flight-recorder dumps so a
    crashed fleet leaves its SLO state behind.  Inert — no state, no
    SPC traffic — while ``otpu_serving_slo_p99_ms`` is unset/0: the
    target var is registered by ``serving/fleet.py``, looked up lazily
    so this runtime module never imports the serving package.

    ``observe`` runs on the router's engine-tick thread and
    ``snapshot`` on the sampler thread: both take the accountant's own
    lock for O(window) at worst (amortized O(1): each completion is
    appended once and pruned once)."""

    _GUARDED_BY = {"_win": "_lock", "_totals": "_lock"}

    def __init__(self) -> None:
        import collections

        self._lock = threading.Lock()
        #: (pool, tenant) -> deque[(monotonic_s, ok_bool)]
        self._win: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=65536))
        #: (pool, tenant) -> [total, breaches]  (full-run)
        self._totals: dict = {}
        self._target_var = None

    def target_ms(self) -> float:
        """The live SLO target (0 disables accounting).  The var
        belongs to the serving group (``serving/fleet.py``) — lazy
        registry lookup, cached once found."""
        if self._target_var is None:
            self._target_var = registry.lookup("otpu_serving_slo_p99_ms")
            if self._target_var is None:
                return 0.0
        return float(self._target_var.value or 0.0)

    def observe(self, pool: str, tenant: str, dur_ms: float) -> bool:
        """Account one completed request; returns True when it beat
        the SLO target (always True — and a no-op — with no target)."""
        from ompi_tpu_torch.runtime import spc

        target = self.target_ms()
        if target <= 0:
            return True
        ok = float(dur_ms) <= target
        key = (str(pool), str(tenant or "-"))
        t = time.monotonic()
        with self._lock:
            self._win[key].append((t, ok))
            tot = self._totals.get(key)
            if tot is None:
                tot = self._totals[key] = [0, 0]
            tot[0] += 1
            if not ok:
                tot[1] += 1
        if ok:
            spc.record("slo_goodput")
        else:
            spc.record("slo_breaches")
        return ok

    def snapshot(self) -> Optional[dict]:
        """The ``slo`` sample value: {target_ms, window_s, budget,
        pools: {pool: {tenant: {total, breaches, goodput_rps, burn}}}}
        over the rolling window, with full-run totals alongside.  None
        while nothing was ever accounted (keeps samples compact)."""
        target = self.target_ms()
        window = max(1e-3, float(_slo_window_var.value or 60.0))
        horizon = time.monotonic() - window
        with self._lock:
            if not self._totals:
                return None
            pools: dict = {}
            for (pool, tenant), dq in self._win.items():
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                n = len(dq)
                breaches = sum(1 for _, ok in dq if not ok)
                run_tot, run_breach = self._totals[(pool, tenant)]
                # elapsed covered by the window: bounded by the window
                # itself, but a younger window (the run just started)
                # uses its real span so goodput is not diluted
                span = window
                if dq:
                    span = min(window,
                               max(1e-3, time.monotonic() - dq[0][0]))
                frac = (breaches / n) if n else 0.0
                pools.setdefault(pool, {})[tenant] = {
                    "total": n,
                    "breaches": breaches,
                    "goodput_rps": round((n - breaches) / span, 3),
                    "burn": round(frac / SLO_BUDGET, 3),
                    "run_total": run_tot,
                    "run_breaches": run_breach,
                }
        return {"target_ms": target, "window_s": window,
                "budget": SLO_BUDGET, "pools": pools}

    def reset(self) -> None:
        with self._lock:
            self._win.clear()
            self._totals.clear()
        self._target_var = None


#: the process-wide accountant (router finish path feeds it; the
#: sampler, otpu_top, and the flight recorder read it)
slo = SloAccountant()


def slo_observe(pool: str, tenant: str, dur_ms: float) -> bool:
    """Module-level convenience used by ``serving/router.py``."""
    return slo.observe(pool, tenant, dur_ms)


def slo_snapshot() -> Optional[dict]:
    return slo.snapshot()


def start(rte) -> bool:
    """Arm the sampler for this rank (called from the instance boot).

    No-op — and zero-cost from then on — unless
    ``otpu_telemetry_interval_ms`` is positive and the RTE has a coord
    client to publish through.  Idempotent."""
    global enabled, _sampler
    if _sampler is not None:
        return True
    interval = int(_interval_var.value or 0)
    if interval <= 0 or getattr(rte, "client", None) is None:
        return False
    _sampler = Sampler(int(getattr(rte, "my_world_rank", 0) or 0),
                       interval)
    enabled = True
    _sampler.start()
    return True


def stop() -> None:
    """Disarm (instance teardown / tests); restores the zero-cost
    identity."""
    global enabled, _sampler
    s, _sampler = _sampler, None
    enabled = False
    if s is not None:
        s.stop()


# the accountant is module-owned (never collected), registered like
# any component source: one dict insert, sampled only while the
# sampler runs, skipped (None) until something was accounted
register_source("slo", slo.snapshot)

from ompi_tpu_torch.base.output import register_help as _rh

_rh("help-telemetry", "bad-source",
    "Telemetry source {name!r} is not declared in "
    "runtime/telemetry.py SCHEMA (allowed component keys: {allowed}). "
    "Published sample keys must come from the declared schema so "
    "otpu_top and the analyzer can rely on their meaning.")
_rh("help-telemetry", "publish-failed",
    "Rank {rank}'s telemetry sampler lost the coordination service and "
    "could not re-establish it; live telemetry from this rank stops "
    "here (the job itself is unaffected).")
