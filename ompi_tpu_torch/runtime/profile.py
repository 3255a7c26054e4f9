"""otpu-prof — per-message stage clocks + the sampling host profiler.

Copy of ``ompi_tpu/runtime/profile.py`` with its imports re-pointed: the
closed :data:`STAGES` table, the snapshot/stats/delta functions and the
export payload are the reference's.  The stage sites in the port: pml/ob1
(send.pack, recv.deliver, recv.complete), btl/sm and btl/tcp (send.queue,
send.wire, recv.parse; both of tcp's receive lanes), the staging pool
(send.staging), coll/tuned (coll.decide, coll.alg) and coll/quant's host
codec (quant.encode, quant.decode).  The sampling profiler's phases come
from the port's ``runtime/hotpath.py`` registry, and the reactor's
``_native_drain`` frame is its native site.  Unlike the reference's, the
profiler thread lets go of each sample's frames before it sleeps (a frame
kept past its return keeps its locals alive, a view of a shared segment
among them, while the teardown unmaps it).

The observability stack can say WHICH rank is slow (otpu-top, the
analyzer's straggler attribution) and WHEN a collective ran (otpu-trace
spans), but not WHERE inside the host datapath a message's latency went:
convertor pack vs staging checkout vs out-queue wait vs the sendmsg
syscall vs receive parse vs delivery.  The native-reactor refactor
(ROADMAP item 2) is accepted against exactly that decomposition — a
per-message host-overhead budget and a GIL-released fraction — so this
module is the measurement substrate it is proven with.

Two halves, both off by default with the trace/telemetry/chaos
module-bool identity discipline:

**Stage clocks** (``otpu_profile_stages``): near-zero-cost monotonic
marks threaded through the host datapath.  Every instrumentation site is
``if profile.enabled:`` guarded; enabled, a site costs one
``perf_counter_ns`` pair plus one locked histogram fold (the
``trace.hist_record`` shape).  Stage names are a CLOSED, declared table
(:data:`STAGES`) — the otpu-lint observability pass statically rejects a
literal stage outside it, and :func:`stage_span` rejects it loudly at
runtime — so ``otpu_analyze`` can decompose any message's latency into
pack/queue/wire/parse/deliver buckets with stable meaning.

**Sampling profiler** (``otpu_profile_interval_ms``): a rank-jittered
thread sampling ``sys._current_frames()``, bucketing each thread's
innermost ``@hot_path``-registered frame into a progress-loop phase
(the ``runtime/hotpath.py`` registry IS the phase table), and estimating

- ``gil_released``: the fraction of thread observations parked at a
  known GIL-dropping wait site (threading/selectors/socket waits, the
  progress engine's ``idle_wait``) — a LOWER bound: a thread caught
  mid-syscall under its own Python frame is not counted;
- ``gil_wait``: the profiler's own scheduling-delay excess (actual vs
  requested sleep) as a fraction of elapsed time — a GIL/scheduler
  contention proxy (the gil_load technique).

Both halves publish through the telemetry ``SCHEMA`` (key
``profile``) so otpu_top shows a live host-overhead column, ride in the
flight recorder's crash dumps, and export at finalize inside the trace
payload's metadata (``chrome_payload`` ``extra_meta``) for
``otpu_analyze``'s per-rank exposed-host report.
"""
from __future__ import annotations

import random
import sys
import threading
import time
from typing import Optional

from ompi_tpu_torch.base.var import VarType, registry

#: Declared stage table — the CLOSED vocabulary of datapath stage
#: clocks.  Keys are ``<path>.<stage>``; ``otpu_info --profile``
#: enumerates this table and the otpu-lint observability pass enforces
#: that every literal ``stage_span``/``stage_mark`` name comes from it.
STAGES = {
    "send.pack": "convertor pack/pack_borrow: user buffer -> wire-shaped "
                 "chunk (O(1) slice on the contiguous borrow path)",
    "send.staging": "staging-pool checkout (device-path host bounce "
                    "buffers, mca/accelerator)",
    "send.queue": "btl send(): header build + out-queue enqueue, wire "
                  "syscall excluded",
    "send.wire": "wire handoff: socket sendmsg / sm ring write",
    "recv.parse": "frame parse: header decode + payload slice out of "
                  "the recv scratch / sm ring frame",
    "recv.deliver": "pml frag delivery: match + unpack into the user "
                    "buffer",
    "recv.complete": "ob1 request completion: status fill + completion "
                     "callbacks",
    "coll.decide": "coll/tuned decision: ladder + rule-file lookup",
    "coll.alg": "coll/tuned algorithm body (schedule execution, wire "
                "waits included)",
    "quant.encode": "coll/quant block-scale encode (wire quantize-on-"
                    "pack, host quant collectives, KV slab write)",
    "quant.decode": "coll/quant block-scale decode (receive-parse "
                    "dequant, dequant-accumulate folds, KV slab read)",
}

#: THE fast-path guard (trace/telemetry/chaos discipline): stage-clock
#: sites read this module bool and branch — nothing else happens while
#: profiling is disabled.
enabled = False

_lock = threading.Lock()
#: stage -> [count, sum_ns, min_ns, max_ns, {log2 dur bin: count}];
#: exact under _lock (enabled path only)
_stages: dict = {}

#: otpu-lint lock-discipline contract: the stage table is folded into
#: from every datapath thread and snapshotted by samplers/exports
_GUARDED_BY = {"_stages": "_lock"}

_profiler: Optional["HostProfiler"] = None

#: monotonic ns of the FIRST arming of either half: the stage
#: histograms accumulate from here to export, so this — not the
#: bounded trace ring's surviving-event window — is the honest
#: denominator for the exposed-host fraction on long runs
_armed_mono_ns: Optional[int] = None


def _note_armed() -> None:
    global _armed_mono_ns
    if _armed_mono_ns is None:
        _armed_mono_ns = time.perf_counter_ns()


def _set_enabled(value: bool) -> None:
    global enabled
    enabled = bool(value)
    if enabled:
        _note_armed()


_stages_var = registry.register(
    "profile", None, "stages", vtype=VarType.BOOL, default=False,
    on_set=_set_enabled,
    help="Arm the per-message stage clocks (pack/queue/wire/parse/"
         "deliver latency histograms through the host datapath); "
         "disabled cost is one flag check per site")
_interval_var = registry.register(
    "profile", None, "interval_ms", vtype=VarType.INT, default=0,
    help="Sampling-profiler interval in milliseconds; 0 (the default) "
         "means no profiler thread exists.  10-50 gives useful phase/"
         "GIL estimates at negligible cost")
_jitter_var = registry.register(
    "profile", None, "jitter", vtype=VarType.FLOAT, default=0.2,
    help="Per-rank deterministic jitter fraction on the sampling sleep "
         "(rank-seeded, so N ranks' samples interleave instead of "
         "phase-locking)")


def now() -> int:
    """Stage-clock begin timestamp (perf_counter_ns).  Call only inside
    an ``if profile.enabled:`` guard — the disabled path must not pay
    for the syscall."""
    return time.perf_counter_ns()


def _check_stage(stage: str) -> None:
    from ompi_tpu_torch.base.output import show_help

    show_help("help-profile", "bad-stage", stage=stage,
              known=", ".join(sorted(STAGES)))
    raise ValueError(f"profile stage {stage!r} is not declared in "
                     "runtime/profile.py STAGES")


def stage_span(stage: str, t0: int, t_end: Optional[int] = None) -> None:
    """Fold one stage occurrence of duration ``now - t0`` into the
    stage's log2 latency histogram.  ``t0 <= 0`` is ignored — a site
    whose begin predates a mid-run enable must not record garbage."""
    if not enabled or not t0:
        return
    if t_end is None:
        t_end = time.perf_counter_ns()
    dur = t_end - t0
    with _lock:
        cell = _stages.get(stage)
        if cell is None:
            if stage not in STAGES:
                _check_stage(stage)
            cell = _stages[stage] = [0, 0, dur, dur, {}]
        cell[0] += 1
        cell[1] += dur
        cell[2] = min(cell[2], dur)
        cell[3] = max(cell[3], dur)
        db = int(dur).bit_length() if dur > 0 else 0
        cell[4][db] = cell[4].get(db, 0) + 1


def stage_mark(stage: str) -> None:
    """Count one occurrence of ``stage`` without a duration (discrete
    datapath events a decomposition normalizes by)."""
    if not enabled:
        return
    with _lock:
        cell = _stages.get(stage)
        if cell is None:
            if stage not in STAGES:
                _check_stage(stage)
            cell = _stages[stage] = [0, 0, 0, 0, {}]
        cell[0] += 1


def stage_snapshot() -> dict:
    """Deep-copied stage state for delta consumers (the telemetry
    source): ``{stage: (count, sum_ns, min_ns, max_ns, {bin: count})}``.
    Pure read — populations are never reset."""
    with _lock:
        return {k: (c[0], c[1], c[2], c[3], dict(c[4]))
                for k, c in _stages.items()}


def stage_stats(snap: Optional[dict] = None) -> dict:
    """Human/JSON stage table: ``{stage: {n, sum_us, mean_us, min_us,
    max_us, p50_us, p99_us}}`` (percentiles interpolated from the log2
    duration bins, THE trace estimator)."""
    from ompi_tpu_torch.runtime.trace import _interp_percentile_ns

    if snap is None:
        snap = stage_snapshot()
    out = {}
    for stage, (n, total, lo, hi, bins) in sorted(snap.items()):
        row = {"n": n, "sum_us": round(total / 1000.0, 1),
               "mean_us": round(total / n / 1000.0, 2) if n else 0.0,
               "min_us": round(lo / 1000.0, 2),
               "max_us": round(hi / 1000.0, 2)}
        if bins:
            row["p50_us"] = round(
                _interp_percentile_ns(bins, 0.5, lo, hi) / 1000.0, 2)
            row["p99_us"] = round(
                _interp_percentile_ns(bins, 0.99, lo, hi) / 1000.0, 2)
        out[stage] = row
    return out


def stage_delta_stats(prev: dict, cur: dict) -> dict:
    """Per-stage interval statistics between two :func:`stage_snapshot`
    results: ``{stage: {n, sum_us}}`` from the count/sum deltas; stages
    with no new occurrences are omitted (compact samples)."""
    out = {}
    for stage, cell in cur.items():
        old = prev.get(stage)
        dn = cell[0] - (old[0] if old else 0)
        if dn <= 0:
            continue
        dsum = cell[1] - (old[1] if old else 0)
        out[stage] = {"n": dn, "sum_us": round(dsum / 1000.0, 1)}
    return out


# -- sampling profiler ---------------------------------------------------

#: wait-primitive filename suffixes whose frames mean "parked with the
#: GIL released" (stdlib wait/IO internals); see gil_released caveat in
#: the module docstring
_BLOCKED_FILES = ("threading.py", "selectors.py", "socket.py",
                  "connection.py", "queue.py", "ssl.py")
_BLOCKED_NAMES = ("idle_wait", "select", "poll", "epoll")

#: native entry points that release the GIL while doing real work —
#: ctypes drops the GIL for the call's duration, so a thread sampled
#: here counts toward gil_released but keeps its hot-path phase (the
#: reactor's drain/pump runs socket drain + framing inside this call;
#: classifying it "idle" would hide the work from phase attribution)
_NATIVE_NAMES = ("_native_drain",)


class HostProfiler:
    """The per-rank sampling thread.  Aggregates are WRITTEN by the
    profiler thread and READ by the telemetry sampler and the flight
    recorder's crash path, so every aggregate update folds in under the
    module ``_lock`` (one uncontended acquire per tick) — a reader
    iterating ``phase_counts`` mid-insert would otherwise raise, and on
    the flight path that exception silently costs the whole dump."""

    def __init__(self, rank: int, interval_ms: int) -> None:
        self.rank = int(rank)
        self.interval_ms = max(1, int(interval_ms))
        self._stop = threading.Event()
        self._jitter = random.Random(f"profile:{self.rank}")
        self._hot_index: Optional[dict] = None
        # aggregates (written under the module _lock by the profiler
        # thread, snapshotted under it by profiler_stats)
        self.samples = 0
        self.phase_counts: dict = {}
        self.blocked_obs = 0
        self.total_obs = 0
        self.gil_wait_ns = 0
        self.elapsed_ns = 0
        self._thread = threading.Thread(
            target=self._run, name="otpu-prof", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _hot(self) -> dict:
        """(module, function-name) -> phase label, from the @hot_path
        registry (built lazily so late-imported components register)."""
        from ompi_tpu_torch.runtime import hotpath

        reg = hotpath.registered()
        if self._hot_index is None or len(self._hot_index) != len(reg):
            idx = {}
            for qual, module in reg.items():
                tail = qual[len(module) + 1:] if qual.startswith(module) \
                    else qual
                idx[(module, tail.rsplit(".", 1)[-1])] = tail
            self._hot_index = idx
        return self._hot_index

    def _classify(self, frame) -> tuple:
        """(phase, blocked) for one thread's stack: innermost @hot_path
        frame names the phase; a top frame inside a stdlib wait
        primitive counts as GIL-released."""
        hot = self._hot()
        top = frame
        fn = top.f_code.co_filename
        if fn.endswith(_BLOCKED_FILES) or \
                top.f_code.co_name in _BLOCKED_NAMES:
            return "idle", True
        released = top.f_code.co_name in _NATIVE_NAMES
        phase = None
        f = frame
        while f is not None:
            key = (f.f_globals.get("__name__", ""), f.f_code.co_name)
            label = hot.get(key)
            if label is not None:
                phase = label
                break
            f = f.f_back
        return phase or ("native" if released else "other"), released

    def _run(self) -> None:
        from ompi_tpu_torch.runtime import spc

        jit = float(_jitter_var.value or 0.0)
        me = self._thread.ident
        t_prev = time.perf_counter_ns()
        while not self._stop.is_set():
            sleep_s = (self.interval_ms / 1e3) * (
                1.0 + jit * (2.0 * self._jitter.random() - 1.0))
            if self._stop.wait(sleep_s):
                break
            t_now = time.perf_counter_ns()
            dt = t_now - t_prev
            t_prev = t_now
            try:
                frames = sys._current_frames()
            except Exception:
                continue
            spc.record("profile_samples")
            # classify into locals first, fold in under the lock (see
            # class docstring)
            phases: dict = {}
            blocked = total = 0
            for tid, frame in frames.items():
                if tid == me:
                    continue
                try:
                    phase, is_blocked = self._classify(frame)
                except Exception:
                    continue   # a torn frame must not kill the profiler
                total += 1
                blocked += int(is_blocked)
                phases[phase] = phases.get(phase, 0) + 1
            # drop the sampled frames before sleeping: a frame held past its
            # function's return keeps that function's locals alive (a view
            # of a shared segment that the runtime's teardown must unmap)
            frames = frame = None
            with _lock:
                self.samples += 1
                # scheduling-delay excess over the requested sleep =
                # the gil_load-style contention proxy
                self.elapsed_ns += dt
                self.gil_wait_ns += max(0, dt - int(sleep_s * 1e9))
                self.total_obs += total
                self.blocked_obs += blocked
                for phase, n in phases.items():
                    self.phase_counts[phase] = \
                        self.phase_counts.get(phase, 0) + n


def profiler_stats() -> Optional[dict]:
    """Aggregate sampling-profiler estimates, or None when no profiler
    ran: ``{samples, phases, gil_released, gil_wait}``.  Snapshotted
    under the module lock against the profiler thread's folds."""
    with _lock:
        p = _profiler
        if p is None or p.samples == 0:
            return None
        return {
            "samples": p.samples,
            "phases": dict(sorted(p.phase_counts.items(),
                                  key=lambda kv: -kv[1])),
            "gil_released": round(p.blocked_obs / max(1, p.total_obs),
                                  3),
            "gil_wait": round(p.gil_wait_ns / max(1, p.elapsed_ns), 3),
        }


def export_payload() -> Optional[dict]:
    """The per-rank profile artifact (trace-payload metadata, flight
    dumps): stage stats + profiler estimates, or None when neither half
    recorded anything."""
    snap = stage_snapshot()
    prof = profiler_stats()
    if not snap and prof is None and not enabled:
        return None
    out: dict = {"stages": stage_stats(snap)}
    if _armed_mono_ns is not None:
        # the wall covered by the accumulated histograms (arm->export):
        # the analyzer's exposed-host denominator, immune to the trace
        # ring overwriting early events on long runs
        out["elapsed_us"] = round(
            (time.perf_counter_ns() - _armed_mono_ns) / 1000.0, 1)
    if prof is not None:
        out["profiler"] = prof
    return out


def start(rte) -> bool:
    """Arm the sampling profiler for this rank (instance boot).  No-op
    unless ``otpu_profile_interval_ms`` is positive.  The stage clocks
    are var-armed independently and need no thread.  Idempotent."""
    global _profiler
    with _lock:
        if _profiler is not None:
            return True
        interval = int(_interval_var.value or 0)
        if interval <= 0:
            return False
        _profiler = HostProfiler(
            int(getattr(rte, "my_world_rank", 0) or 0), interval)
        p = _profiler
    _note_armed()
    p.start()
    return True


def stop() -> None:
    """Stop the sampling profiler and clear the slot (teardown /
    tests), restoring the no-profiler state — a later re-init's
    :func:`start` must arm a FRESH sampler, not early-return against a
    dead thread whose frozen estimates would read as live (the
    telemetry.stop() discipline).  Runs after the teardown's trace
    export / flight postmortem, which carry the final aggregates."""
    global _profiler
    with _lock:
        p, _profiler = _profiler, None
    if p is not None:
        p.stop()


def reset_for_testing() -> None:
    global _armed_mono_ns, enabled
    stop()
    with _lock:
        _stages.clear()
    _armed_mono_ns = None
    enabled = False
    _set_enabled(bool(_stages_var.value))


# -- telemetry source ----------------------------------------------------

_last_tele_snap: dict = {}

#: message-path HOST stages: what otpu_top's host% column sums.  The
#: wire handoff and the coll.* phases are excluded — coll.alg contains
#: the algorithm's wire WAITS by design, so summing it would report
#: >100% of the interval as "host overhead".
_HOST_STAGES = ("send.pack", "send.staging", "send.queue",
                "recv.parse", "recv.deliver", "recv.complete")


def _telemetry_stats() -> Optional[dict]:
    """otpu_top's live host-overhead column (sampler-thread-only
    provider, so the delta state needs no lock of its own): interval
    stage deltas + the profiler's cumulative estimates."""
    global _last_tele_snap
    prof = profiler_stats()
    if not enabled and prof is None:
        return None
    cur = stage_snapshot()
    deltas = stage_delta_stats(_last_tele_snap, cur)
    _last_tele_snap = cur
    out: dict = {
        "host_us": round(sum(d["sum_us"] for s, d in deltas.items()
                             if s in _HOST_STAGES), 1),
        "stages": deltas,
    }
    if prof is not None:
        out["gil_released"] = prof["gil_released"]
        out["gil_wait"] = prof["gil_wait"]
        out["samples"] = prof["samples"]
    return out


from ompi_tpu_torch.runtime import telemetry as _telemetry

_telemetry.register_source("profile", _telemetry_stats)

from ompi_tpu_torch.base.output import register_help as _rh

_rh("help-profile", "bad-stage",
    "Profile stage {stage!r} is not declared in runtime/profile.py "
    "STAGES (known: {known}).  Stage clocks aggregate into a closed, "
    "declared table so otpu_analyze's latency decomposition keeps a "
    "stable meaning — declare the stage there (and in the docs table) "
    "before marking it.")
