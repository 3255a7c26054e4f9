"""Crash-time flight recorder — "why did rank 3 die" without rerunning.

Copy of ``ompi_tpu/runtime/flight.py``: the same triggers, the same payload
keys and the same ``help-flight:<reason>`` vocabulary, so a bundle of either
package reads the same.

Every rank keeps cheap rolling state anyway: the otpu-trace ring, the
coord client's recent-RPC ring, the chaos event log, the SPC counters.
This module turns that state into a post-mortem artifact at the moment
something goes wrong: on MPI_Abort, on an observed peer failure (the
survivor side, dumped at teardown so the recovery spans are in the
ring), on a :class:`~ompi_tpu_torch.runtime.sanitizer.SanitizeError`, on an
uncaught top-level exception, and on a chaos-scheduled kill (which
exits via ``os._exit`` — no atexit would ever run), each rank writes

    <otpu_flight_dir>/rank<r>.json

containing its trace-ring tail, last-N coordination RPCs, chaos event
log, SPC snapshot, known-failed ranks, and a freshly measured clock
offset to the coord server — and best-effort publishes the same payload
into the coord KV (key ``otpu_flight``) over a throwaway short-timeout
client, so the launcher can gather the victim's view even though the
victim's filesystem may be remote.  ``tpurun`` merges every gathered
dump plus the coord service's own event view into one clock-aligned
bundle (``<dir>/bundle.json``).

Dump *reasons* are a closed, ``show_help``-registered vocabulary
(``help-flight:<reason>`` — the dump announcement IS the registered
diagnostic): a dump site whose reason has no registered template is a
bug.

Each process dumps at most once per *death*: the triggers overlap, so
the first reason wins — with one exception.  A ``sanitize`` dump can be
a recoverable event (``SanitizeError`` subclasses ``AssertionError``
and tolerant handlers may swallow it), so a later FATAL trigger
(abort / chaos kill / uncaught exception / the survivor post-mortem)
is allowed to supersede it: the process's actual last state must not
be lost to an earlier handled trip.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from typing import Optional

from ompi_tpu_torch.base.var import VarType, registry

_KV_KEY = "otpu_flight"

_enable_var = registry.register(
    "flight", None, "enable", vtype=VarType.BOOL, default=True,
    help="Arm the crash-time flight recorder (per-rank post-mortem "
         "dump on abort / peer failure / sanitizer error / uncaught "
         "exception / chaos kill); costs nothing until a dump fires")
_dir_var = registry.register(
    "flight", None, "dir", vtype=VarType.STRING, default="otpu-crash",
    help="Directory the per-rank flight-recorder dumps (rank<r>.json) "
         "and the tpurun-gathered bundle.json are written into")
_events_var = registry.register(
    "flight", None, "events", vtype=VarType.INT, default=256,
    help="Trace-ring tail length carried in a flight-recorder dump "
         "(the newest N events of the otpu-trace ring)")

_lock = threading.Lock()
_armed_rte = None
_dumped: Optional[str] = None     # first dump's reason (once per process)
_dump_gen = 0                     # bumped per claimed dump (see dump())
_orig_excepthook = None

#: lock-discipline contract: the once-guard and armed-RTE
#: slot are touched from app threads, the excepthook, and chaos timers
_GUARDED_BY = {"_dumped": "_lock", "_armed_rte": "_lock"}


def flight_dir() -> str:
    return str(_dir_var.value or "otpu-crash")


def _estimate_offset_us(client) -> float:
    """This rank's wall clock minus the coord server's, in us —
    measured NOW, so the dump aligns even if the rank never reached
    finalize.  Delegates to the tracer's estimator: the sign-sensitive
    ``merge_timelines`` convention must live in exactly one place."""
    from ompi_tpu_torch.runtime.trace import _estimate_coord_offset

    return _estimate_coord_offset(client)


def _payload(rank: int, reason: str, detail: str,
             offset_us: float) -> dict:
    from ompi_tpu_torch.ft import chaos, state as ft_state
    from ompi_tpu_torch.runtime import profile, spc, trace

    tail = int(_events_var.value or 256)
    events = trace.chrome_events()[-tail:]
    for ev in events:
        ev["pid"] = rank
    return {
        "rank": rank,
        "reason": reason,
        "detail": detail,
        "t_wall": time.time(),
        "host": socket.gethostname(),
        "pid_os": os.getpid(),
        "clock_offset_us": offset_us,
        "flight_dir": flight_dir(),
        "trace_tail": events,
        "coord_rpcs": _recent_rpcs(),
        "chaos_events": chaos.event_log(),
        "spc": {k: v for k, v in spc.counters().items() if v},
        "failed_ranks": sorted(ft_state.failed_ranks()),
        # the profiler's last stage-histogram snapshot + phase-sample
        # counts: the post-crash bundle shows where host time was going
        # (None when neither profile half was armed)
        "profile": profile.export_payload(),
        # the SLO state: a crashed fleet leaves its rolling-window
        # goodput/breach/burn accounting behind (None off the router
        # rank or while no SLO target was ever set)
        "slo": _slo_state(),
    }


def _slo_state() -> Optional[dict]:
    try:
        from ompi_tpu_torch.runtime import telemetry

        return telemetry.slo_snapshot()
    except Exception:
        return None


def _recent_rpcs() -> list:
    with _lock:
        rte = _armed_rte
    client = getattr(rte, "client", None)
    if client is None:
        return []
    try:
        return client.recent_rpcs()
    except Exception:
        return []


#: reasons that mean the process (or a peer) actually died — these may
#: supersede an earlier RECOVERABLE dump (see module docstring)
_FATAL = ("abort", "chaos-kill", "uncaught", "proc-failed")


def dump(reason: str, detail: str = "") -> Optional[str]:
    """Write (and best-effort publish) this rank's post-mortem dump.

    Returns the dump path, or None when the recorder is disarmed /
    disabled / already fired (a fatal reason may supersede an earlier
    ``sanitize`` dump — a handled sanitizer trip must not leave the
    real crash later undumped).  Never raises — a recorder must not
    turn one failure into two."""
    global _dumped, _dump_gen
    with _lock:
        rte = _armed_rte
        allowed = (_dumped is None
                   or (_dumped == "sanitize" and reason in _FATAL))
        if rte is None or not bool(_enable_var.value) or not allowed:
            return None
        _dumped = reason
        _dump_gen += 1
        gen = _dump_gen
    try:
        return _dump_armed(rte, reason, detail, gen)
    except Exception:
        return None


def _superseded(gen: int) -> bool:
    """True when a newer dump claimed the slot while this one was still
    gathering: the async sanitize thread spends seconds measuring a
    clock offset, and a fatal dump completing in that window must not
    be overwritten by the stale one's file/KV writes."""
    with _lock:
        return _dump_gen != gen


def _dump_armed(rte, reason: str, detail: str, gen: int) -> Optional[str]:
    from ompi_tpu_torch.base.output import show_help
    from ompi_tpu_torch.runtime import spc

    rank = int(getattr(rte, "my_world_rank", 0) or 0)
    # throwaway short-timeout client: the shared client's lock may be
    # held by the very operation that is crashing, and a kill path must
    # not hang behind it (or behind a dead coord's full RPC timeout)
    client = None
    offset_us = 0.0
    try:
        from ompi_tpu_torch.rte.coord import CoordClient

        client = CoordClient(timeout=2.0, retries=0)
        offset_us = _estimate_offset_us(client)
    except Exception:
        client = None
    payload = _payload(rank, reason, detail, offset_us)
    encoded = json.dumps(payload)
    path = None
    if _superseded(gen):          # re-check after the slow gather
        if client is not None:
            try:
                client.close()
            except Exception:
                pass
        return None
    try:
        os.makedirs(flight_dir(), exist_ok=True)
        path = os.path.join(flight_dir(), f"rank{rank}.json")
        with open(path, "w") as f:
            f.write(encoded)
    except OSError:
        path = None               # unwritable dir: the KV leg may still land
    if client is not None:
        try:
            if not _superseded(gen):
                client.put(rank, _KV_KEY, encoded)
        except Exception:
            pass
        try:
            client.close()
        except Exception:
            pass
    spc.record("flight_dumps")
    show_help("help-flight", reason, rank=rank,
              path=path or "<unwritable>", detail=detail or "-")
    return path


def maybe_dump_postmortem(rte) -> Optional[str]:
    """Survivor-side trigger, called at instance teardown: when this
    process observed peer failures during the job, its ring now holds
    the whole recovery (revoke/shrink/respawn spans) — dump it."""
    from ompi_tpu_torch.ft import state as ft_state

    failed = sorted(ft_state.failed_ranks())
    if not failed:
        return None
    return dump("proc-failed", detail=",".join(str(r) for r in failed))


def _excepthook(tp, val, tb):
    try:
        # classify by the failure already observed: when this process
        # saw peers die, the exception unwinding it now is almost
        # always secondary fallout of that death (the documented
        # fleet-soak flake: a survivor's recovery-path coord RPC times
        # out and the dump said 'uncaught' instead of 'proc-failed').
        # The failed-set wins; the exception rides along as detail.
        failed = []
        try:
            from ompi_tpu_torch.ft import state as ft_state

            failed = sorted(ft_state.failed_ranks())
        except Exception:
            pass
        if failed:
            dump("proc-failed",
                 detail=",".join(str(r) for r in failed)
                 + f" (then {val!r})")
        else:
            dump("uncaught", detail=repr(val))
    except Exception:
        pass
    hook = _orig_excepthook or sys.__excepthook__
    hook(tp, val, tb)


def arm(rte) -> None:
    """Arm the recorder for this process (instance boot): remember the
    RTE and chain the uncaught-exception hook.  Idempotent."""
    global _armed_rte, _orig_excepthook
    with _lock:
        if _armed_rte is not None:
            _armed_rte = rte      # re-boot: track the live RTE
            return
        _armed_rte = rte
    _orig_excepthook = sys.excepthook
    sys.excepthook = _excepthook


def disarm() -> None:
    """Disarm and restore the exception hook (teardown / tests).  The
    once-guard survives disarm within a process run; tests reset it via
    :func:`reset_for_testing`."""
    global _armed_rte, _orig_excepthook
    with _lock:
        _armed_rte = None
    if _orig_excepthook is not None:
        sys.excepthook = _orig_excepthook
        _orig_excepthook = None


def reset_for_testing() -> None:
    global _dumped
    disarm()
    with _lock:
        _dumped = None


from ompi_tpu_torch.base.output import register_help as _rh

_rh("help-flight", "abort",
    "Rank {rank} called MPI_Abort ({detail}); flight-recorder dump "
    "written to {path} (trace tail, recent coord RPCs, chaos log, SPC "
    "snapshot).")
_rh("help-flight", "proc-failed",
    "Rank {rank} observed peer failure(s) [{detail}] during this job; "
    "survivor flight-recorder dump written to {path} — it carries the "
    "detection and recovery timeline.")
_rh("help-flight", "sanitize",
    "Rank {rank} tripped a sanitizer invariant ({detail}); "
    "flight-recorder dump written to {path}.")
_rh("help-flight", "uncaught",
    "Rank {rank} is dying on an uncaught exception ({detail}); "
    "flight-recorder dump written to {path}.")
_rh("help-flight", "chaos-kill",
    "Rank {rank} is being killed by its chaos schedule ({detail}); "
    "flight-recorder dump written to {path} before os._exit.")
