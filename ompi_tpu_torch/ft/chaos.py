"""ft/chaos — seeded, deterministic fault injection across the stack.

Copy of ``ompi_tpu/ft/chaos.py``: the same grammar, the same per-site
``random.Random`` streams drawn in the same order, so one spec and one seed
give the identical event log in both packages.

Failure is a first-class, reproducible *input* to the runtime: one
compact spec (``otpu_chaos_spec``) plus one seed (``otpu_chaos_seed``)
drive injection hooks at three layers —

- **btl wire** (tcp + sm): ``drop`` / ``delay`` / ``dup`` / ``corrupt``
  / ``reset`` on the send and recv paths.  Loss faults (drop/dup) are
  restricted to best-effort CTL fragments — the reliable data path has
  no retransmit, so dropping a MATCH frag would model a fault TCP
  itself cannot produce; what TCP *can* produce is delay, duplication
  at the application framing level, silent payload corruption, and
  connection reset, which is exactly the rest of the menu.  ``corrupt``
  and ``reset`` are tcp-only (sm rides host RAM, not a wire); injected
  corruption lands *after* the frame checksum is computed, modelling
  on-the-wire bit rot that the armed checksum then catches loudly.
- **coord client**: ``stall`` (latency before the RPC) and
  ``disconnect`` (socket closed after the request is sent, before the
  reply — the reply is lost and the client's idempotent-retry path must
  heal it against the reconnected socket).
- **process level**: ``kill`` schedules — at a training step
  (``kill:rank=2,step=7``), after a wall-clock delay
  (``kill:rank=0,after=1.2``), or at the Nth hit of a named kill point
  (``kill:rank=1,site=agree_prepare,count=2`` — permit ``count`` hits,
  die on the next).  Kill points are planted in the agreement protocol
  (``agree_prepare``/``agree_decision``), the serving worker's
  micro-batch (``serve_work``, which is also a pacing point for
  ``delay:ms=..,site=serve_work``) and the elastic trainer (``step``).
  ``tpurun --mca otpu_chaos_spec 'kill:rank=2,step=7'`` arms them
  job-wide.

Spec grammar (round-trips through :func:`parse_spec` /
:func:`format_spec`)::

    spec  := rule (';' rule)*
    rule  := fault [':' param (',' param)*]
    param := key '=' value

    drop:p=0.01 ; delay:ms=5,p=0.05 ; kill:rank=2,step=7

Every probabilistic rule draws from a ``random.Random`` stream seeded by
``(seed, rank, hook-site)``, one draw per rule per event in spec order —
the same seed replays the identical fault sequence whatever earlier
rules matched.  ``n=K`` caps a rule at K firings.

Cost contract: ``enabled`` is a module bool, False unless
:func:`install` found a non-empty spec; every hook site sits behind an
``if chaos.enabled`` branch (the trace/sanitizer discipline), pinned by
``tests/test_torch_chaos.py``.  Every injected
fault is SPC-counted and trace-instant'ed, so a chaos run is
self-documenting.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Optional

from ompi_tpu_torch.base.var import VarType, registry

_seed_var = registry.register(
    "chaos", None, "seed", vtype=VarType.INT, default=0,
    help="Seed of the deterministic fault-injection streams (one "
         "random stream per (seed, rank, hook-site); the same seed "
         "replays the identical fault sequence)")
_spec_var = registry.register(
    "chaos", None, "spec", vtype=VarType.STRING, default="",
    help="Fault-injection spec, e.g. "
         "'drop:p=0.01;delay:ms=5,p=0.05;kill:rank=2,step=7' — empty "
         "(the default) disables chaos entirely (zero-cost identity). "
         "Faults: drop/delay/dup/corrupt/reset (btl wire), "
         "stall/disconnect (coord client), kill (process level); "
         "every fault takes an optional rank= scope (e.g. "
         "'delay:ms=5,rank=2' designs one slow rank)")

#: module bool: the ONLY thing a hook site reads when chaos is off
enabled = False
_engine: Optional["_Engine"] = None

#: chaos kills exit with this code, so a launcher log distinguishes an
#: injected death from a real crash
KILL_EXIT_CODE = 7

_WIRE_FAULTS = ("drop", "delay", "dup", "corrupt", "reset")
_COORD_FAULTS = ("stall", "disconnect")
#: every fault takes an optional ``rank=`` scope (the rule only arms on
#: that world rank) — a designed-slow straggler (``delay:ms=5,rank=2``)
#: is what a straggler analysis run injects
_ALLOWED = {
    "drop": {"p", "n", "rank"},
    # a site= delay moves off the wire onto a named pacing point
    # (chaos.pace — the trainer's per-step hook): 'delay:ms=8,rank=2,
    # site=step' designs ONE slow rank arriving late at every
    # collective, the straggler an analysis must localize
    "delay": {"p", "ms", "n", "rank", "site"},
    "dup": {"p", "n", "rank"},
    "corrupt": {"p", "n", "rank"},
    "reset": {"p", "n", "rank"},
    "stall": {"p", "ms", "n", "rank"},
    "disconnect": {"p", "n", "rank"},
    "kill": {"rank", "step", "after", "site", "count"},
}
_PARAM_TYPES = {"p": float, "ms": float, "after": float,
                "rank": int, "step": int, "count": int, "n": int,
                "site": str}
#: SPC counter per fault (names declared in runtime/spc.py _COUNTERS)
_SPC_NAME = {"drop": "chaos_drop", "delay": "chaos_delay",
             "dup": "chaos_dup", "corrupt": "chaos_corrupt",
             "reset": "chaos_reset", "stall": "chaos_stall",
             "disconnect": "chaos_disconnect", "kill": "chaos_kill"}

#: test seam: the process-killing primitive (monkeypatched by the unit
#: tests so kill_point coverage doesn't take pytest down with it)
_exit = os._exit


class ChaosSpecError(ValueError):
    """A malformed ``otpu_chaos_spec`` — always loud, never a silent
    no-fault run the operator believes is injecting."""


def parse_spec(spec: str) -> list:
    """Parse the compact spec grammar into a list of rule dicts
    (``{"fault": name, **typed_params}``), validating fault names and
    per-fault parameter keys."""
    from ompi_tpu_torch.base.output import show_help

    rules = []
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        fault, _, params_s = part.partition(":")
        fault = fault.strip()
        if fault not in _ALLOWED:
            show_help("help-chaos", "bad-spec", rule=part,
                      detail=f"unknown fault {fault!r} (choose from "
                             f"{sorted(_ALLOWED)})")
            raise ChaosSpecError(f"unknown chaos fault {fault!r} in "
                                 f"{part!r}")
        rule = {"fault": fault}
        for tok in params_s.split(","):
            tok = tok.strip()
            if not tok:
                continue
            key, eq, val = tok.partition("=")
            key = key.strip()
            if not eq or key not in _ALLOWED[fault]:
                show_help("help-chaos", "bad-spec", rule=part,
                          detail=f"bad parameter {tok!r} for {fault!r} "
                                 f"(allowed: {sorted(_ALLOWED[fault])})")
                raise ChaosSpecError(f"bad chaos parameter {tok!r} for "
                                     f"fault {fault!r}")
            try:
                rule[key] = _PARAM_TYPES[key](val.strip())
            except ValueError:
                show_help("help-chaos", "bad-spec", rule=part,
                          detail=f"unparsable value in {tok!r}")
                raise ChaosSpecError(f"unparsable chaos value {tok!r}")
        if fault == "kill" and not ({"step", "after", "site"} & set(rule)):
            show_help("help-chaos", "bad-spec", rule=part,
                      detail="kill needs a trigger: step=, after= or "
                             "site=[,count=]")
            raise ChaosSpecError(
                f"kill rule {part!r} has no trigger — it could never "
                "fire, and a silently fault-free chaos run is the one "
                "thing this module must never produce")
        rules.append(rule)
    return rules


def format_spec(rules: list) -> str:
    """Inverse of :func:`parse_spec` (canonical key order)."""
    parts = []
    for rule in rules:
        keys = [k for k in ("rank", "step", "after", "site", "count",
                            "p", "ms", "n") if k in rule]
        params = ",".join(f"{k}={rule[k]:g}" if isinstance(rule[k], float)
                          else f"{k}={rule[k]}" for k in keys)
        parts.append(rule["fault"] + (":" + params if params else ""))
    return ";".join(parts)


class _Engine:
    """The armed injector: spec rules + per-site deterministic streams."""

    def __init__(self, rules: list, seed: int, rank: int) -> None:
        self.seed, self.rank = int(seed), int(rank)
        self.rules = list(rules)

        def mine(r: dict) -> bool:
            # rank-scoped rules arm only on their rank; the draw-stream
            # contract is preserved — a filtered-out rule consumes no
            # draws anywhere, so every rank's sequence stays a pure
            # function of (seed, rank, site, event index)
            return int(r.get("rank", rank)) == rank

        self.wire_rules = [r for r in rules
                           if r["fault"] in _WIRE_FAULTS and mine(r)
                           and not ("site" in r
                                    and r["fault"] == "delay")]
        self.coord_rules = [r for r in rules
                            if r["fault"] in _COORD_FAULTS and mine(r)]
        # site-scoped delays: fire at chaos.pace(site) points, not on
        # the wire
        self.pace_rules = [r for r in rules
                           if r["fault"] == "delay" and "site" in r
                           and mine(r)]
        self.kills = [r for r in rules if r["fault"] == "kill"
                      and int(r.get("rank", rank)) == rank]
        self._lock = threading.Lock()
        self._rng: dict = {}          # site -> random.Random
        self._fired: dict = {}        # id(rule) -> firings (n= caps)
        self._sites: dict = {}        # kill-point site -> permitted hits
        self._timers: list = []

    def _stream(self, site: str) -> random.Random:
        rng = self._rng.get(site)
        if rng is None:
            rng = self._rng[site] = random.Random(
                f"{self.seed}:{self.rank}:{site}")
        return rng

    def match(self, rules: list, site: str,
              applicable=None) -> Optional[dict]:
        """First APPLICABLE rule whose (deterministic) draw fires at
        this event.

        One draw per rule per event in spec order, whatever matched
        before it — the stream consumed per event is fixed, so the
        fault sequence is a pure function of (seed, rank, site, event
        index).  ``applicable`` gates a rule BEFORE its ``n=`` cap is
        consumed: an event a rule cannot touch (a loss fault on
        reliable traffic, a tcp-only fault on sm) must not burn the
        budget of a fault that was never injected."""
        hit = None
        with self._lock:
            rng = self._stream(site)
            for r in rules:
                drew = rng.random() < float(r.get("p", 1.0))
                if not drew or hit is not None:
                    continue
                if applicable is not None and not applicable(r):
                    continue
                cap = r.get("n")
                if cap is not None:
                    k = self._fired.get(id(r), 0)
                    if k >= int(cap):
                        continue
                    self._fired[id(r)] = k + 1
                hit = r
        return hit

    def arm_timers(self) -> None:
        for r in self.kills:
            if "after" in r:
                t = threading.Timer(float(r["after"]), _kill, args=(r,))
                t.daemon = True
                t.start()
                self._timers.append(t)

    def cancel_timers(self) -> None:
        for t in self._timers:
            t.cancel()
        self._timers.clear()

    def kill_hit(self, site: str, n: Optional[int]) -> Optional[dict]:
        """The kill rule fired by this kill-point hit, if any."""
        for r in self.kills:
            if "after" in r:
                continue
            if "step" in r:
                if site == "step" and n is not None \
                        and int(n) == int(r["step"]):
                    return r
            elif r.get("site") == site:
                with self._lock:
                    permitted = self._sites.get(site, 0)
                    if permitted >= int(r.get("count", 0)):
                        return r
                    self._sites[site] = permitted + 1
        return None


#: rolling injected-fault log (wall time, fault, site) — the flight
#: recorder's "what was being injected when we died" tail; appended only
#: when a fault actually fires, so the disabled path never touches it.
#: Guarded: injector threads append while a crash-time snapshot
#: iterates, and a deque mutated mid-iteration raises — which would
#: silently cost the post-mortem dump in exactly the busy-fault runs
#: the recorder exists for.
_log: deque = deque(maxlen=256)
_log_lock = threading.Lock()

_GUARDED_BY = {"_log": "_log_lock"}


def event_log() -> list:
    """Last-N injected faults as ``[t_wall, fault, site]`` rows."""
    with _log_lock:
        return [list(e) for e in _log]


def fault_totals() -> dict:
    """{fault: times injected} — the telemetry sampler's ``chaos``
    source (registered only while an engine is armed).  Read from the
    cumulative SPC counters, NOT the bounded event log: the log is a
    256-entry flight-recorder tail and would undercount a long soak."""
    from ompi_tpu_torch.runtime import spc

    totals: dict = {}
    for fault, counter in _SPC_NAME.items():
        n = spc.read(counter)
        if n:
            totals[fault] = int(n)
    return totals


def _note(fault: str, site: str, extra: Optional[dict] = None) -> None:
    """Every injected fault is SPC-counted, trace-instant'ed, and
    appended to the flight-recorder event log."""
    from ompi_tpu_torch.runtime import spc, trace

    spc.record(_SPC_NAME[fault])
    with _log_lock:
        _log.append((time.time(), fault, site))
    if trace.enabled:
        args = {"site": site}
        if extra:
            args.update(extra)
        trace.instant("chaos_" + fault, "chaos", args=args)


def _kill(rule: dict) -> None:
    import sys

    eng = _engine
    rank = eng.rank if eng is not None else -1
    _note("kill", str(rule.get("site", rule)))
    print(f"[chaos] rank {rank} killed by schedule "
          f"{format_spec([rule])!r}", file=sys.stderr, flush=True)
    try:
        # the flight recorder's last chance: os._exit below skips
        # atexit/finalize, so the post-mortem dump happens HERE
        from ompi_tpu_torch.runtime import flight

        flight.dump("chaos-kill", detail=format_spec([rule]))
    except Exception:
        pass
    _exit(KILL_EXIT_CODE)


# -- hook surface (every caller guards with ``if chaos.enabled``) -------

def wire_send(btl: str, loss_ok: bool) -> Optional[dict]:
    """Consult wire rules for one outbound fragment.  Returns the
    matched rule (its ``fault`` tells the caller what to apply) or
    None.  ``loss_ok`` marks best-effort CTL traffic — the only kind
    drop/dup may touch; ``corrupt``/``reset`` only fire on tcp."""
    return _wire(btl, loss_ok, "send")


def wire_recv(btl: str, loss_ok: bool) -> Optional[dict]:
    """Recv-path twin of :func:`wire_send`.  ``reset`` never fires
    here (inbound resets are the *peer's* send-side fault), and tcp
    passes ``loss_ok=False`` — its frag class is unknown before parse,
    so loss faults live on the send side; sm parses first and offers
    the real class."""
    return _wire(btl, loss_ok, "recv")


def _wire(btl: str, loss_ok: bool, way: str) -> Optional[dict]:
    eng = _engine
    if eng is None or not eng.wire_rules:
        return None

    def applicable(rule: dict) -> bool:
        fault = rule["fault"]
        if fault in ("drop", "dup") and not loss_ok:
            return False     # reliable path has no retransmit
        if fault in ("corrupt", "reset") and btl != "tcp":
            return False     # wire faults; sm is host RAM
        if fault == "reset" and way == "recv":
            return False     # inbound resets are the peer's send fault
        return True

    site = btl + ":" + way
    rule = eng.match(eng.wire_rules, site, applicable)
    if rule is not None:
        _note(rule["fault"], site)
    return rule


def coord_stall(op: str) -> Optional[dict]:
    """Pre-send coord-RPC hook: a matched ``stall`` rule (caller
    sleeps ``ms``)."""
    eng = _engine
    if eng is None or not eng.coord_rules:
        return None
    rule = eng.match([r for r in eng.coord_rules
                      if r["fault"] == "stall"], "coord:stall")
    if rule is not None:
        _note("stall", "coord:" + op)
    return rule


def coord_disconnect(op: str) -> bool:
    """Post-send coord-RPC hook: True = the caller must close its
    socket now (the reply is lost; retry must be duplicate-safe)."""
    eng = _engine
    if eng is None or not eng.coord_rules:
        return False
    rule = eng.match([r for r in eng.coord_rules
                      if r["fault"] == "disconnect"], "coord:disconnect")
    if rule is not None:
        _note("disconnect", "coord:" + op)
        return True
    return False


def pace(site: str) -> None:
    """Named process-level pacing point (the compute-slowness twin of
    :func:`kill_point`): a ``delay`` rule carrying ``site=`` sleeps
    here instead of on the wire.  Planted in the elastic trainer's
    step loop — ``delay:ms=8,rank=2,site=step`` turns rank 2 into a
    designed straggler that arrives late at every collective, the
    scenario a critical-path analysis must localize."""
    eng = _engine
    if eng is None or not eng.pace_rules:
        return
    rule = eng.match([r for r in eng.pace_rules
                      if str(r["site"]) == site], "pace:" + site)
    if rule is not None:
        _note("delay", "pace:" + site)
        sleep_ms(rule)


def kill_point(site: str, n: Optional[int] = None) -> None:
    """Named process-kill site.  ``n`` carries an index for indexed
    schedules (the trainer passes its step number); un-indexed sites
    use the ``count=`` occurrence trigger."""
    eng = _engine
    if eng is None or not eng.kills:
        return
    rule = eng.kill_hit(site, n)
    if rule is not None:
        _kill(rule)


# -- arming --------------------------------------------------------------

def install(rank: Optional[int] = None) -> bool:
    """Arm chaos from the MCA vars (no-op on an empty spec).  Called
    from the RTE boot with the process's world rank; idempotent."""
    global enabled, _engine
    if enabled:
        return True
    spec = str(_spec_var.value or "").strip()
    if not spec:
        return False
    return install_spec(spec, rank=rank,
                        seed=int(_seed_var.value or 0))


def install_spec(spec: str, rank: Optional[int] = None,
                 seed: int = 0) -> bool:
    """Arm chaos from an explicit spec string (tests, per-round fuzz
    schedules).  Replaces any previously armed engine."""
    global enabled, _engine
    rules = parse_spec(spec)
    if rank is None:
        rank = int(os.environ.get("OTPU_RANK", "0") or 0)
    uninstall()
    _engine = _Engine(rules, seed, int(rank))
    enabled = True
    _engine.arm_timers()
    # live fault totals for the telemetry sampler — registered only while
    # armed, so the chaos-off identity (no engine, no sources) stays intact
    from ompi_tpu_torch.runtime import telemetry

    telemetry.register_source("chaos", fault_totals)
    return True


def uninstall() -> None:
    """Disarm (tests; also the per-round fuzz schedule swap)."""
    global enabled, _engine
    enabled = False
    eng, _engine = _engine, None
    if eng is not None:
        eng.cancel_timers()
        from ompi_tpu_torch.runtime import telemetry

        telemetry.unregister_source("chaos")


def sleep_ms(rule: dict, default_ms: float = 1.0) -> None:
    """Apply a delay/stall rule's latency (helper so hook sites don't
    each reimplement the unit conversion)."""
    time.sleep(float(rule.get("ms", default_ms)) / 1e3)


from ompi_tpu_torch.base.output import register_help as _rh

_rh("help-chaos", "bad-spec",
    "otpu_chaos_spec rule {rule!r} is malformed: {detail}.  Grammar: "
    "fault[:key=val[,key=val...]][;fault...], e.g. "
    "'drop:p=0.01;delay:ms=5,p=0.05;kill:rank=2,step=7'.")
