"""Heartbeat failure detector: a ring of observers, peer-to-peer carrier.

Copy of ``ompi_tpu/ft/detector.py`` (after the reference's
``ompi/communicator/ft/comm_ft_detector.c``): each process emits a periodic
heartbeat to one observer arranged in a ring (``:29-33``), period η and
timeout τ tunable (``otpu_ft_detector_period``, ``_timeout``, defaults 3 s
and 10 s; ``_startup_grace`` for a never-seen emitter, ``_jitter`` a
rank-seeded spread of the period).

Carrier: PRIMARY is peer-to-peer: sequence-numbered ``ft_hb`` CTL fragments
pushed over the btls to the observer, so detection keeps working if the
coordination service dies.  The coordination KV carries a secondary copy
(``hb``) for bootstrap, for observers that rotate onto an emitter whose
frames they never received, and for the clean-departure tombstone
(``hb_final``).  The observer checks the p2p table first and falls back to
the KV counter; on a stall past the timeout it reports to the propagator
(trace instant ``ft_detect``) and rotates to the next live predecessor.
The emitter runs on a daemon thread with its own coordination client;
btl/sm serializes its ring producers, so a heartbeat waits on the
application's ring write at most, and a rank blocked in a receive drains
heartbeats from its progress loop.
"""
from __future__ import annotations

import threading
import time

from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.ft import state as ft_state

_period_var = registry.register(
    "ft", None, "detector_period", vtype=VarType.FLOAT, default=3.0,
    help="Heartbeat emission period in seconds (reference eta=3s)")
_timeout_var = registry.register(
    "ft", None, "detector_timeout", vtype=VarType.FLOAT, default=10.0,
    help="Heartbeat staleness timeout in seconds (reference tau=10s)")
_grace_var = registry.register(
    "ft", None, "detector_startup_grace", vtype=VarType.FLOAT, default=10.0,
    help="Extra staleness allowance before a rank whose heartbeat was "
         "NEVER observed is declared failed (the reference arms the "
         "timeout relative to heartbeat activation, not first poll)")
_jitter_var = registry.register(
    "ft", None, "detector_jitter", vtype=VarType.FLOAT, default=0.2,
    help="Deterministic per-rank jitter fraction applied to the "
         "heartbeat period (rank-seeded, +/-20% by default): "
         "desynchronises the ring's emission ticks so one busy node "
         "cannot produce a synchronized false-suspicion storm; 0 "
         "restores lockstep periods")


class Detector:
    """Per-process heartbeat emitter + predecessor observer.

    Uses its OWN coordination-service connection: heartbeat emission must
    not queue behind blocking RPCs (fences, waiting modex gets) on the
    shared client, or a rank stuck in a long-but-legitimate wait would
    starve its own heartbeats and be falsely declared dead.
    """

    def __init__(self, rte) -> None:
        from ompi_tpu_torch.rte.coord import CoordClient

        self.rte = rte
        # retries=0: heartbeats have the p2p carrier as their fallback;
        # a dead coord must flip coord_up, not park the emitter thread
        # in a reconnect backoff (which would silence OUR heartbeats and
        # get this rank falsely declared dead)
        self.client = CoordClient(retries=0)
        # deterministic per-rank period jitter: with N ranks sharing one
        # oversubscribed host, lockstep emission ticks alias against the
        # scheduler quantum and a single busy core can stall EVERY
        # rank's heartbeat in the same window — a synchronized
        # false-suspicion storm.  Seeded by rank: reproducible runs.
        import random as _random

        jf = float(_jitter_var.value or 0.0)
        j = 1.0 + jf * (2.0 * _random.Random(
            f"ft-jitter:{rte.my_world_rank}").random() - 1.0)
        self.period = float(_period_var.value) * j
        self.timeout = float(_timeout_var.value)
        self.startup_grace = float(_grace_var.value)
        self._stop = threading.Event()
        self._seq = 0
        self._departed: set[int] = set()
        # p2p heartbeat state: world rank -> (seq, local monotonic time),
        # written by the CTL handler (btl receive path), read by _run
        self._p2p_lock = threading.Lock()
        self._p2p_seen: dict[int, tuple[int, float]] = {}
        self._p2p_final: set[int] = set()
        self._bml = None
        self._thread = threading.Thread(
            target=self._run, name="otpu-ft-detector", daemon=True)

    def start(self) -> None:
        from ompi_tpu_torch.mca.pml import ob1

        ob1.register_ctl_handler("ft_hb", self._on_hb)
        self._thread.start()

    def stop(self) -> None:
        """Clean shutdown: leave a tombstone so observers see a finalized
        rank as a clean departure, not a failure (ULFM distinguishes
        finalized from failed processes).  The tombstone goes both p2p
        (fast path for the live observer) and to the KV (for observers
        that rotate here later)."""
        self._stop.set()
        try:
            # flood the tombstone to EVERY live peer, not just my current
            # observer: with the coord dead, my emitter must also learn I
            # departed (or it keeps heartbeating a corpse and its observer
            # later declares IT failed when rotation misaligns the ring)
            self._broadcast_p2p({"proto": "ft_hb", "final": True})
        except Exception:
            pass
        try:
            self.client.put(self.rte.my_world_rank, "hb_final", True)
        except Exception:
            pass
        try:
            self.client.close()
        except Exception:
            pass

    # -- p2p carrier -----------------------------------------------------
    def _get_bml(self):
        """The world pml's bml, resolved lazily (transports come up after
        the detector can already be running)."""
        if self._bml is None:
            from ompi_tpu_torch.mca.bml import resolve_bml
            from ompi_tpu_torch.runtime import init as rt

            world = rt.get_world_if_initialized()
            if world is not None:
                self._bml = resolve_bml(getattr(world, "pml", None))
        return self._bml

    def _known_gone(self, r: int) -> bool:
        with self._p2p_lock:
            final = r in self._p2p_final
        return ft_state.is_failed(r) or r in self._departed or final

    def _observer_of_me(self) -> int:
        """The rank observing me: nearest live, non-departed successor."""
        n = self.rte.world_size
        me = self.rte.my_world_rank
        for d in range(1, n):
            r = (me + d) % n
            if not self._known_gone(r):
                return r
        return me

    def _send_frag(self, target: int, meta: dict) -> bool:
        """One CTL heartbeat-frag to ``target`` (shared by the heartbeat
        and tombstone paths so the frag shape can't desynchronise)."""
        from ompi_tpu_torch.mca.btl.base import CTL, Frag

        bml = self._get_bml()
        if bml is None:
            return False
        me = self.rte.my_world_rank
        try:
            ep = bml.endpoint(target)
            if ep is None:
                return False
            ep.btl.send(ep, Frag(0, me, target, -1, 0, CTL, meta=meta))
            return True
        except Exception:
            return False

    def _send_p2p(self, meta: dict) -> bool:
        target = self._observer_of_me()
        if target == self.rte.my_world_rank:
            return True
        return self._send_frag(target, meta)

    def _broadcast_p2p(self, meta: dict) -> None:
        """Tombstone flood: established connections only — shutdown must
        not block connecting to possibly-dead peers."""
        me = self.rte.my_world_rank
        meta = dict(meta, est_only=True)
        for r in range(self.rte.world_size):
            if r != me and not self._known_gone(r):
                self._send_frag(r, meta)

    def wire_suspicion(self, rank: int) -> None:
        """A btl reported peer-reset/EOF on ``rank``'s connection
        mid-traffic (``propagator.wire_suspicion``).  A known clean
        departure (tombstone) or already-failed rank is ignored; an
        unexplained reset is treated as failure evidence and reported —
        the wire IS a heartbeat carrier, and a reset is the loudest
        possible missed heartbeat."""
        me = self.rte.my_world_rank
        if rank == me or self._known_gone(rank):
            return
        from ompi_tpu_torch.ft import propagator
        from ompi_tpu_torch.runtime import trace

        if trace.enabled:
            trace.instant("ft_wire_suspicion", "ft", args={"rank": rank})
        propagator.report_failure(self.rte, rank, origin="wire-reset",
                                  client=self.client)

    def _on_hb(self, frag) -> None:
        """CTL receive path (runs on whatever thread drives progress)."""
        now = time.monotonic()
        with self._p2p_lock:
            if frag.meta.get("final"):
                self._p2p_final.add(frag.src)
            else:
                self._p2p_seen[frag.src] = (frag.meta.get("seq", 0), now)

    # -- internals -------------------------------------------------------
    def _emitter_of(self) -> int:
        """The rank I observe: nearest live, non-departed predecessor."""
        n = self.rte.world_size
        me = self.rte.my_world_rank
        for d in range(1, n):
            r = (me - d) % n
            if not ft_state.is_failed(r) and r not in self._departed:
                return r
        return me

    def _run(self) -> None:
        me = self.rte.my_world_rank
        # target -> (change marker, last-activity time, ever-seen flag)
        last: dict[int, tuple] = {}
        coord_up = True
        while not self._stop.is_set():
            now = time.monotonic()
            # emit my heartbeat on both carriers
            self._seq += 1
            self._send_p2p({"proto": "ft_hb", "seq": self._seq})
            if coord_up:
                try:
                    self.client.put(me, "hb", self._seq)
                except Exception:
                    # coordination service gone: NOT fatal for detection —
                    # the p2p carrier keeps the ring alive (the reference's
                    # detector never depended on the runtime daemon)
                    coord_up = False
            # even with both carriers momentarily down (e.g. coord died
            # before the first p2p send resolved endpoints), keep the
            # ring alive: endpoints are warmed at init and may come back
            # next tick; stop() is the only clean exit
            # observe my current emitter
            target = self._emitter_of()
            if target != me:
                with self._p2p_lock:
                    p2p = self._p2p_seen.get(target)
                    p2p_final = target in self._p2p_final
                kv_seen = None
                if coord_up:
                    try:
                        kv_seen = self.client.get(target, "hb", wait=False)
                    except Exception:
                        coord_up = False
                if p2p_final:
                    self._departed.add(target)
                    last.pop(target, None)
                    self._stop.wait(self.period)
                    continue
                marker = (kv_seen, p2p[0] if p2p else None)
                ever = kv_seen is not None or p2p is not None
                prev = last.get(target)
                if prev is None or marker != prev[0]:
                    last[target] = (marker, now, ever or
                                    (prev[2] if prev else False))
                else:
                    # a never-seen emitter (no heartbeat on either carrier
                    # yet, or a newly rotated-to target) gets timeout +
                    # startup grace: its detector may just be late
                    limit = (self.timeout if prev[2]
                             else self.timeout + self.startup_grace)
                    last_act = max(prev[1], p2p[1] if p2p else 0.0)
                    if now - last_act > limit:
                        finalized = False
                        if coord_up:
                            try:
                                finalized = bool(self.client.get(
                                    target, "hb_final", wait=False))
                            except Exception:
                                coord_up = False
                        if finalized:
                            # clean departure tombstone: rotate past it
                            # without declaring a failure
                            self._departed.add(target)
                        else:
                            from ompi_tpu_torch.ft import propagator
                            from ompi_tpu_torch.runtime import trace

                            if trace.enabled:
                                trace.instant(
                                    "ft_detect", "ft",
                                    args={"rank": target,
                                          "silence_ms":
                                              (now - last_act) * 1e3})
                            propagator.report_failure(
                                self.rte, target, origin="heartbeat",
                                client=(self.client if coord_up
                                        else propagator.NO_EVENT))
                        last.pop(target, None)
            self._stop.wait(self.period)
