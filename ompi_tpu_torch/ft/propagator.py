"""Failure propagation and FT event delivery.

Copy of ``ompi_tpu/ft/propagator.py`` (after the reference's
``ompi/communicator/ft/comm_ft_propagator.c`` and
``comm_ft_reliable_bcast.c``): a detected failure reaches every survivor
over TWO carriers:

- the coordination service's event bus (the PMIx-event equivalent ULFM
  also rides, ``ompi_mpi_init.c:400-402``): every process's poller thread,
  on a coordination connection of its own, delivers events into the local
  failure state; and
- a peer-to-peer epidemic flood of CTL fragments over the btls (``ft_prop``;
  the reference's resilient-overlay broadcast in its full-flood form):
  first receipt marks the failure locally and re-floods, so knowledge
  spreads with the coordination service dead.

Revocation (``comm_ft_revoke.c``) rides the same two carriers as
``comm_revoked`` events and ``ft_rev`` frames.  ``wire_suspicion`` turns a
transport's peer reset into a detector report on a thread of its own.  The
``ft`` trace instants are the reference's: ``ft_report_failure`` at a local
report, ``ft_event_delivered`` when the bus delivers a failure.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ompi_tpu_torch.base import output as _output
from ompi_tpu_torch.ft import state as ft_state

_stream = _output.open_stream("ft")

#: Sentinel for ``report_failure(client=...)``: the caller knows the
#: coordination service is dead — skip the event-bus leg entirely rather
#: than block on the shared client's socket timeout (which would stall
#: the detector thread and silence this rank's own heartbeats).
NO_EVENT = object()


def report_failure(rte, world_rank: int, origin: str = "unknown",
                   client=None) -> None:
    """Local detection -> global knowledge: publish + apply locally.

    ``client``: publish over this dedicated coordination connection instead
    of the shared one (the detector passes its own so a blocked shared
    client can't stall the report — or the detector's heartbeat loop).
    Pass :data:`NO_EVENT` when the coordination service is known dead to
    go straight to the p2p flood.
    """
    if ft_state.is_failed(world_rank):
        return
    _output.output(_stream, 1, "rank %d detected failed (via %s)",
                   world_rank, origin)
    from ompi_tpu_torch.runtime import trace

    if trace.enabled:
        trace.instant("ft_report_failure", "ft",
                      args={"rank": world_rank, "origin": origin})
    ft_state.mark_failed(world_rank)
    if client is not NO_EVENT:
        try:
            if client is not None:
                client.event_publish("proc_failed",
                                     {"rank": world_rank, "origin": origin})
            else:
                rte.event_notify("proc_failed",
                                 {"rank": world_rank, "origin": origin})
        except Exception:
            pass  # coordination service gone: the p2p flood still carries it
    _flood_failure(rte, world_rank, origin)


def _flood_failure(rte, world_rank: int, origin: str) -> None:
    """P2p reliable-broadcast leg: push the failure to every live peer as
    a CTL fragment (``comm_ft_reliable_bcast.c``'s role, full-flood)."""
    from ompi_tpu_torch.mca.bml import resolve_bml
    from ompi_tpu_torch.mca.btl.base import CTL, Frag
    from ompi_tpu_torch.runtime import init as rt

    world = rt.get_world_if_initialized()
    if world is None:
        return
    bml = resolve_bml(world.pml)
    if bml is None:
        return
    me = rte.my_world_rank
    meta = {"proto": "ft_prop", "failed": world_rank, "origin": origin}
    for wr in world.group.world_ranks:
        if wr == me or ft_state.is_failed(wr):
            continue
        try:
            ep = bml.endpoint(wr)
            if ep is not None:
                ep.btl.send(ep, Frag(0, me, wr, -1, 0, CTL, meta=meta))
        except Exception:
            pass


def _on_prop_frag(frag) -> None:
    """First receipt applies + re-floods (epidemic; is_failed dedups)."""
    rank = int(frag.meta["failed"])
    if ft_state.is_failed(rank):
        return
    _output.output(_stream, 1, "rank %d failed (p2p flood from %d)",
                   rank, frag.src)
    ft_state.mark_failed(rank)
    from ompi_tpu_torch.runtime import init as rt

    rte = rt.get_rte()
    if rte is not None:
        _flood_failure(rte, rank, frag.meta.get("origin", "p2p"))


def report_revoke(rte, cid: int, epoch: int, job: str = "0") -> None:
    """Dual-carrier revocation, like failures: event bus + p2p flood
    (``comm_ft_revoke.c``'s resilient broadcast — revocation must reach
    members blocked in unrelated operations even with the coordination
    service dead)."""
    ft_state.mark_revoked(cid, epoch, job)
    try:
        rte.event_notify("comm_revoked",
                         {"cid": cid, "epoch": epoch, "job": job})
    except Exception:
        pass
    _flood_revoke(rte, cid, epoch, job)


def _flood_revoke(rte, cid: int, epoch: int, job: str) -> None:
    from ompi_tpu_torch.mca.bml import resolve_bml
    from ompi_tpu_torch.mca.btl.base import CTL, Frag
    from ompi_tpu_torch.runtime import init as rt

    world = rt.get_world_if_initialized()
    if world is None:
        return
    bml = resolve_bml(world.pml)
    if bml is None:
        return
    me = rte.my_world_rank
    meta = {"proto": "ft_rev", "cid": cid, "epoch": epoch, "job": job}
    for wr in world.group.world_ranks:
        if wr == me or ft_state.is_failed(wr):
            continue
        try:
            ep = bml.endpoint(wr)
            if ep is not None:
                ep.btl.send(ep, Frag(0, me, wr, -1, 0, CTL, meta=meta))
        except Exception:
            pass


def _on_rev_frag(frag) -> None:
    """First receipt marks + re-floods (epidemic, like proc failures)."""
    cid = int(frag.meta["cid"])
    epoch = int(frag.meta.get("epoch", 0))
    job = str(frag.meta.get("job", "0"))
    if ft_state.is_comm_revoked(cid, epoch, job):
        return
    _output.output(_stream, 1, "comm cid=%d revoked (p2p flood from %d)",
                   cid, frag.src)
    ft_state.mark_revoked(cid, epoch, job)
    from ompi_tpu_torch.runtime import init as rt

    rte = rt.get_rte()
    if rte is not None:
        _flood_revoke(rte, cid, epoch, job)


class EventPoller:
    """Background consumer of the job event bus (PMIx event thread analog).

    Owns a dedicated coordination connection: event delivery must work even
    while the shared client is parked in a long blocking RPC (revocations
    and failures must reach members "blocked in unrelated operations").
    """

    def __init__(self, rte, interval: float = 0.1) -> None:
        from ompi_tpu_torch.rte.coord import CoordClient

        self.rte = rte
        # retries=0: the poller's fallback carrier is the p2p flood —
        # a dead coord must end the poll loop fast, not stall it
        # through the reconnect backoff ladder
        self.client = CoordClient(retries=0)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="otpu-ft-events", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self.client.close()
        except Exception:
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                events = self.client.event_poll()
            except Exception:
                return  # connection torn down: job is ending
            for _, name, payload in events:
                self._dispatch(name, payload)
            self._stop.wait(self.interval)

    def _dispatch(self, name: str, payload) -> None:
        if name == "proc_failed":
            rank = int(payload["rank"])
            if not ft_state.is_failed(rank):
                _output.output(_stream, 1, "rank %d failed (event from %s)",
                               rank, payload.get("origin"))
                from ompi_tpu_torch.runtime import trace

                if trace.enabled:
                    trace.instant("ft_event_delivered", "ft",
                                  args={"rank": rank,
                                        "origin": payload.get("origin")})
                ft_state.mark_failed(rank)
        elif name == "comm_revoked":
            ft_state.mark_revoked(int(payload["cid"]),
                                  int(payload.get("epoch", 0)),
                                  job=str(payload.get("job", "0")))


_poller: Optional[EventPoller] = None
_detector = None


def wire_suspicion(world_rank: int) -> None:
    """A transport saw a peer reset / unexpected EOF mid-traffic: route
    it into the failure detector as a suspicion instead of letting the
    btl raise (or silently drop) into the application.  No-op when no
    detector is running — the wire alone cannot distinguish a clean
    teardown from a death, so only a job that opted into detection
    (``ft_detector``) treats resets as failure evidence.

    The report runs on its OWN short-lived thread: it publishes over
    the detector's coordination connection, and a hung-but-alive coord
    would otherwise park the btl progress loop (the caller) for a full
    RPC timeout — freezing this rank's transports and heartbeats, and
    turning one wire reset into a cascading false-death."""
    det = _detector
    if det is None:
        return
    threading.Thread(target=det.wire_suspicion,
                     args=(int(world_rank),),
                     name="otpu-ft-wire-suspicion", daemon=True).start()


def start(rte, with_detector: bool = False) -> None:
    """Start the FT runtime (event poller + optional heartbeat ring)."""
    global _poller, _detector
    if _poller is None:
        from ompi_tpu_torch.mca.pml import ob1

        ob1.register_ctl_handler("ft_prop", _on_prop_frag)
        ob1.register_ctl_handler("ft_rev", _on_rev_frag)
        _poller = EventPoller(rte)
        _poller.start()
    if with_detector and _detector is None:
        from ompi_tpu_torch.ft.detector import Detector

        _detector = Detector(rte)
        _detector.start()


def stop() -> None:
    global _poller, _detector
    if _poller is not None:
        _poller.stop()
        _poller = None
    if _detector is not None:
        _detector.stop()
        _detector = None
