"""PERUSE — introspection callbacks on the matching engine's internals.

Copy of ``ompi_tpu/runtime/peruse.py`` (after the reference's
``ompi/peruse/peruse.h`` and the hook sites in ``pml_ob1_recvfrag.c``);
the event names and the order pml/ob1 fires them in are the reference's.
Tools subscribe per-communicator callbacks on named internal events of the
point-to-point engine — request activation,
posted-queue insertion, unexpected-queue insertion, matching in both
directions, transfer completion.  This is the layer BELOW the PMPI
profiling shift: it sees queue behaviour (unexpected-message growth,
match latency) that no wrapper around MPI_Recv can observe.

The hot path stays cheap: every hook site is guarded by a module flag
that is only true while at least one subscription is active, so the
disabled cost is one attribute load + branch.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Optional

# event names (peruse.h PERUSE_COMM_* event set)
REQ_ACTIVATE = "REQ_ACTIVATE"
REQ_INSERT_IN_POSTED_Q = "REQ_INSERT_IN_POSTED_Q"
REQ_MATCH_UNEX = "REQ_MATCH_UNEX"
REQ_XFER_END = "REQ_XFER_END"
REQ_COMPLETE = "REQ_COMPLETE"
MSG_ARRIVED = "MSG_ARRIVED"
MSG_INSERT_IN_UNEX_Q = "MSG_INSERT_IN_UNEX_Q"
MSG_MATCH_POSTED_REQ = "MSG_MATCH_POSTED_REQ"

EVENTS = (REQ_ACTIVATE, REQ_INSERT_IN_POSTED_Q, REQ_MATCH_UNEX,
          REQ_XFER_END, REQ_COMPLETE, MSG_ARRIVED, MSG_INSERT_IN_UNEX_Q,
          MSG_MATCH_POSTED_REQ)

ANY_COMM = -1          # subscribe across all communicators

_active = False        # fast-path guard, mirrored by ob1 hook sites
_lock = threading.Lock()
_subs: dict = {}       # (event, cid) -> {handle: cb}
_ids = itertools.count(1)


class Handle:
    """An activated event subscription (``peruse_event_h`` analog)."""

    def __init__(self, event: str, cid: int, hid: int) -> None:
        self.event = event
        self.cid = cid
        self._hid = hid

    def release(self) -> None:
        unsubscribe(self)


def subscribe(event: str, cb: Callable, comm=None) -> Handle:
    """Register ``cb(event, cid, **info)`` for an event, optionally
    scoped to one communicator (``PERUSE_Event_comm_register`` +
    activate collapsed — the reference's two-step is about object
    lifetime C can't infer)."""
    global _active
    if event not in EVENTS:
        raise ValueError(f"unknown PERUSE event {event!r}")
    cid = ANY_COMM if comm is None else comm.cid
    h = Handle(event, cid, next(_ids))
    with _lock:
        _subs.setdefault((event, cid), {})[h._hid] = cb
        _active = True
    return h


def unsubscribe(handle: Handle) -> None:
    global _active
    with _lock:
        d = _subs.get((handle.event, handle.cid))
        if d:
            d.pop(handle._hid, None)
            if not d:
                _subs.pop((handle.event, handle.cid), None)
        _active = any(_subs.values())


def active() -> bool:
    return _active


def fire(event: str, cid: int, **info) -> None:
    """Deliver an event to matching subscriptions (exact cid + ANY)."""
    if not _active:
        return
    with _lock:
        cbs = list(_subs.get((event, cid), {}).values()) \
            + list(_subs.get((event, ANY_COMM), {}).values())
    for cb in cbs:
        try:
            cb(event, cid, **info)
        except Exception:
            pass  # an introspection callback must never break the engine


def reset() -> None:
    global _active
    with _lock:
        _subs.clear()
        _active = False
