"""Init/finalize state machine (``ompi/runtime/ompi_mpi_init.c`` flow).

Port of the device-world boot of ``ompi_tpu/runtime/init.py``: apply
``--mca`` arguments, bring up the device world (N virtual ranks on one
device), build COMM_WORLD (cid 0) and COMM_SELF (cid 1, the conductor's
rank alone) and run their per-comm coll selection.  Context ids of the
comms made afterwards (``dup``, ``split``, ``create``, ...) come from
``next_local_cid``: in the device world one process backs every rank, so a
local find-and-set is the agreement.  The reference keeps a bitmap of CIDs
in which a freed CID stays set (``retire_cid``: never reused) and only
multi-process agreements punch holes; in the device world its
find-and-set therefore hands out 2, 3, 4, ... in order, which is what the
port's counter does.  ``finalize`` releases the coll modules of every comm
made since ``init``, drops the world and resets the CID space, and closes
the MCA frameworks, so the next ``init`` selects afresh.  Sessions, hooks,
fault tolerance and monitoring are not ported yet.
"""
from __future__ import annotations

import enum
import threading
import weakref
from typing import Optional

from ompi_tpu_torch.base import mca, var


class State(enum.IntEnum):
    NOT_INITIALIZED = 0
    INIT_STARTED = 1
    INIT_COMPLETED = 2
    FINALIZE_STARTED = 3
    FINALIZE_COMPLETED = 4


_lock = threading.RLock()
_state = State.NOT_INITIALIZED
_world = None
_self = None
_rte = None
#: live comms made since init (COMM_WORLD included): finalize releases them
_comms: "weakref.WeakSet" = weakref.WeakSet()
_FIRST_FREE_CID = 2     # cid 0 is COMM_WORLD, cid 1 COMM_SELF
_next_cid = _FIRST_FREE_CID


def initialized() -> bool:
    return _state in (State.INIT_STARTED, State.INIT_COMPLETED)


def finalized() -> bool:
    return _state >= State.FINALIZE_STARTED


def get_rte():
    return _rte


def next_local_cid() -> int:
    """The next free context id (``comm_cid.c``'s find-and-set, local)."""
    global _next_cid
    with _lock:
        cid = _next_cid
        _next_cid += 1
        return cid


def retire_cid(cid: int) -> None:
    """A freed CID is retired, never returned to the pool
    (``ompi_tpu/runtime/init.py:111-119``): reuse would let a stale handle
    or a revoked (cid, epoch) be taken for a new communicator.  The counter
    never hands a CID out twice, so retiring records intent only."""


def register_comm(comm) -> None:
    """Record a comm so that finalize releases its coll modules."""
    with _lock:
        _comms.add(comm)


def init(device=None, rte=None, argv: Optional[list] = None):
    """Initialize the runtime; idempotent (returns COMM_WORLD).

    The world lives on the card unless ``device`` names another device
    (``device="cpu"``: the CPU lane the tests run on).  With no card and no
    explicit device it raises; it never falls back to the CPU.
    """
    global _state, _world, _self, _rte
    with _lock:
        if _state is State.INIT_COMPLETED:
            return _world
        if _state is State.FINALIZE_STARTED:
            raise RuntimeError("cannot init while finalize is running")
        _state = State.INIT_STARTED
        try:
            # (re)apply --mca arguments and OTPU_MCA_* environment values to
            # every registered var: each init reads the settings anew
            var.registry.parse_cli(list(argv or ()))
            from ompi_tpu_torch.rte.base import detect

            _rte = rte if rte is not None else detect(device)
            from ompi_tpu_torch.api.comm import Comm
            from ompi_tpu_torch.api.group import Group

            _world = Comm(Group(range(_rte.world_size)), cid=0, rte=_rte,
                          name="COMM_WORLD")
            _self = Comm(Group([_rte.my_world_rank]), cid=1, rte=_rte,
                         name="COMM_SELF")
            # per-comm coll selection (ompi_mpi_init.c:956,962)
            from ompi_tpu_torch.mca.coll.base import comm_select

            for comm in (_world, _self):
                register_comm(comm)
                comm_select(comm)
        except BaseException:
            _world = _self = _rte = None
            _state = State.NOT_INITIALIZED
            raise
        var.mark_runtime_initialized(True)
        _state = State.INIT_COMPLETED
        return _world


def comm_world():
    if _world is None:
        init()
    return _world


def comm_self():
    if _self is None:
        init()
    return _self


def finalize() -> None:
    global _state, _world, _self, _rte, _next_cid
    with _lock:
        if _state is not State.INIT_COMPLETED:
            return
        _state = State.FINALIZE_STARTED
        try:
            for comm in list(_comms):
                comm.release_coll_modules()
            if _rte is not None:
                _rte.finalize()
            mca.close_all()
        finally:
            _comms.clear()
            _next_cid = _FIRST_FREE_CID
            _world = _self = _rte = None
            var.mark_runtime_initialized(False)
            _state = State.FINALIZE_COMPLETED


def reset_for_testing() -> None:
    """Full teardown allowing re-init (tests only)."""
    global _state
    finalize()
    with _lock:
        _state = State.NOT_INITIALIZED
