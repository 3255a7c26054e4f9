"""Init/finalize state machine (``ompi/runtime/ompi_mpi_init.c`` flow).

Port of ``ompi_tpu/runtime/init.py``: world-model ``init`` acquires the
default instance (``ompi_tpu_torch.instance``, ``init.py:131-160``), whose
boot is shared and refcounted with MPI-4 Sessions: any number of open
sessions plus the world boot the runtime ONCE, and the last release tears
it down.  This module owns what stays world-model specific: COMM_WORLD
(cid 0, the job's ranks) and COMM_SELF (cid 1) with the pml attached, every
peer's endpoint list outside the device world (eager ``add_procs``,
``ompi_mpi_init.c:833``), their per-comm coll selection, the FT threads,
and the CID space.  The world lives on the card unless ``device`` names
another device (``device="cpu"``: the CPU lane the tests run on); with no
card and no explicit device, ``init`` raises.

The CID space is the reference's bitmap: ``next_local_cid`` is a local
find-and-set (the device world's agreement, one process backs every rank);
the multi-process world agrees on a CID with ``candidate_cid``,
``is_cid_free`` and ``reserve_cid`` (``Comm._next_cid``), and dpm's bridge
CIDs come from the coordination service.  A freed CID stays set
(``retire_cid``: never reused); a never-used bridge CID of a failed spawn
goes back (``release_cid``).  ``finalize`` releases the world's reference:
when it is the last, the instance drains the btls' queued sends, fences the
ranks (``fence_final``), exports the trace, releases the coll modules of
every comm still alive, finalizes the pml and the rte, and clears the CID
space; with a session open the runtime stays up and COMM_WORLD is gone.
``init`` after ``finalize`` acquires the instance again (the MPI-4
relaxation).  While a library holds an interlib registration,
``finalize`` returns and the runtime stays up (``init.py:285-290``).

The first init arms an exit hook (``atexit``, ``init.py:226-229``): a rank
that returns without ``finalize`` still drains its queued sends, fences and
releases its segments on the way out.  ``init_thread`` returns the world
with the provided thread level (always THREAD_MULTIPLE), ``abort``
publishes an ``abort`` event and exits with the code (mpirun's launcher
then ends the job), and ``get_world_if_initialized`` gives COMM_WORLD
without an implicit init.

Fault tolerance (``ompi_tpu/runtime/init.py:207-219``, ``:291-292``): in
the multi-process world, with ``otpu_ft_enable`` (on by default), init
starts ``ft/propagator``'s event poller, and with ``otpu_ft_detector`` (off
by default) the heartbeat detector too, each a daemon thread on a
coordination connection of its own (the PMIx ``PROC_ABORTED`` handler of
``ompi_mpi_init.c:400-402``).  ``finalize`` stops both, and the instance's
teardown stops them on every other path; ``reset_for_testing`` clears the
failure state.  ``abort`` writes the flight recorder's ``abort`` dump
before it publishes the event (``init.py:339-343``).  Once the world is
built and the FT threads run, init invokes the hook framework's ``init``
point (``init.py:221-222``; ``mca/hook``, whose ``hook/comm_method`` prints
the transport matrix when ``otpu_hook_comm_method_display`` is set).
"""
from __future__ import annotations

import atexit
import enum
import sys
import threading
import weakref
from typing import Optional

from ompi_tpu_torch.base.containers import Bitmap
from ompi_tpu_torch.base.var import VarType, registry

_ft_enable = registry.register(
    "ft", None, "enable", vtype=VarType.BOOL, default=True,
    help="Start the FT event poller (failure and revocation delivery)")
_ft_detector = registry.register(
    "ft", None, "detector", vtype=VarType.BOOL, default=False,
    help="Start the heartbeat ring failure detector")


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
_pml = None
#: live comms made since the boot (COMM_WORLD included): the instance's
#: teardown releases them
_comms: "weakref.WeakSet" = weakref.WeakSet()
_cid_map = Bitmap(64)
_cid_lock = threading.Lock()
_atexit_armed = False


def initialized() -> bool:
    return _state in (State.INIT_STARTED, State.INIT_COMPLETED)


def finalized() -> bool:
    return _state >= State.FINALIZE_STARTED


def get_rte():
    """The world's rte, else the booted instance's (a sessions-only
    process), else None."""
    if _rte is not None:
        return _rte
    from ompi_tpu_torch import instance as inst_mod

    inst = inst_mod.current()
    return inst.rte if inst is not None else None


def get_world_if_initialized():
    """COMM_WORLD if init completed, else None (no implicit init): for
    services that must not trigger init."""
    return _world if _state is State.INIT_COMPLETED else None


# -- CID space (ompi_tpu/runtime/init.py:61-127) --------------------------

def next_local_cid() -> int:
    """The first free context id, taken (``comm_cid.c``'s find-and-set)."""
    with _cid_lock:
        return _cid_map.find_and_set_first_unset()


def reserve_cid(cid: int) -> None:
    with _cid_lock:
        _cid_map.set(cid)


def candidate_cid(floor: int = 0) -> int:
    """First locally-free CID >= floor, WITHOUT reserving it: a losing
    proposal of the agreement must not punch a hole in the bitmap."""
    with _cid_lock:
        cid = floor
        while _cid_map.is_set(cid):
            cid += 1
        return cid


def is_cid_free(cid: int) -> bool:
    with _cid_lock:
        return not _cid_map.is_set(cid)


def release_cid(cid: int) -> None:
    """Return a NEVER-USED CID to the pool (``ompi_tpu/runtime/init.py:98``:
    dpm's partial-failure path).  Only legal for a cid no communicator was
    ever built on, on any rank; used CIDs go through :func:`retire_cid`."""
    with _cid_lock:
        _cid_map.clear(cid)


def retire_cid(cid: int) -> None:
    """A freed CID is retired, never returned to the pool
    (``ompi_tpu/runtime/init.py:111-119``): reuse would let a stale handle
    or a revoked (cid, epoch) be taken for a new communicator.  The bit
    simply stays set; the function records intent at call sites."""


def clear_cid_space() -> None:
    """Reset the CID bitmap: the instance's last release (the CID space is
    instance-scoped: session-built comms and world comms share it)."""
    with _cid_lock:
        _cid_map.clear_all()


def register_comm(comm) -> None:
    """Record a comm so that the instance's teardown releases its coll
    modules."""
    with _lock:
        _comms.add(comm)


def live_comms() -> list:
    """The comms made since the boot that are still alive."""
    with _lock:
        return list(_comms)


def forget_comms() -> None:
    """Clear the record and the debugger's registry of live comms (the
    instance's teardown)."""
    from ompi_tpu_torch.api.comm import forget_live_comms

    with _lock:
        _comms.clear()
    forget_live_comms()


def init(device=None, rte=None, argv: Optional[list] = None):
    """Initialize the runtime; idempotent (returns COMM_WORLD).

    The world lives on the card unless ``device`` names another device
    (``device="cpu"``: the CPU lane the tests run on).  With no card and no
    explicit device it raises; it never falls back to the CPU.  With a
    session open the instance is already booted and its rte and device
    decide (``device`` is then ignored, as the reference ignores
    ``devices``).
    """
    global _state, _world, _self, _rte, _pml, _atexit_armed
    with _lock:
        if _state is State.INIT_COMPLETED:
            return _world
        if _state is State.FINALIZE_STARTED:
            raise RuntimeError("cannot init while finalize is running")
        # FINALIZE_COMPLETED falls through: MPI-4 allows init, finalize,
        # init (the instance decides whether a real re-boot is needed)
        _state = State.INIT_STARTED
        from ompi_tpu_torch import instance as inst_mod

        try:
            inst = inst_mod.acquire(argv=argv, device=device, rte=rte)
        except BaseException:
            _state = State.NOT_INITIALIZED
            raise
        try:
            _rte, _pml = inst.rte, inst.pml
            _build_world()
            # the ULFM runtime: event poller + optional heartbeat ring
            if not _rte.is_device_world \
                    and getattr(_rte, "client", None) is not None \
                    and _ft_enable.value:
                from ompi_tpu_torch.ft import propagator

                propagator.start(_rte,
                                 with_detector=bool(_ft_detector.value))
            # post-init interposition (hook/comm_method's matrix)
            from ompi_tpu_torch.mca.hook import run_hooks

            run_hooks("init", _world)
        except BaseException:
            # a failed world must not leak the instance reference
            for comm in (_world, _self):
                if comm is not None:
                    comm.release_coll_modules()
            _world = _self = _rte = _pml = None
            _state = State.NOT_INITIALIZED
            inst_mod.release()
            raise
        _state = State.INIT_COMPLETED
        if not _atexit_armed:
            _atexit_armed = True
            atexit.register(_atexit_finalize)
        return _world


def _build_world() -> None:
    """WORLD/SELF with the pml attached (``ompi_tpu/runtime/init.py:
    159-200``); caller holds ``_lock``.  A dpm-spawned job's COMM_WORLD is
    its own rank set (global ranks the coordination service allocated),
    not 0..size-1."""
    global _world, _self
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.mca.coll.base import comm_select

    _world = Comm(Group(getattr(_rte, "job_ranks", range(_rte.world_size))),
                  cid=0, rte=_rte, name="COMM_WORLD")
    _self = Comm(Group([_rte.my_world_rank]), cid=1, rte=_rte,
                 name="COMM_SELF")
    for comm in (_world, _self):
        comm.pml = _pml
        _pml.add_comm(comm)
    # eager add_procs: every peer's endpoint list NOW, while the modex is
    # reachable (BML endpoint lists are an init product)
    if not _rte.is_device_world:
        for wr in _world.group.world_ranks:
            if wr != _rte.my_world_rank:
                _pml.bml.add_proc(wr)
    # per-comm coll selection (ompi_mpi_init.c:956,962)
    for comm in (_world, _self):
        register_comm(comm)
        comm_select(comm)


def comm_world():
    if _world is None:
        init()
    return _world


def comm_self():
    if _self is None:
        init()
    return _self


def init_thread(required: int = 0, device=None, rte=None, argv=None):
    """``MPI_Init_thread``: returns (world, provided).  The engine is
    thread-safe throughout, so provided is always THREAD_MULTIPLE whatever
    level was required."""
    from ompi_tpu_torch.runtime import interlib

    world = init(device=device, rte=rte, argv=argv)
    return world, interlib.query_thread()


def finalize() -> None:
    """Drop the world's instance reference.  The final drain and fence run
    only when this release tears the runtime down: with a session open the
    process and its segments live on, and they run at the last release."""
    global _state, _world, _self, _rte, _pml
    from ompi_tpu_torch import instance as inst_mod
    from ompi_tpu_torch.runtime import interlib

    with _lock:
        if _state is not State.INIT_COMPLETED:
            return
        # the interlib guard, inside the init lock: while another library
        # holds a registration the runtime stays up
        if interlib.registrations() > 0:
            return
        _state = State.FINALIZE_STARTED
        try:
            inst = inst_mod.current()
            if inst is not None and inst_mod.refcount() <= 1:
                try:
                    inst._fence_final()
                except BaseException:
                    # frames that cannot be delivered fail this rank, after
                    # the teardown released its segments
                    inst_mod.release()
                    raise
            from ompi_tpu_torch.ft import propagator

            propagator.stop()
            # the built-in comms the user never frees (the reference
            # destroys WORLD/SELF in ompi_mpi_finalize the same way)
            for comm in (_world, _self):
                if comm is not None and not comm.freed:
                    comm.release_coll_modules()
            inst_mod.release()
        finally:
            _world = _self = _rte = _pml = None
            _state = State.FINALIZE_COMPLETED


def _atexit_finalize() -> None:
    try:
        finalize()
    except Exception:
        pass


def reset_for_testing() -> None:
    """Full teardown allowing re-init (tests only)."""
    global _state
    from ompi_tpu_torch.runtime import interlib

    interlib.reset_for_testing()
    finalize()
    # drain the session references a test may have leaked: the instance
    # must not survive into the next test's boot
    from ompi_tpu_torch import instance as inst_mod

    inst_mod.reset_for_testing()
    from ompi_tpu_torch.ft import state as ft_state

    ft_state.reset_for_testing()
    with _lock:
        _state = State.NOT_INITIALIZED


def abort(obj, errorcode: int = 1) -> None:
    """``MPI_Abort``: tear down the job."""
    print(f"[ompi_tpu_torch] MPI_Abort on {obj!r} with code {errorcode}",
          file=sys.stderr, flush=True)
    try:
        from ompi_tpu_torch.runtime import flight

        flight.dump("abort", detail=f"code {errorcode} on {obj!r}")
    except Exception:
        pass
    if _rte is not None:
        _rte.event_notify("abort", {"code": errorcode})
    sys.exit(errorcode)
