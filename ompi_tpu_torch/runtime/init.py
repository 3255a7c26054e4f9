"""Init/finalize state machine (``ompi/runtime/ompi_mpi_init.c`` flow).

Port of the boot of ``ompi_tpu/runtime/init.py`` and of the instance
layer's (``ompi_tpu/instance/__init__.py:119-135``): apply ``--mca``
arguments, bring up the rte (the device world, or under ``tpurun`` the
multi-process ``ProcRte``), start the SPC counters, select the pml
(``ompi_mpi_init.c:630``), fence the modex (``:682-701``), build COMM_WORLD
(cid 0) and COMM_SELF (cid 1) with the pml attached, build every peer's
endpoint list outside the device world (eager ``add_procs``,
``ompi_mpi_init.c:833``), and run their per-comm coll selection.

The CID space is the reference's bitmap: ``next_local_cid`` is a local
find-and-set (the device world's agreement, one process backs every rank);
the multi-process world agrees on a CID with ``candidate_cid``,
``is_cid_free`` and ``reserve_cid`` (``Comm._next_cid``).  A freed CID
stays set (``retire_cid``: never reused).  ``finalize`` drains the btls'
queued sends, fences the ranks (``fence_final``; the reference fences
first and leaves queued frames to its native reactor's thread), releases
the coll modules of every comm made since
``init``, finalizes the pml and the rte, closes the work pool and the MCA
frameworks and clears the CID space, so the next ``init`` selects afresh.
While a library holds an interlib registration, ``finalize`` returns and
the runtime stays up (``ompi_tpu/runtime/init.py:285-290``).

The first init arms an exit hook (``atexit``, ``init.py:226-229``): a rank
that returns without ``finalize`` still drains its queued sends, fences and
releases its segments on the way out.  ``init_thread`` returns the world
with the provided thread level (always THREAD_MULTIPLE), ``abort``
publishes an ``abort`` event and exits with the code (mpirun's launcher
then ends the job), and ``get_world_if_initialized`` gives COMM_WORLD
without an implicit init.

The observability runtime rides the same boot and teardown as the
reference's instance (``ompi_tpu/instance/__init__.py:64-165``,
``:241-271``): ``coord_connect``, ``modex_fence`` and ``instance_boot``
spans of category ``boot``, ``trace.init``, pml/monitoring's interposition
of the selected pml, the telemetry sampler (when the job has a coordination
client and ``otpu_telemetry_interval_ms`` is positive) and the sampling
profiler (``otpu_profile_interval_ms``).  ``finalize`` exports the trace
and publishes the monitoring matrices while the coordination client is
alive (after the final fence, before the teardown), then stops the
sampler's and the profiler's threads; each step is guarded, so
observability never breaks a teardown, and the exit hook's finalize runs
the same path.

Fault tolerance (``ompi_tpu/runtime/init.py:207-219``, ``:291-292``,
``:328-330``): in the multi-process world, with ``otpu_ft_enable`` (on by
default), init starts ``ft/propagator``'s event poller, and with
``otpu_ft_detector`` (off by default) the heartbeat detector too, each a
daemon thread on a coordination connection of its own (the PMIx
``PROC_ABORTED`` handler of ``ompi_mpi_init.c:400-402``).  ``finalize``
stops both right after the final fence (the detector leaves its clean-exit
tombstone), and the teardown stops them on every other path, the exit
hook's included; ``reset_for_testing`` clears the failure state.
Sessions, hooks and the flight recorder (its arming and its dump at
``abort``) are not ported yet.
"""
from __future__ import annotations

import atexit
import enum
import sys
import threading
import weakref
from typing import Optional

from ompi_tpu_torch.base import mca, var
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
#: live comms made since init (COMM_WORLD included): finalize releases them
_comms: "weakref.WeakSet" = weakref.WeakSet()
_cid_map = Bitmap(64)
_cid_lock = threading.Lock()
_atexit_armed = False


def initialized() -> bool:
    return _state in (State.INIT_STARTED, State.INIT_COMPLETED)


def finalized() -> bool:
    return _state >= State.FINALIZE_STARTED


def get_rte():
    return _rte


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
    with _cid_lock:
        _cid_map.clear_all()


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
    global _state, _world, _self, _rte, _pml, _atexit_armed
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
            from ompi_tpu_torch.runtime import trace

            t_boot = trace.now()
            # the rte's construction is the coordination service's connect
            t0 = trace.now()
            _rte = rte if rte is not None else detect(device)
            trace.span("coord_connect", "boot", t0)
            from ompi_tpu_torch.mca.threads import base as threads_base
            from ompi_tpu_torch.runtime import monitoring, spc

            spc.init()
            trace.init()
            threads_base.reopen_pool()
            # pml selection (ompi_mpi_init.c:630), then the modex fence
            # that publishes its btls' endpoints (:682-701)
            comp = mca.framework(
                "pml", "point-to-point messaging layer").select()
            if comp is None:
                raise RuntimeError("no pml component available")
            # pml/monitoring interposition (per-peer traffic matrices)
            _pml = monitoring.maybe_wrap_pml(comp.get_module(_rte))
            t0 = trace.now()
            _rte.fence()
            trace.span("modex_fence", "boot", t0)
            reserve_cid(0)
            reserve_cid(1)
            _build_world()
            # the ULFM runtime: event poller + optional heartbeat ring
            if not _rte.is_device_world \
                    and getattr(_rte, "client", None) is not None \
                    and _ft_enable.value:
                from ompi_tpu_torch.ft import propagator

                propagator.start(_rte,
                                 with_detector=bool(_ft_detector.value))
        except BaseException:
            _teardown()
            _state = State.NOT_INITIALIZED
            raise
        var.mark_runtime_initialized(True)
        from ompi_tpu_torch.runtime import interlib, profile, telemetry

        interlib.note_main_thread(force=True)
        # the live telemetry sampler needs the coordination client; the
        # sampling profiler needs none (both are no-ops unless their
        # vars arm them)
        if getattr(_rte, "client", None) is not None:
            telemetry.start(_rte)
        profile.start(_rte)
        trace.span("instance_boot", "boot", t_boot)
        _state = State.INIT_COMPLETED
        if not _atexit_armed:
            _atexit_armed = True
            atexit.register(_atexit_finalize)
        return _world


def _build_world() -> None:
    """WORLD/SELF with the pml attached (``ompi_tpu/runtime/init.py:
    159-200``); caller holds ``_lock``."""
    global _world, _self
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.mca.coll.base import comm_select

    _world = Comm(Group(range(_rte.world_size)), cid=0, rte=_rte,
                  name="COMM_WORLD")
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


def _teardown() -> None:
    """Release what init acquired, in the reference's order (pml, rte,
    work pool, frameworks, CID space); every step runs even if one
    before it failed."""
    global _world, _self, _rte, _pml
    try:
        for comm in list(_comms):
            comm.release_coll_modules()
        if _pml is not None:
            _pml.finalize()
        if _rte is not None:
            _rte.finalize()
    finally:
        from ompi_tpu_torch.ft import propagator
        from ompi_tpu_torch.mca.threads import base as threads_base
        from ompi_tpu_torch.runtime import profile, progress, telemetry

        # the FT threads, the sampler's and the profiler's end with the
        # runtime, whichever path tears it down
        propagator.stop()
        telemetry.stop()
        profile.stop()
        threads_base.shutdown_pool(permanent=True)
        mca.close_all()
        progress.reset_for_testing()
        clear_cid_space()
        _comms.clear()
        _world = _self = _rte = _pml = None


def finalize() -> None:
    global _state
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
            # drain the btls' queued sends first: a completed send's frames
            # may still wait for ring space that only the receiver frees,
            # and the fence below blocks this rank's progress (with them
            # queued, the receiver would wait out the fence's timeout).
            # Frames that cannot be delivered fail this rank (after the
            # teardown releases its segments), so the launcher ends the job
            try:
                _pml.bml.flush()
            except BaseException:
                _teardown()
                raise
            # pre-teardown synchronisation (ompi_mpi_finalize's barrier)
            # before any shared segment is released: a fast rank must not
            # unlink rings a slower peer still drains
            fence_final = getattr(_rte, "fence_final", None)
            if fence_final is not None:
                try:
                    fence_final()
                except Exception:
                    pass   # coord gone / timeout: peers are exiting too
            from ompi_tpu_torch.ft import propagator

            propagator.stop()
            _publish_observability()
            _teardown()
        finally:
            var.mark_runtime_initialized(False)
            _state = State.FINALIZE_COMPLETED


def _publish_observability() -> None:
    """The trace export and the monitoring publish, while the coordination
    client is still alive (the clock offset and the KV need it); each is
    guarded: observability must never break a teardown."""
    from ompi_tpu_torch.runtime import monitoring, trace

    try:
        trace.finalize_export(_rte)
    except Exception:
        pass
    try:
        monitoring.finalize_publish(_rte)
    except Exception:
        pass


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
    from ompi_tpu_torch.ft import state as ft_state

    ft_state.reset_for_testing()
    with _lock:
        _state = State.NOT_INITIALIZED


def abort(obj, errorcode: int = 1) -> None:
    """``MPI_Abort``: tear down the job."""
    print(f"[ompi_tpu_torch] MPI_Abort on {obj!r} with code {errorcode}",
          file=sys.stderr, flush=True)
    if _rte is not None:
        _rte.event_notify("abort", {"code": errorcode})
    sys.exit(errorcode)
