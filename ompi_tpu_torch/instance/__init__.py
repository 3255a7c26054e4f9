"""ompi_tpu_torch.instance — the runtime instance behind MPI-4 Sessions.

Port of ``ompi_tpu/instance/__init__.py`` (after ``ompi/instance/
instance.c``): ``Session.init`` and world-model ``init`` both acquire the
one process-wide instance, a refcount tracks its owners (open sessions and
the implicit world), and only the LAST release tears the runtime down
(``ompi_mpi_instance_init``/``_finalize`` with ``instance_lock`` and
``ompi_instance_count``).  So:

* any number of sessions and the world share ONE boot (one rte, one modex
  fence, one pml selection): acquiring a booted instance is a refcount
  bump;
* ``init`` after ``finalize`` works: at refcount zero the boot returns to
  ground and the next acquire boots afresh;
* CIDs 0 and 1 are reserved at boot for COMM_WORLD and COMM_SELF, whether
  the world model ever initializes or not, and the CID space is cleared at
  the last release (session-built comms and the world's share it);
* process sets exist before any communicator: the builtins
  ``mpi://WORLD`` and ``mpi://SELF`` plus whatever the coordination
  service advertises (``tpurun``'s per-node and ``--pset`` sets, and the
  dynamic sets of spawn, failure and shrink).

The boot (``:64-165``): the ``--mca`` arguments, the rte (the device world,
on the card unless the caller names another device, or under ``tpurun`` the
multi-process ``ProcRte``) inside a ``coord_connect`` span, the SPC
counters, ``trace.init``, the work pool, the main-thread anchor, pml
selection with pml/monitoring's and vprotocol's interpositions, the modex
fence inside a ``modex_fence`` span, the reserved CIDs, the flight
recorder's arming (``flight.arm``, with a coordination client), the
telemetry sampler and the sampling profiler, all inside an
``instance_boot`` span of category
``boot``.  Before pml selection come the ``--bind-to core`` binding
and the ``cpus`` modex (``:99-111``, ``base/hwloc.py``), then the
multi-process device world inside a ``jax_distributed_init`` span, the
reference's name, recorded on every boot as the reference records it
(``:113-117``, ``:167-219``).  The device world boots only under
``OTPU_DEVICE_WORLD=1`` (``tpurun --device-world``) in the primary job: the
rendezvous address is ``OTPU_DIST_COORD`` when set, else the coordination
service's ``DIST_COORD_KEY`` (the launcher publishes it; a 30 s wait, then
a loud error), and every rank joins ``torch.distributed``'s gloo group
(``init_process_group("gloo", init_method="tcp://...")``, world size the
job's rank count, rank its job-local index, an explicit timeout of
``DEVICE_WORLD_TIMEOUT``).  NCCL would refuse two ranks on one
card.  A later boot in the same process reuses the live group, as the
reference reuses a live ``jax.distributed`` client (``:211-214``); the
group is destroyed only when the process exits.  The teardown
(``:221-313``) is one-shot: the final fence (the port first drains the
btls' queued sends, and frames that cannot be delivered fail the rank
after the teardown), the trace export, the flight recorder's survivor
post-mortem (``maybe_dump_postmortem``: a job that saw peer failures dumps
its recovery) and the monitoring publish while the coordination client
lives, the coll modules of every comm still alive,
the pml and the rte, then the ground state (threads, pool, frameworks,
progress, CID space, the flight recorder disarmed) whatever failed
before.
"""
from __future__ import annotations

import atexit
import datetime
import os
import threading
from typing import Optional

from ompi_tpu_torch.base import mca
from ompi_tpu_torch.base.var import mark_runtime_initialized, registry

#: MPI-4 builtin process-set names (MPI 4.0 §11.3.2)
PSET_WORLD = "mpi://WORLD"
PSET_SELF = "mpi://SELF"

_lock = threading.RLock()
_refcount = 0
_instance: Optional["Instance"] = None
_atexit_armed = False

#: how long the device world's process group waits for its rendezvous
#: and for each of its collectives (torch.distributed's timeout)
DEVICE_WORLD_TIMEOUT = datetime.timedelta(seconds=120)


def _process_group(addr: str, world_size: int, rank: int):
    """The job's gloo process group: joined once a process, then reused
    (a re-init dials nothing).  Destroyed at the process's exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"a live process group of {dist.get_world_size()} ranks "
                f"(rank {dist.get_rank()}) cannot serve a device world of "
                f"{world_size} (rank {rank})")
        return dist.group.WORLD
    host = addr.rpartition(":")[0]
    if host in ("127.0.0.1", "localhost") \
            and "GLOO_SOCKET_IFNAME" not in os.environ:
        # a loopback rendezvous: gloo's own pick would resolve the host
        # name, which a sealed machine may not map to any interface
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=world_size,
        rank=rank, timeout=DEVICE_WORLD_TIMEOUT)
    atexit.register(_destroy_process_group)
    return dist.group.WORLD


def _destroy_process_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass   # a peer already gone must not fail the exit


class Instance:
    """The booted runtime instance: rte, selected pml and pset access.

    Never constructed directly: :func:`acquire` boots (or refcounts) the
    process-wide instance; :func:`release` drops one reference and tears
    down on the last."""

    def __init__(self) -> None:
        self.rte = None
        self.pml = None
        self._fenced = False
        self._torn_down = False

    # -- boot ------------------------------------------------------------
    def _boot(self, argv=None, device=None, rte=None) -> None:
        from ompi_tpu_torch.mca.threads import base as threads_base
        from ompi_tpu_torch.rte.base import detect
        from ompi_tpu_torch.runtime import (flight, interlib, monitoring,
                                            profile, spc, telemetry, trace)

        # (re)apply --mca arguments and OTPU_MCA_* environment values to
        # every registered var: each boot reads the settings anew
        registry.parse_cli(list(argv or ()))
        t_boot = trace.now()
        # the rte's construction is the coordination service's connect
        # (ompi_mpi_init.c:516, PMIx_Init)
        t0 = trace.now()
        self.rte = rte if rte is not None else detect(device)
        trace.span("coord_connect", "boot", t0)
        spc.init()
        trace.init()
        # a re-boot after a teardown may use the work pool again
        threads_base.reopen_pool()
        interlib.note_main_thread(force=True)
        # CPU binding and the topology modex (the reference binds in
        # PRRTE before exec; here first thing at boot)
        from ompi_tpu_torch.base import hwloc

        if os.environ.get("OTPU_BIND_POLICY") == "core" and \
                hasattr(self.rte, "my_world_rank"):
            local_n = max(1, int(os.environ.get("OTPU_LOCAL_NRANKS", "1")))
            hwloc.bind_self(hwloc.compute_binding(
                self.rte.my_world_rank % local_n, local_n))
        if hasattr(self.rte, "modex_put"):
            topo = hwloc.host_topology(refresh=True)
            self.rte.modex_put("cpus", list(topo.cpus_allowed))
        # the device world's process group (before the modex fence, so the
        # fence also orders its boot)
        t0 = trace.now()
        self._boot_device_world()
        trace.span("jax_distributed_init", "boot", t0)
        # pml selection (ompi_mpi_init.c:630) with pml/monitoring's
        # interposition (per-peer traffic matrices), then vprotocol's
        # outside it (message-event logging, or replay: a replayed receive
        # never reaches monitoring)
        comp = mca.framework("pml", "point-to-point messaging layer").select()
        if comp is None:
            raise RuntimeError("no pml component available")
        from ompi_tpu_torch.mca.pml import vprotocol

        self.pml = vprotocol.maybe_wrap_pml(
            monitoring.maybe_wrap_pml(comp.get_module(self.rte)), self.rte)
        # the modex fence that publishes the btls' endpoints (:682-701)
        t0 = trace.now()
        self.rte.fence()
        trace.span("modex_fence", "boot", t0)
        # CIDs 0/1 belong to WORLD/SELF whether or not the world model
        # ever initializes: a session-built comm on cid 0 would alias the
        # revocation key space
        from ompi_tpu_torch.runtime import init as rt

        rt.reserve_cid(0)
        rt.reserve_cid(1)
        mark_runtime_initialized(True)
        # the live telemetry sampler and the crash-time flight recorder
        # need the coordination client; the sampling profiler needs none
        # (all are no-ops unless their vars or triggers arm them)
        if getattr(self.rte, "client", None) is not None:
            flight.arm(self.rte)
            telemetry.start(self.rte)
        profile.start(self.rte)
        trace.span("instance_boot", "boot", t_boot)

    def _boot_device_world(self) -> None:
        """Join the job's process group (opt-in: the launcher sets
        ``OTPU_DEVICE_WORLD``).  A spawned job would need a rendezvous of
        its own, so only the primary job boots one."""
        rte = self.rte
        if os.environ.get("OTPU_DEVICE_WORLD", "") in ("", "0"):
            return
        if rte.is_device_world or getattr(rte, "job", "0") != "0":
            return
        # the env override first: a KV wait would stall 30 s before it
        addr = os.environ.get("OTPU_DIST_COORD")
        client = getattr(rte, "client", None)
        if not addr and client is not None:
            from ompi_tpu_torch.rte.coord import DIST_COORD_KEY

            try:
                addr = client.get(-1, DIST_COORD_KEY, wait=True,
                                  timeout=30.0)
            except Exception:
                addr = None
        if not addr:
            raise RuntimeError(
                "OTPU_DEVICE_WORLD is set but no rendezvous address was "
                "published (launch with tpurun --device-world)")
        from ompi_tpu_torch.base import cudaenv

        procs = list(getattr(rte, "job_ranks", range(rte.world_size)))
        me = procs.index(rte.my_world_rank)
        k = cudaenv.virtual_ranks()
        rte.process_group = _process_group(str(addr), len(procs), me)
        rte.device_world_booted = True
        rte.global_ranks = list(range(len(procs) * k))
        rte.local_ranks = list(range(me * k, (me + 1) * k))

    # -- teardown --------------------------------------------------------
    def _fence_final(self) -> None:
        """Pre-teardown synchronisation (ompi_mpi_finalize's barrier),
        one-shot: a fast-exiting rank must not unlink shared segments a
        slower peer still drains.  The btls' queued sends drain first: a
        completed send's frames may still wait for ring space that only the
        receiver frees, and the fence blocks this rank's progress.  Frames
        that cannot be delivered raise (after the flag is set, so the
        teardown that follows skips the fence)."""
        if self._fenced:
            return
        self._fenced = True
        bml = getattr(self.pml, "bml", None)
        if bml is not None:
            bml.flush()
        fence_final = getattr(self.rte, "fence_final", None)
        if fence_final is not None:
            try:
                fence_final()
            except Exception:
                pass   # coord gone / timeout: peers are exiting too

    def _teardown(self) -> None:
        """One-shot teardown in the reference's order; the ground state is
        restored whatever failed before.  An undeliverable frame found by
        the final drain is raised at the end, so the launcher ends the job
        with the rank's failure."""
        if self._torn_down:
            return
        self._torn_down = True
        error = None
        try:
            try:
                self._fence_final()
            except BaseException as exc:
                error = exc
            from ompi_tpu_torch.ft import propagator
            from ompi_tpu_torch.runtime import init as rt
            from ompi_tpu_torch.runtime import flight, monitoring, trace

            propagator.stop()
            # the trace export, the survivor post-mortem (a job that saw
            # peer failures: its ring now holds the whole recovery) and
            # the monitoring publish need the coordination client (KV
            # publish, clock offset): before the rte's finalize
            for publish in (trace.finalize_export,
                            flight.maybe_dump_postmortem,
                            monitoring.finalize_publish):
                try:
                    publish(self.rte)
                except Exception:
                    pass   # observability must never break teardown
            # release the coll modules of every comm the user never freed
            # (ompi_mpi_finalize destroys the remaining comms the same way)
            for comm in rt.live_comms():
                if not comm.freed:
                    try:
                        comm.release_coll_modules()
                    except Exception:
                        pass
            for closer in (getattr(self.pml, "finalize", None),
                           getattr(self.rte, "finalize", None)):
                if closer is not None:
                    try:
                        closer()
                    except Exception:
                        pass   # a dead peer/coord must not wedge teardown
        finally:
            from ompi_tpu_torch.ft import propagator
            from ompi_tpu_torch.mca.threads import base as threads_base
            from ompi_tpu_torch.runtime import init as rt
            from ompi_tpu_torch.runtime import (flight, profile, progress,
                                                telemetry)

            # the FT threads, the sampler's and the profiler's end with the
            # runtime, whichever path tears it down
            propagator.stop()
            telemetry.stop()
            flight.disarm()
            profile.stop()
            threads_base.shutdown_pool(permanent=True)
            mca.close_all()
            progress.reset_for_testing()
            rt.clear_cid_space()
            rt.forget_comms()
            mark_runtime_initialized(False)
        if error is not None:
            raise error

    # -- process sets ----------------------------------------------------
    def pset_names(self) -> list:
        """Every process-set name this instance can resolve: the MPI-4
        builtins plus whatever the coordination service advertises."""
        names = [PSET_WORLD, PSET_SELF]
        client = getattr(self.rte, "client", None)
        if client is not None:
            try:
                for row in client.pset_list():
                    if row["name"] not in names:
                        names.append(row["name"])
            except Exception:
                pass   # coord gone: the builtins still resolve
        return names

    def pset_members(self, name: str) -> list:
        """World ranks of a named pset (raises on an unknown name)."""
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError

        rte = self.rte
        if name == PSET_WORLD:
            return list(getattr(rte, "job_ranks", range(rte.world_size)))
        if name == PSET_SELF:
            return [rte.my_world_rank]
        client = getattr(rte, "client", None)
        entry = None
        if client is not None:
            try:
                entry = client.pset_get(name)
            except Exception:
                entry = None
        if entry is None:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"unknown process set {name!r}")
        return [int(m) for m in entry["members"]]

    def pset_source(self, name: str) -> str:
        if name in (PSET_WORLD, PSET_SELF):
            return "builtin"
        client = getattr(self.rte, "client", None)
        if client is not None:
            try:
                entry = client.pset_get(name)
                if entry is not None:
                    return str(entry.get("source", "coord"))
            except Exception:
                pass
        return "unknown"

    def pset_info(self, name: str):
        """``MPI_Session_get_pset_info``: at least ``mpi_size`` (MPI-4
        §11.3.3), plus membership and origin for introspection."""
        from ompi_tpu_torch.api.info import Info

        members = self.pset_members(name)
        return Info({
            "mpi_size": str(len(members)),
            "otpu_members": ",".join(str(m) for m in members),
            "otpu_source": self.pset_source(name),
        })


# -- module-level acquire/release (the ompi_instance_count discipline) --

def acquire(argv=None, device=None, rte=None) -> Instance:
    """Acquire the process-wide instance, booting the runtime on the first
    reference.  ``argv``/``device``/``rte`` only matter for the boot; a
    booted instance ignores them (the first owner decides the process
    model and the device, as in the reference).  A failed boot releases
    what it acquired and raises."""
    global _refcount, _instance, _atexit_armed
    with _lock:
        if _instance is None:
            inst = Instance()
            try:
                inst._boot(argv=argv, device=device, rte=rte)
            except BaseException:
                inst._fenced = True   # nothing to fence with a half boot
                try:
                    inst._teardown()
                except BaseException:
                    pass
                raise
            _instance = inst
            if not _atexit_armed:
                _atexit_armed = True
                atexit.register(_atexit_teardown)
        _refcount += 1
        return _instance


def release() -> int:
    """Drop one reference; the last release tears the runtime down.
    Returns the remaining reference count."""
    global _refcount, _instance
    with _lock:
        if _instance is None:
            return 0
        _refcount -= 1
        if _refcount > 0:
            return _refcount
        inst, _instance = _instance, None
        _refcount = 0
        inst._teardown()
        return 0


def current() -> Optional[Instance]:
    """The booted instance, or None: never boots as a side effect."""
    return _instance


def refcount() -> int:
    with _lock:
        return _refcount


def _atexit_teardown() -> None:
    """Interpreter exit with sessions still open: drain them (the world's
    own exit finalize ran first: atexit is LIFO and the world registers
    after the instance boots)."""
    global _refcount, _instance
    with _lock:
        if _instance is None:
            return
        inst, _instance = _instance, None
        _refcount = 0
    try:
        inst._teardown()
    except Exception:
        pass


def reset_for_testing() -> None:
    """Force-release every reference and tear down (tests only)."""
    _atexit_teardown()
