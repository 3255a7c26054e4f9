"""coll/sync — periodic barrier injection to bound unexpected messages.

Copy of ``ompi_tpu/mca/coll/sync.py`` (after the reference's
``ompi/mca/coll/sync/``): on communicators where one rank races far ahead
(a root spamming bcasts), unexpected-message queues grow without bound;
this interposition component counts rooted collective operations and
injects a barrier every ``otpu_coll_sync_barrier_after`` calls.  Priority
50, and disabled (``comm_query`` answers None) unless the count var is set,
like the reference.
"""
from __future__ import annotations

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType


class SyncModule:
    """Wraps the already-selected one-sided-flow collectives with a
    countdown barrier (the reference interposes bcast/reduce/scatter —
    the rooted, non-synchronizing ops)."""

    WRAPPED = ("bcast", "reduce", "scatter", "scatterv", "ibcast", "ireduce")

    def __init__(self, component: "SyncCollComponent") -> None:
        self._c = component
        self._count = 0

    def comm_enable(self, comm) -> None:
        # runs during comm_select AFTER lower-priority modules filled the
        # table (ascending fill order): wrap what they provided
        interval = int(self._c.after_var.value)
        for name in self.WRAPPED:
            fn = comm.c_coll.get(name)
            if fn is None or getattr(fn, "__sync_wrapped__", False):
                continue
            comm.c_coll[name] = self._make(comm, name, fn, interval)

    def _make(self, comm, name, fn, interval):
        def wrapped(comm_arg, *args, **kw):
            self._count += 1
            if self._count % interval == 0:
                barrier = comm_arg.c_coll.get("barrier")
                if barrier is not None:
                    barrier(comm_arg)
            return fn(comm_arg, *args, **kw)

        wrapped.__sync_wrapped__ = True
        wrapped.__self__ = getattr(fn, "__self__", None)
        return wrapped


class SyncCollComponent(Component):
    name = "sync"
    priority = 50      # above the providers it wraps; fills no slot itself

    def register_vars(self, fw) -> None:
        self.after_var = self.register_var(
            "barrier_after", vtype=VarType.INT, default=0,
            help="Inject a barrier every N rooted collectives "
                 "(0 = disabled, the reference's default)")

    def comm_query(self, comm):
        if int(self.after_var.value) <= 0:
            return None
        if comm.size == 1 or comm.is_inter:
            return None
        if comm.rte is not None and comm.rte.is_device_world:
            return None
        return self.priority, SyncModule(self)


COMPONENT = SyncCollComponent()
