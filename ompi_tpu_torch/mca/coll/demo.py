"""coll/demo — the teaching interposition component.

Copy of ``ompi_tpu/mca/coll/demo.py`` (after the reference's
``ompi/mca/coll/demo/``): a component that, when enabled, slots in ABOVE
the real selection and announces every collective before delegating to the
underlying module — the minimal example of the interposition pattern that
coll/sync (and, in the reference, coll/monitoring) are production uses of.

Enable with ``--mca coll_demo_priority 100``; verbosity goes to the coll
framework's output stream (``--mca coll_base_verbose 1``).  It answers
only multi-process communicators: in the device world it declines, where
the reference's wraps the conductor's slots.
"""
from __future__ import annotations

from ompi_tpu_torch.base import output as _output
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType

_WRAPPED = ("barrier", "bcast", "allreduce", "reduce", "allgather",
            "alltoall", "scatter", "gather", "scan", "exscan")


class DemoModule:
    """Wraps the slots already chosen in the comm's c_coll table."""

    def __init__(self, component: "DemoCollComponent") -> None:
        self._c = component

    def comm_enable(self, comm) -> None:
        # runs after the vtable is filled by lower-priority components;
        # re-point each slot at an announcing wrapper around the original
        stream = self._c.framework.stream if self._c.framework else 0
        for name in _WRAPPED:
            inner = comm.c_coll.get(name)
            if inner is None or getattr(inner, "_demo_wrapped", False):
                continue

            def wrapped(comm_arg, *args, _inner=inner, _name=name, **kw):
                _output.output(stream, 1, "demo: %s on %s (rank %d)",
                               _name, comm_arg.name, comm_arg.rank)
                return _inner(comm_arg, *args, **kw)

            wrapped._demo_wrapped = True
            comm.c_coll[name] = wrapped


class DemoCollComponent(Component):
    name = "demo"
    priority = -1          # never selected unless the user asks

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=-1,
            help="Priority of coll/demo (negative = disabled; set >=100 "
                 "to interpose the announcing wrappers)")

    def open(self) -> bool:
        self.priority = int(self._prio.value)
        return self.priority >= 0

    def comm_query(self, comm):
        # the device world keeps its vote: unlike the reference, demo does
        # not wrap the conductor's slots there
        if comm.rte is not None and comm.rte.is_device_world:
            return None
        return self.priority, DemoModule(self)


COMPONENT = DemoCollComponent()
