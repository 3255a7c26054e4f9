"""coll/base: per-communicator component selection.

Port of ``ompi_tpu/mca/coll/base.py`` (after the reference's
``ompi/mca/coll/base/coll_base_comm_select.c``): query every available
component for this communicator, keep those answering with priority >= 0,
sort ascending, then fill the per-comm vtable ``c_coll`` in priority order
so the highest-priority provider of each individual function wins.  Then
the two interposition layers wrap every slot, device and host alike, as the
reference's do (``ompi_tpu/mca/coll/base.py:64-73``): coll/monitoring's
recorder only while ``otpu_monitoring_enable`` is set, then coll/trace's
span and histogram recorder always (its disabled path is one flag check).
Both wrappers carry the inner slot's ``__self__``.
"""
from __future__ import annotations

from ompi_tpu_torch.api.comm import COLL_FUNCTIONS
from ompi_tpu_torch.base import mca
from ompi_tpu_torch.base import output as _output


def coll_framework() -> mca.Framework:
    return mca.framework("coll", "collective operations", multi_select=True)


def comm_select(comm) -> None:
    """Fill ``comm.c_coll`` by priority vote across coll components."""
    fw = coll_framework()
    scored = []
    for comp in fw.select_all():
        query = getattr(comp, "comm_query", None)
        if query is None:
            continue
        try:
            res = query(comm)
        except Exception as exc:
            _output.output(fw.stream, 1, "coll %s comm_query failed: %s",
                           comp.name, exc)
            res = None
        if res is None:
            continue
        priority, module = res
        if priority < 0:
            continue
        scored.append((priority, comp.name, module))
    # ascending sort; later (higher-priority) modules overwrite earlier ones
    scored.sort(key=lambda t: (t[0], t[1]))
    comm.c_coll = {}
    comm.coll_modules = [m for _, _, m in scored]
    for _, _, module in scored:
        enable = getattr(module, "comm_enable", None)
        if enable is not None:
            enable(comm)
        for fname in COLL_FUNCTIONS:
            fn = getattr(module, fname, None)
            if fn is not None:
                comm.c_coll[fname] = fn
    if not comm.c_coll:
        _output.show_help("help-coll", "none-available", comm=comm.name)
    from ompi_tpu_torch.runtime import monitoring, trace

    monitoring.wrap_coll_table(comm)
    trace.wrap_coll_table(comm)


_output.register_help(
    "help-coll", "none-available",
    "No collective component is available for communicator {comm}; "
    "collective operations on it will fail.")
