"""osc — one-sided communication framework (``ompi/mca/osc/``).

Copy of ``ompi_tpu/mca/osc/__init__.py``.  Components are selected per
*window*, the way the reference queries osc components at
``MPI_Win_create`` (``osc_base_init.c``); the reference's priorities:

- ``device`` (90) — the device world's window on the card, one tensor
  whose row r is rank r's region (``Win.create(..., device=True)``);
- ``local`` (80) — windows whose every region lives in this process (the
  device world, or a comm of one);
- ``rdma`` (60) — mapped shared-memory windows between the processes of
  one node, with the native core's locks and atomics;
- ``pt2pt`` (50) — active-message RMA over pml/ob1 with a per-window
  agent thread, for everything else (ranks on several nodes).
"""
from __future__ import annotations

from ompi_tpu_torch.base import mca


def osc_framework() -> mca.Framework:
    return mca.framework("osc", "one-sided communication", multi_select=True)


def win_select(win) -> None:
    """Pick the highest-priority osc component claiming this window."""
    best = None
    for comp in osc_framework().select_all():
        query = getattr(comp, "win_query", None)
        if query is None:
            continue
        res = query(win)
        if res is None:
            continue
        priority, module = res
        if best is None or priority > best[0]:
            best = (priority, module)
    if best is None:
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError

        raise MpiError(ErrorClass.ERR_WIN,
                       "no osc component available for this window")
    win.module = best[1]
    win.module.attach(win)
