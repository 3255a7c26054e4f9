"""io/base — per-file component selection (the reference's
``mca/io/base/io_base_file_select.c``; copy of ``ompi_tpu/mca/io/base.py``)."""
from __future__ import annotations

from ompi_tpu_torch.base import mca


def io_framework() -> mca.Framework:
    return mca.framework("io", "MPI-IO operations", multi_select=True)


def file_select(file) -> None:
    """Pick the highest-priority io module for this file."""
    fw = io_framework()
    best = None
    for comp in fw.select_all():
        query = getattr(comp, "file_query", None)
        if query is None:
            continue
        res = query(file)
        if res is None:
            continue
        priority, module = res
        if priority < 0:
            continue
        if best is None or priority > best[0]:
            best = (priority, module)
    if best is None:
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError

        raise MpiError(ErrorClass.ERR_IO,
                       f"no io component available for {file.filename!r}")
    file.io_module = best[1]
