"""op framework base: per-(op, dtype) kernel selection.

Port of ``ompi_tpu/mca/op/base.py``, after
``ompi/mca/op/base/op_base_op_select.c``: every available component is
queried for a fold covering the (op, dtype) pair; the highest-priority
non-None answer wins and is cached.  Selection honours the ``otpu_op``
include/exclude var, so ``--mca op ^cuda_vpu`` forces the builtin torch
folds exactly like ``--mca op ^avx`` in the reference.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from ompi_tpu_torch.base import mca

_lock = threading.Lock()
_cache: dict = {}


def _framework() -> mca.Framework:
    fw = mca.framework("op", "reduction kernel components", multi_select=True)
    if not fw.opened:
        fw.open()
    return fw


def _select(kind: str, op_name: str, dtype, **kw) -> Optional[Callable]:
    key = (kind, op_name, str(dtype), *kw.values())
    with _lock:
        if key in _cache:
            return _cache[key]
    best = None
    for comp in sorted(_framework().available, key=lambda c: -c.priority):
        query = getattr(comp, f"query_{kind}", None)
        best = query(op_name, dtype, **kw) if query else None
        if best is not None:
            break
    with _lock:
        _cache[key] = best
    return best


def select_fold(op_name: str, dtype,
                fusable: bool = False) -> Optional[Callable]:
    """Highest-priority two-operand fold for (op, dtype), or None.

    ``fusable=True`` asks for a fold built of plain torch ops (the
    reference's "a fold XLA can fuse into surrounding computation", which
    scans ask for): kernel components decline it."""
    return _select("fold", op_name, dtype, fusable=fusable)


def select_stack(op_name: str, dtype) -> Optional[Callable]:
    """Fused (k, ...)-stack axis-0 reduction for (op, dtype), or None."""
    return _select("stack", op_name, dtype)


def reset_cache() -> None:
    with _lock:
        _cache.clear()
