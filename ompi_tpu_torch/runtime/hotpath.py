"""@hot_path — the allocation-budget tag for runtime hot functions.

Copy of ``ompi_tpu/runtime/hotpath.py``.  The decorator is the identity at
run time: it records the function's qualified name in a registry (a cost at
decoration only) and returns the function object unchanged, so a tagged hot
loop carries no wrapper.  Tag the functions that run per message or per
progress tick: the progress loop, btl send/receive and framing, convertor
pack.
"""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, str] = {}   # qualified name -> defining module


def hot_path(fn: Callable) -> Callable:
    """Tag ``fn`` as a runtime hot path (identity; see module docstring)."""
    _REGISTRY[f"{fn.__module__}.{fn.__qualname__}"] = fn.__module__
    return fn


def registered() -> dict[str, str]:
    """{qualified name: module} of every imported @hot_path function."""
    return dict(_REGISTRY)
