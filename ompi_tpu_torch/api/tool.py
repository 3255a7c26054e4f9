"""MPI_T tool information interface (``ompi/mpi/tool``, MPI-3 §14.3).

Copy of ``ompi_tpu/api/tool.py`` with its imports re-pointed.  Open MPI
exposes the MCA var/pvar registry programmatically so performance tools
can enumerate, read, and (for control variables) write tunables at runtime
without linking private headers.  Same product here, over
``ompi_tpu_torch.base.var.registry``:

- control variables (cvars)  ≅ MPI_T_cvar_get_num / get_info /
  read / write  (``mca_base_var`` registry rows)
- performance variables (pvars) ≅ MPI_T_pvar_get_num / get_info +
  session/handle start-stop-read (``mca_base_pvar``)

Sessions exist for Open MPI's reason: a tool's handles must be
independent of another tool's (start/stop state is per-handle, not
per-variable).  Verbosity levels and binding objects are carried but the
Python surface keeps them advisory.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Optional

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.var import Pvar, Var, registry

_init_count = 0
_lock = threading.Lock()


def init_thread() -> None:
    """``MPI_T_init_thread``: refcounted, independent of MPI init."""
    global _init_count
    with _lock:
        _init_count += 1


def finalize() -> None:
    """``MPI_T_finalize``."""
    global _init_count
    with _lock:
        if _init_count == 0:
            raise MpiError(ErrorClass.ERR_OTHER, "MPI_T not initialized")
        _init_count -= 1


def _check_init() -> None:
    if _init_count == 0:
        raise MpiError(ErrorClass.ERR_OTHER,
                       "MPI_T interface not initialized")


# -- control variables ---------------------------------------------------

def cvar_get_num() -> int:
    _check_init()
    return len(registry.all_vars())


def cvar_get_info(index: int) -> Var:
    """Returns the Var object itself — name/value/type/source are its
    attributes (the C API's out-params)."""
    _check_init()
    out = registry.all_vars()
    if not 0 <= index < len(out):
        raise MpiError(ErrorClass.ERR_ARG, f"no cvar at index {index}")
    return out[index]


def cvar_get_index(name: str) -> int:
    _check_init()
    for i, v in enumerate(registry.all_vars()):
        if v.name == name:
            return i
    raise MpiError(ErrorClass.ERR_ARG, f"no cvar named {name!r}")


def cvar_read(index: int) -> Any:
    return cvar_get_info(index).value


def cvar_write(index: int, value: Any) -> None:
    """``MPI_T_cvar_write``: runtime set, recorded with source=tool.

    Raises MpiError when the variable cannot be written (constant scope,
    or read-only after runtime init) — mirroring MPI_T_ERR_CVAR_SET_NEVER
    / _SET_NOT_NOW."""
    from ompi_tpu_torch.base.var import VarSource

    var = cvar_get_info(index)
    try:
        applied = var._set(value, VarSource.API, "MPI_T")
    except RuntimeError as exc:
        raise MpiError(ErrorClass.ERR_ARG,
                       f"cvar {var.name} not settable now: {exc}")
    if not applied:
        raise MpiError(ErrorClass.ERR_ARG,
                       f"cvar {var.name} can never be set (constant scope)")


# -- performance variables ----------------------------------------------

def pvar_get_num() -> int:
    _check_init()
    return len(registry.all_pvars())


def pvar_get_info(index: int) -> Pvar:
    _check_init()
    out = registry.all_pvars()
    if not 0 <= index < len(out):
        raise MpiError(ErrorClass.ERR_ARG, f"no pvar at index {index}")
    return out[index]


def pvar_get_index(name: str) -> int:
    _check_init()
    for i, p in enumerate(registry.all_pvars()):
        if p.name == name:
            return i
    raise MpiError(ErrorClass.ERR_ARG, f"no pvar named {name!r}")


class PvarSession:
    """``MPI_T_pvar_session``: an isolated set of pvar handles."""

    def __init__(self) -> None:
        _check_init()
        self._handles: dict[int, "PvarHandle"] = {}
        self._ids = itertools.count(1)

    def handle_alloc(self, index: int, obj: Any = None) -> "PvarHandle":
        h = PvarHandle(pvar_get_info(index), next(self._ids), obj)
        self._handles[h.hid] = h
        return h

    def handle_free(self, handle: "PvarHandle") -> None:
        self._handles.pop(handle.hid, None)


class PvarHandle:
    """A started/stopped view of one pvar; ``read`` reports the delta
    since ``start`` for counters (the MPI_T session semantic that lets
    two tools watch one counter without fighting over resets)."""

    def __init__(self, pvar: Pvar, hid: int, obj: Any = None) -> None:
        self.pvar = pvar
        self.hid = hid
        self.bound_obj = obj
        self.started = False
        self._frozen_valid = False   # has start() or stop() set _frozen state?
        self._base = 0.0
        self._frozen = 0.0

    def _delta_class(self) -> bool:
        """Counters/timers report deltas against the start value; level,
        size, and watermark classes are absolute (MPI-3 §14.3.7)."""
        from ompi_tpu_torch.base.var import PvarClass

        return self.pvar.pclass in (PvarClass.COUNTER, PvarClass.TIMER)

    def start(self) -> None:
        self._base = self.pvar.read() if self._delta_class() else 0.0
        self.started = True
        self._frozen_valid = True

    def stop(self) -> None:
        """Freeze the handle: reads after stop report the value observed
        at stop time (MPI-3 §14.3 stopped-handle semantics)."""
        self._frozen = self.pvar.read() - self._base
        self.started = False
        self._frozen_valid = True

    def read(self) -> float:
        if not self.started:
            # a never-started, never-stopped handle on an absolute class
            # (LEVEL/SIZE/WATERMARK) reports the live value — MPI-3
            # continuous-variable semantics; only delta classes freeze at 0
            # before a start, and an explicit stop() freezes every class
            if not self._frozen_valid and not self._delta_class():
                return self.pvar.read()
            return self._frozen
        return self.pvar.read() - self._base

    def reset(self) -> None:
        self._base = self.pvar.read() if self._delta_class() else 0.0
        self._frozen = 0.0


def pvar_session_create() -> PvarSession:
    return PvarSession()


def pvar_session_free(session: PvarSession) -> None:
    session._handles.clear()


# -- categories (MPI_T_category_*): frameworks are the natural grouping --

def category_get_num() -> int:
    _check_init()
    from ompi_tpu_torch.base import mca

    return len(mca.all_frameworks())


def category_get_info(index: int):
    """(name, description, cvar names in the category)."""
    _check_init()
    from ompi_tpu_torch.base import mca

    fws = mca.all_frameworks()
    if not 0 <= index < len(fws):
        raise MpiError(ErrorClass.ERR_ARG, f"no category at index {index}")
    fw = fws[index]
    vars_in = [v.name for v in registry.all_vars()
               if v.group.split("/")[0] == fw.name]
    return fw.name, fw.description, vars_in
