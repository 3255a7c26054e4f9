"""MPI-4 Sessions (``ompi/mpi/c/session_*.c`` + ``ompi/instance``).

Copy of ``ompi_tpu/api/session.py``; ``Session.init`` also takes the
``device`` the first boot binds (the card unless the caller names another,
``device="cpu"`` on the CPU lane), as ``init`` does.

A Session is an application-visible handle on the runtime instance: it
can be opened WITHOUT ``MPI_Init``, enumerates the process sets the
runtime advertises, and seeds the sessions-model communicator
construction chain::

    s = Session.init()
    g = s.group_from_pset("mpi://WORLD")     # MPI_Group_from_session_pset
    comm = Comm.create_from_group(g, "app")  # MPI_Comm_create_from_group

Each open session holds one reference on the underlying instance
(:mod:`ompi_tpu_torch.instance`), so any number of sessions and the world
model share a single RTE/coord boot, and the runtime only tears down
when the last of them is gone.  Per MPI-4, a session's communicators
remain independent objects: finalizing the session that created a
communicator does not invalidate the communicator (the instance — kept
alive by nothing once all refs drop — is what actually owns the RTE).
"""
from __future__ import annotations

import threading
from typing import Optional

from ompi_tpu_torch.api.errhandler import ERRORS_ARE_FATAL, Errhandler
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.info import Info


class Session:
    """``MPI_Session``: init/finalize, errhandler + info, pset queries."""

    _count = 0
    _count_lock = threading.Lock()

    def __init__(self, instance, info: Optional[Info],
                 errhandler: Optional[Errhandler]) -> None:
        self._instance = instance
        self._finalized = False
        self.info = (info or Info()).dup()
        self.errhandler = errhandler or ERRORS_ARE_FATAL
        with Session._count_lock:
            Session._count += 1
            self.name = f"session#{Session._count}"

    # -- lifecycle -------------------------------------------------------
    @classmethod
    def init(cls, info: Optional[Info] = None,
             errhandler: Optional[Errhandler] = None,
             argv: Optional[list] = None, device=None) -> "Session":
        """``MPI_Session_init``: open a session, booting the runtime
        instance if this is the first reference (no MPI_Init needed —
        sessions ARE the boot path; world init is just the implicit
        default session).  The first boot binds ``device`` (the card
        unless the caller names another); a booted instance keeps its
        own."""
        from ompi_tpu_torch import instance as inst_mod

        return cls(inst_mod.acquire(argv=argv, device=device), info,
                   errhandler)

    def finalize(self) -> None:
        """``MPI_Session_finalize``: drop this session's instance
        reference (the last reference — session or world — finalizes
        the runtime)."""
        self._check()
        self._finalized = True
        from ompi_tpu_torch import instance as inst_mod

        inst_mod.release()

    @property
    def finalized(self) -> bool:
        return self._finalized

    def _check(self) -> None:
        if self._finalized:
            self._err(MpiError(ErrorClass.ERR_SESSION,
                               f"{self.name} was finalized"))

    def _err(self, error: MpiError) -> None:
        self.errhandler.invoke(self, error)
        raise error  # ERRORS_RETURN already raised; fatal aborts

    # -- errhandler / info ----------------------------------------------
    def set_errhandler(self, eh: Errhandler) -> None:
        self.errhandler = eh

    def get_errhandler(self) -> Errhandler:
        return self.errhandler

    def call_errhandler(self, errorcode) -> None:
        """``MPI_Session_call_errhandler``."""
        try:
            cls = ErrorClass(int(errorcode))
        except ValueError:
            cls = ErrorClass.ERR_OTHER
        self._err(MpiError(cls, f"user-raised code {int(errorcode)}"))

    def get_info(self) -> Info:
        """``MPI_Session_get_info``: the session's hints (always
        includes the provided thread level, like the reference)."""
        self._check()
        out = self.info.dup()
        if "thread_level" not in out:
            out.set("thread_level", "MPI_THREAD_MULTIPLE")
        return out

    # -- process sets ----------------------------------------------------
    def get_num_psets(self, info: Optional[Info] = None) -> int:
        """``MPI_Session_get_num_psets``."""
        self._check()
        return len(self._instance.pset_names())

    def get_nth_pset(self, n: int, info: Optional[Info] = None) -> str:
        """``MPI_Session_get_nth_pset``."""
        self._check()
        names = self._instance.pset_names()
        if not 0 <= int(n) < len(names):
            self._err(MpiError(ErrorClass.ERR_ARG,
                               f"pset index {n} out of range "
                               f"[0, {len(names)})"))
        return names[int(n)]

    def psets(self) -> list:
        """All pset names (convenience superset of the nth iteration)."""
        self._check()
        return self._instance.pset_names()

    def get_pset_info(self, name: str) -> Info:
        """``MPI_Session_get_pset_info``: at least ``mpi_size``."""
        self._check()
        try:
            return self._instance.pset_info(name)
        except MpiError as exc:
            self._err(exc)

    def group_from_pset(self, name: str):
        """``MPI_Group_from_session_pset``: the ordered group of world
        ranks behind a named pset."""
        self._check()
        from ompi_tpu_torch.api.group import Group

        try:
            return Group(self._instance.pset_members(name))
        except MpiError as exc:
            self._err(exc)

    def __repr__(self) -> str:
        state = "finalized" if self._finalized else "active"
        return f"Session({self.name}, {state})"
