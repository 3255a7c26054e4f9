"""Communicators: group + CID + per-comm collective vtable.

Port of the part of ``ompi_tpu/api/comm.py`` that the device-buffer
collectives need: a communicator owns its group, a context id and a per-comm
collective vtable ``c_coll`` filled by the priority vote of the coll
components (``coll_base_comm_select.c``), and its info hints (an ``Info``;
the ``otpu_quant_budget`` key arms coll/quant).  Every slot that no
selected module fills raises ``MpiError(ERR_UNSUPPORTED_OPERATION)``.  Of
communicator construction only ``dup`` and ``dup_with_info`` are ported;
the persistent collectives only on device buffers (``allreduce_array_init``,
``coll_init``); point-to-point and fault tolerance are not ported yet.
"""
from __future__ import annotations

from typing import Any

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError, RevokedError
from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.api.info import Info

#: collective function slots a coll module can fill (the device-buffer
#: entry points of ``ompi_tpu/api/comm.py:COLL_FUNCTIONS`` ported so far)
COLL_FUNCTIONS = ("allreduce_array", "bcast_array", "allgather_array",
                  "reduce_scatter_array", "psum_scatter_array",
                  "alltoall_array", "alltoallv_array", "allgatherv_array",
                  "ppermute_array", "persistent_coll")


class Comm:
    def __init__(self, group: Group, cid: int, rte, name: str = "") -> None:
        self.group = group
        self.cid = cid
        self.rte = rte
        self.name = name or f"comm#{cid}"
        self.c_coll: dict[str, Any] = {}
        self.coll_modules: list = []
        self.info = Info()
        self.revoked = False
        self.freed = False
        self._rank = group.rank_of(rte.my_world_rank) if rte else 0

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self.group.size

    def _check_state(self) -> None:
        # NOTE: allreduce_array inlines this predicate on its fast path
        if self.freed:
            raise MpiError(ErrorClass.ERR_COMM, "communicator was freed")
        if self.revoked:
            raise RevokedError(f"{self.name} revoked")

    def _coll(self, name: str):
        fn = self.c_coll.get(name)
        if fn is None:
            raise MpiError(
                ErrorClass.ERR_UNSUPPORTED_OPERATION,
                f"no coll component provides '{name}' on {self.name}")
        return fn

    def set_info(self, info: Info) -> None:
        """``MPI_Comm_set_info``: replace the comm's info hints."""
        self.info = info.dup()

    def get_info(self) -> Info:
        """``MPI_Comm_get_info``."""
        return self.info.dup()

    def dup(self) -> "Comm":
        """``MPI_Comm_dup`` in the device world: the same group and rte, the
        next free context id, the info hints copied, and a coll selection
        of its own (``comm_dup`` + ``coll_base_comm_select``)."""
        self._check_state()
        from ompi_tpu_torch.mca.coll.base import comm_select
        from ompi_tpu_torch.runtime import init as rt

        newcomm = Comm(self.group, rt.next_local_cid(), self.rte,
                       name=f"{self.name}~dup")
        newcomm.info = self.info.dup()
        rt.register_comm(newcomm)
        comm_select(newcomm)
        return newcomm

    def dup_with_info(self, info: Info) -> "Comm":
        """``MPI_Comm_dup_with_info``: dup, with the new comm's hints
        REPLACED by ``info`` instead of inherited."""
        newcomm = self.dup()
        newcomm.info = info.dup()
        return newcomm

    # device-array collectives (tensors with a leading rank axis) ----------
    def allreduce_array(self, x, op: op_mod.Op = op_mod.SUM):
        # THE hot call of the framework (DP gradient sync): inline the state
        # check and skip the _coll indirection — one dict probe on the
        # per-comm vtable, then straight into the module fast path
        if self.freed or self.revoked:
            self._check_state()
        fn = self.c_coll.get("allreduce_array")
        if fn is None:
            return self._coll("allreduce_array")(self, x, op)  # raise path
        return fn(self, x, op)

    def bcast_array(self, x, root: int = 0):
        self._check_state()
        return self._coll("bcast_array")(self, x, root)

    def allgather_array(self, x):
        self._check_state()
        return self._coll("allgather_array")(self, x)

    def reduce_scatter_array(self, x, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("reduce_scatter_array")(self, x, op)

    def allgatherv_array(self, x, counts):
        self._check_state()
        return self._coll("allgatherv_array")(self, x, counts)

    def alltoallv_array(self, x, counts):
        self._check_state()
        return self._coll("alltoallv_array")(self, x, counts)

    def alltoall_array(self, x):
        self._check_state()
        return self._coll("alltoall_array")(self, x)

    def ppermute_array(self, x, perm):
        self._check_state()
        return self._coll("ppermute_array")(self, x, perm)

    # persistent collectives (MPI_Allreduce_init & friends) ----------------
    def coll_init(self, coll: str, template=None, *args):
        """Persistent collective (``ompi_tpu/api/comm.py:504-539``): a
        restartable request (``start()``/``wait()``/``.result``) whose every
        start re-runs the device collective bound at init on ``template``.
        The host branch (no template, or no device provider) needs the host
        tier, which is not ported yet: it raises
        ``MpiError(ERR_UNSUPPORTED_OPERATION)``."""
        self._check_state()
        from ompi_tpu_torch.api.request import PersistentP2P

        fn = self.c_coll.get("persistent_coll")
        if fn is None or template is None:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           f"no persistent binding for '{coll}' on "
                           f"{self.name}: host persistent collectives are "
                           "not ported yet")
        handle = fn(self, coll, template, *args)
        return PersistentP2P(lambda: handle.start(template))

    def allreduce_array_init(self, template, op: op_mod.Op = op_mod.SUM):
        """The persistent device allreduce as a bare callable handle
        (``h(x)``, ``h.start(x)``); ``coll_init`` wraps the same binding in
        the request interface."""
        fn = self.c_coll.get("persistent_coll")
        if fn is None:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           "no device persistent-collective provider on "
                           f"{self.name}")
        return fn(self, "allreduce", template, op)

    def release_coll_modules(self) -> None:
        """Tear down per-comm coll module state (runtime finalize)."""
        self.coll_modules = []
        self.c_coll = {}

    def __repr__(self) -> str:
        return (f"Comm({self.name}, cid={self.cid}, rank={self.rank}/"
                f"{self.size})")
