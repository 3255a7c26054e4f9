"""Communicators: group + CID + per-comm collective vtable.

Port of the device-world part of ``ompi_tpu/api/comm.py``: a communicator
owns its group, a context id and a per-comm collective vtable ``c_coll``
filled by the priority vote of the coll components
(``coll_base_comm_select.c``), and its info hints (an ``Info``; the
``otpu_quant_budget`` key arms coll/quant).  Every slot that no selected
module fills raises ``MpiError(ERR_UNSUPPORTED_OPERATION)``.

The collectives: the host entry points (numpy stacks with a leading rank
axis, or a device tensor, which coll/conductor forwards to the device
slot), their ``i*`` forms, the device-buffer ``*_array`` slots, ``agree``
and the persistent collectives (``allreduce_array_init``, ``coll_init``).
Construction, the device-world branch of each (one process acts for every
rank, so a CID is a local find-and-set): ``dup``, ``split``, ``create``,
``create_group``, ``compare``, ``free`` and ``as_rank``.  In the device
world ``split`` and ``create`` return the new comm that holds the
conductor's rank (world rank 0), or None where it holds none;
``as_rank(i)`` acts as rank i.  Not ported yet: ``split_type`` and
``create_from_group`` (the instance layer), topologies, error handlers,
attributes, point-to-point and fault tolerance beyond ``agree``.
"""
from __future__ import annotations

import copy
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError, RevokedError
from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.api.info import Info
from ompi_tpu_torch.api.request import CompletedRequest, Request

#: collective function slots a coll module can fill (the entry points of
#: ``ompi_tpu/api/comm.py:COLL_FUNCTIONS`` ported so far)
COLL_FUNCTIONS = (
    "barrier", "bcast", "gather", "gatherv", "scatter", "scatterv",
    "allgather", "allgatherv", "alltoall", "alltoallv", "alltoallw",
    "reduce", "allreduce", "reduce_scatter", "reduce_scatter_block",
    "scan", "exscan",
    "ibarrier", "ibcast", "igather", "iscatter", "iallgather", "ialltoall",
    "ireduce", "iallreduce", "ireduce_scatter", "iscan", "iexscan",
    "allreduce_array", "bcast_array", "allgather_array",
    "reduce_scatter_array", "alltoall_array", "ppermute_array",
    "psum_scatter_array", "reduce_array", "gather_array", "scatter_array",
    "allgatherv_array", "alltoallv_array", "scan_array", "exscan_array",
    "persistent_coll", "device_barrier", "agree")


class Comm:
    # comm_compare results (``mpi.h`` MPI_IDENT family)
    IDENT = 0
    CONGRUENT = 1
    SIMILAR = 2
    UNEQUAL = 3

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

    def world_rank(self, rank: int) -> int:
        return self.group.world_rank(rank)

    def as_rank(self, rank: int) -> "Comm":
        """Conductor-model facade: this communicator acting as ``rank``.

        In the device-world (single-controller) model the one process hosts
        every rank; ``as_rank(i).split(...)`` returns rank i's part of the
        split.  Shares all communicator state with self.
        """
        if not 0 <= rank < self.size:
            raise MpiError(ErrorClass.ERR_RANK, f"invalid rank {rank}")
        view = copy.copy(self)
        view._rank = rank
        return view

    def get_name(self) -> str:
        return self.name

    def set_name(self, name: str) -> None:
        self.name = name

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
        newcomm = Comm(self.group, self._next_cid(), self.rte,
                       name=f"{self.name}~dup")
        newcomm.info = self.info.dup()
        self._finish_create(newcomm)
        return newcomm

    def dup_with_info(self, info: Info) -> "Comm":
        """``MPI_Comm_dup_with_info``: dup, with the new comm's hints
        REPLACED by ``info`` instead of inherited."""
        newcomm = self.dup()
        newcomm.info = info.dup()
        return newcomm

    def compare(self, other: "Comm") -> int:
        """``MPI_Comm_compare``: IDENT (same object), CONGRUENT (same group
        and order, another context), SIMILAR (same members, another order),
        UNEQUAL."""
        if self is other:
            return Comm.IDENT
        mine = list(self.group.world_ranks)
        theirs = list(other.group.world_ranks)
        if mine == theirs:
            return Comm.CONGRUENT
        if sorted(mine) == sorted(theirs):
            return Comm.SIMILAR
        return Comm.UNEQUAL

    def split(self, color, key=0) -> Optional["Comm"]:
        """``MPI_Comm_split`` in the device world: ``color`` and ``key`` are
        scalars or ``(size,)`` arrays of per-rank values.  One CID per
        distinct non-negative color, allocated in sorted color order; the
        members of a color ordered by (key, rank).  Returns the new comm of
        this (facade) rank's color, or None for a color < 0
        (``MPI_UNDEFINED``)."""
        self._check_state()
        colors = np.broadcast_to(np.asarray(color, np.int64), (self.size,))
        keys = np.broadcast_to(np.asarray(key, np.int64), (self.size,))
        table = np.stack([colors, keys,
                          np.arange(self.size, dtype=np.int64)], 1)
        distinct = sorted({int(c) for c, _, _ in table if c >= 0})
        cids = {c: self._next_cid() for c in distinct}
        my_color = int(table[self.rank, 0])
        if my_color < 0:  # MPI_UNDEFINED
            return None
        members = sorted((int(k), int(r)) for c, k, r in table
                         if c == my_color)
        ranks = [self.group.world_rank(r) for _, r in members]
        newcomm = Comm(Group(ranks), cids[my_color], self.rte,
                       name=f"{self.name}~split")
        self._finish_create(newcomm)
        return newcomm

    def create(self, group: Group) -> Optional["Comm"]:
        """``MPI_Comm_create``: a CID is taken whether or not the
        conductor's rank is a member; None where it is not."""
        self._check_state()
        cid = self._next_cid()
        if group.rank_of(self.rte.my_world_rank) < 0:
            return None
        newcomm = Comm(group, cid, self.rte, name=f"{self.name}~create")
        self._finish_create(newcomm)
        return newcomm

    def create_group(self, group: Group, tag: int = 0) -> Optional["Comm"]:
        """``MPI_Comm_create_group``: non-collective over the parent; in the
        device world the CID is the local next one."""
        if group.rank_of(self.rte.my_world_rank) < 0:
            return None
        newcomm = Comm(group, self._next_cid(), self.rte,
                       name=f"{self.name}~create_group")
        self._finish_create(newcomm)
        return newcomm

    def _next_cid(self) -> int:
        """The next CID: one process backs every rank of the device world,
        so a local find-and-set is the agreement (``comm_cid.c:53``)."""
        from ompi_tpu_torch.runtime import init as rt

        return rt.next_local_cid()

    @staticmethod
    def _finish_create(newcomm: "Comm") -> None:
        """Every new comm: registered for finalize, then coll selection."""
        from ompi_tpu_torch.mca.coll.base import comm_select
        from ompi_tpu_torch.runtime import init as rt

        rt.register_comm(newcomm)
        comm_select(newcomm)

    def free(self) -> None:
        """``MPI_Comm_free``: release the coll modules and retire the CID
        (never reused).  A second free is a no-op."""
        if self.freed:
            return
        self.release_coll_modules()
        if self.cid > 1:
            from ompi_tpu_torch.runtime import init as rt

            rt.retire_cid(self.cid)
        self.freed = True

    def agree(self, flag: int) -> int:
        # NOT _check_state: ULFM's agreement is the recovery primitive and
        # must keep working on a revoked communicator
        if self.freed:
            raise MpiError(ErrorClass.ERR_COMM, "communicator was freed")
        return self._coll("agree")(self, flag)

    # blocking host collectives (numpy stacks with a leading rank axis) -----
    def barrier(self) -> None:
        self._check_state()
        self._coll("barrier")(self)

    def bcast(self, buf, root: int = 0):
        self._check_state()
        return self._coll("bcast")(self, buf, root)

    def reduce(self, sendbuf, op: op_mod.Op = op_mod.SUM, root: int = 0):
        self._check_state()
        return self._coll("reduce")(self, sendbuf, op, root)

    def allreduce(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("allreduce")(self, sendbuf, op)

    def gather(self, sendbuf, root: int = 0):
        self._check_state()
        return self._coll("gather")(self, sendbuf, root)

    def gatherv(self, sendbuf, root: int = 0):
        self._check_state()
        return self._coll("gatherv")(self, sendbuf, root)

    def scatter(self, sendbuf, root: int = 0):
        self._check_state()
        return self._coll("scatter")(self, sendbuf, root)

    def scatterv(self, sendbufs, root: int = 0):
        self._check_state()
        return self._coll("scatterv")(self, sendbufs, root)

    def allgather(self, sendbuf):
        self._check_state()
        return self._coll("allgather")(self, sendbuf)

    def allgatherv(self, sendbuf):
        self._check_state()
        return self._coll("allgatherv")(self, sendbuf)

    def alltoall(self, sendbuf):
        self._check_state()
        return self._coll("alltoall")(self, sendbuf)

    def alltoallv(self, sendbufs):
        """``MPI_Alltoallv``: ``sendbufs[r]`` goes to rank r."""
        self._check_state()
        return self._coll("alltoallv")(self, sendbufs)

    def alltoallw(self, sendbufs, recvtypes=None):
        """``MPI_Alltoallw``: per-peer buffers and per-peer datatypes
        (recvtypes: numpy dtype per source rank)."""
        self._check_state()
        return self._coll("alltoallw")(self, sendbufs, recvtypes)

    def reduce_scatter(self, sendbuf, recvcounts=None,
                       op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("reduce_scatter")(self, sendbuf, recvcounts, op)

    def reduce_scatter_block(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        """``MPI_Reduce_scatter_block``: equal-sized blocks — sendbuf has
        size*blockcount elements, each rank receives its reduced block; in
        the device world the whole table."""
        self._check_state()
        shape = np.shape(sendbuf)
        lead = shape[-1] if shape else 1
        n = self.size
        if lead % n:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"reduce_scatter_block needs length divisible by {n}, "
                f"got {lead}")
        out = self._coll("reduce_scatter")(self, sendbuf,
                                           [lead // n] * n, op)
        if isinstance(out, list) and len(out) == n:
            return np.stack(out)   # single-controller: the whole table
        return out

    def scan(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("scan")(self, sendbuf, op)

    def exscan(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("exscan")(self, sendbuf, op)

    # nonblocking variants ----------------------------------------------
    def ibarrier(self) -> Request:
        self._check_state()
        return self._coll("ibarrier")(self)

    def ibcast(self, buf, root: int = 0) -> Request:
        self._check_state()
        return self._coll("ibcast")(self, buf, root)

    def iallreduce(self, sendbuf, op: op_mod.Op = op_mod.SUM) -> Request:
        self._check_state()
        return self._coll("iallreduce")(self, sendbuf, op)

    def iallgather(self, sendbuf) -> Request:
        self._check_state()
        return self._coll("iallgather")(self, sendbuf)

    def ialltoall(self, sendbuf) -> Request:
        self._check_state()
        return self._coll("ialltoall")(self, sendbuf)

    def ireduce(self, sendbuf, op: op_mod.Op = op_mod.SUM,
                root: int = 0) -> Request:
        self._check_state()
        return self._coll("ireduce")(self, sendbuf, op, root)

    def _icompleted(self, fn, *args) -> Request:
        """Eager "nonblocking" form for slots without an overlapped
        schedule: runs the collective now and returns a born-complete
        request."""
        self._check_state()
        r = CompletedRequest()
        r.result = fn(*args)
        return r

    def _icoll(self, name: str, blocking, *args) -> Request:
        """Route to a module-provided nonblocking slot when one filled it;
        the eager completed-request form otherwise."""
        fn = self.c_coll.get(name)
        if fn is not None:
            self._check_state()
            return fn(self, *args)
        return self._icompleted(blocking, *args)

    def iscan(self, sendbuf, op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icoll("iscan", self.scan, sendbuf, op)

    def iexscan(self, sendbuf, op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icoll("iexscan", self.exscan, sendbuf, op)

    def igather(self, sendbuf, root: int = 0) -> Request:
        return self._icoll("igather", self.gather, sendbuf, root)

    def igatherv(self, sendbuf, root: int = 0) -> Request:
        return self._icompleted(self.gatherv, sendbuf, root)

    def iscatter(self, sendbuf, root: int = 0) -> Request:
        return self._icoll("iscatter", self.scatter, sendbuf, root)

    def iscatterv(self, sendbufs, root: int = 0) -> Request:
        return self._icompleted(self.scatterv, sendbufs, root)

    def iallgatherv(self, sendbuf) -> Request:
        return self._icompleted(self.allgatherv, sendbuf)

    def ialltoallv(self, sendbufs) -> Request:
        return self._icompleted(self.alltoallv, sendbufs)

    def ialltoallw(self, sendbufs, recvtypes=None) -> Request:
        return self._icompleted(self.alltoallw, sendbufs, recvtypes)

    def ireduce_scatter(self, sendbuf, recvcounts=None,
                        op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icoll("ireduce_scatter", self.reduce_scatter,
                           sendbuf, recvcounts, op)

    def ireduce_scatter_block(self, sendbuf,
                              op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icompleted(self.reduce_scatter_block, sendbuf, op)

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

    def reduce_array(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        self._check_state()
        return self._coll("reduce_array")(self, x, op, root)

    def gather_array(self, x, root: int = 0):
        self._check_state()
        return self._coll("gather_array")(self, x, root)

    def scatter_array(self, x, root: int = 0):
        self._check_state()
        return self._coll("scatter_array")(self, x, root)

    def scan_array(self, x, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("scan_array")(self, x, op)

    def exscan_array(self, x, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("exscan_array")(self, x, op)

    # persistent collectives (MPI_Allreduce_init & friends) ----------------
    #: blocking collectives coll_init may bind (MPI_*_init set)
    _PCOLL_NAMES = frozenset({
        "barrier", "bcast", "reduce", "allreduce", "gather", "gatherv",
        "scatter", "scatterv", "allgather", "allgatherv", "alltoall",
        "alltoallv", "alltoallw", "reduce_scatter",
        "reduce_scatter_block", "scan", "exscan"})

    def coll_init(self, coll: str, template=None, *args):
        """Persistent collective (``ompi_tpu/api/comm.py:498-539``): a
        restartable request (``start()``/``wait()``/``.result``).  With a
        template and a device provider each start re-runs the device
        collective bound at init on ``template``; otherwise (``template=None``
        binds zero-argument collectives, barrier) each start re-runs the
        blocking collective ``coll`` of ``_PCOLL_NAMES`` with the init's
        arguments."""
        self._check_state()
        from ompi_tpu_torch.api.request import PersistentP2P

        fn = self.c_coll.get("persistent_coll")
        if fn is not None and template is not None:
            handle = fn(self, coll, template, *args)
            return PersistentP2P(lambda: handle.start(template))
        if coll not in self._PCOLL_NAMES:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           f"no persistent binding for '{coll}'")
        blocking = getattr(self, coll)
        call_args = () if template is None and not args \
            else (template, *args)

        def start():
            r = CompletedRequest()
            r.result = blocking(*call_args)
            return r

        return PersistentP2P(start)

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
        """Tear down per-comm coll module state (``free``, and runtime
        finalize for the comms the user never frees)."""
        self.coll_modules = []
        self.c_coll = {}

    def __repr__(self) -> str:
        return (f"Comm({self.name}, cid={self.cid}, rank={self.rank}/"
                f"{self.size})")
