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
``as_rank(i)`` acts as rank i.  In the multi-process world (``tpurun``)
a CID is agreed over the comm (``_next_cid``, ``comm_cid.c:53``) and
``split`` exchanges the (color, key) table with an allgather.

Point-to-point (``ompi_tpu/api/comm.py:563-805``) dispatches to the
selected pml module as ``MPI_Send`` does (``ompi/mpi/c/send.c:93`` →
``MCA_PML_CALL``): the send modes, their persistent forms, ``sendrecv``,
the probe family and the object forms.  A tensor given as a buffer is
staged through ``torch_acc.to_host`` (the reference's ``np.asarray`` of a
``jax.Array``); as a receive buffer it is read-only there, as
``np.asarray`` of a ``jax.Array`` is, so the delivery raises ValueError.
Error handlers (``comm.py:195-203``): a comm starts with
ERRORS_ARE_FATAL, a comm made from it inherits its handler, and
``call_errhandler`` invokes it.  ``idup`` is the dup with a request born
complete (``comm.py:948``).  Not ported yet: ``split_type`` and
``create_from_group`` (the instance layer), the partitioned forms
(``mca/part``), topologies, attributes, intercommunicators and fault
tolerance beyond ``agree``.
"""
from __future__ import annotations

import copy
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errhandler import ERRORS_ARE_FATAL, Errhandler
from ompi_tpu_torch.api.errors import ErrorClass, MpiError, RevokedError
from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.api.info import Info
from ompi_tpu_torch.api.request import CompletedRequest, Request
from ompi_tpu_torch.api.status import ANY_SOURCE, ANY_TAG, PROC_NULL, Status
from ompi_tpu_torch.datatype import Datatype, from_numpy_dtype

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

_torch_acc = None


def host_buffer(buf) -> np.ndarray:
    """A buffer as numpy: a tensor goes through ``torch_acc.to_host`` (on
    the card, a D2H copy) and comes back read-only, as ``np.asarray`` of a
    ``jax.Array`` does in the reference (point-to-point and coll/basic)."""
    if isinstance(buf, np.ndarray):
        return buf
    global _torch_acc
    if _torch_acc is None:
        from ompi_tpu_torch.mca.accelerator import torch_acc

        _torch_acc = torch_acc
    if _torch_acc.is_device_array(buf):
        arr = _torch_acc.to_host(buf)
        arr.flags.writeable = False
        return arr
    return np.asarray(buf)


def as_buffer(buf) -> tuple[np.ndarray, int, Datatype]:
    """Normalize a user buffer to (ndarray, count, datatype).

    Accepts an ndarray or a tensor (count/type inferred), or an explicit
    ``(buffer, count, Datatype)`` triple for derived layouts.
    """
    if isinstance(buf, tuple):
        arr, count, dt = buf
        return host_buffer(arr), count, dt
    arr = host_buffer(buf)
    return arr, arr.size, from_numpy_dtype(arr.dtype)


class Comm:
    # comm_compare results (``mpi.h`` MPI_IDENT family)
    IDENT = 0
    CONGRUENT = 1
    SIMILAR = 2
    UNEQUAL = 3
    #: the port has no intercommunicators yet; the coll components' queries
    #: read this flag as the reference's do
    is_inter = False

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
        self.pml = None           # selected pml module (set at creation)
        self.errhandler: Errhandler = ERRORS_ARE_FATAL
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

    def set_errhandler(self, eh: Errhandler) -> None:
        self.errhandler = eh

    def get_errhandler(self) -> Errhandler:
        return self.errhandler

    def call_errhandler(self, errorcode) -> None:
        """``MPI_Comm_call_errhandler`` (the fatal default handler aborts,
        ERRORS_RETURN raises the MpiError to the caller)."""
        try:
            cls = ErrorClass(int(errorcode))
        except ValueError:
            cls = ErrorClass.ERR_OTHER
        self._err(MpiError(cls, f"user-raised code {int(errorcode)}"))

    def _err(self, error: MpiError) -> None:
        self.errhandler.invoke(self, error)
        raise error  # ERRORS_RETURN handler already raised; fatal aborts

    def _check_state(self, peer: Optional[int] = None) -> None:
        # NOTE: allreduce_array inlines the peer=None predicate on its
        # fast path
        if self.freed:
            raise MpiError(ErrorClass.ERR_COMM, "communicator was freed")
        if self.revoked:
            raise RevokedError(f"{self.name} revoked")
        if peer is not None and peer not in (ANY_SOURCE, PROC_NULL):
            if not 0 <= peer < self.size:
                raise MpiError(ErrorClass.ERR_RANK, f"invalid rank {peer}")

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

    def idup(self) -> tuple["Comm", Request]:
        """``MPI_Comm_idup``: the dup itself is collective-synchronous
        here (CID agreement), so the request is born complete."""
        newcomm = self.dup()
        req = CompletedRequest()
        req.result = newcomm
        return newcomm, req

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
        """``MPI_Comm_split``.  Device world: ``color`` and ``key`` are
        scalars or ``(size,)`` arrays of per-rank values.  Multi-process
        world: each rank passes its own, and the table is exchanged with an
        allgather over the parent.  One CID per distinct non-negative color,
        allocated in sorted color order; the members of a color ordered by
        (key, rank).  Returns the new comm of this (facade) rank's color,
        or None for a color < 0 (``MPI_UNDEFINED``)."""
        self._check_state()
        if self.rte is not None and self.rte.is_device_world:
            colors = np.broadcast_to(np.asarray(color, np.int64),
                                     (self.size,))
            keys = np.broadcast_to(np.asarray(key, np.int64), (self.size,))
            table = np.stack([colors, keys,
                              np.arange(self.size, dtype=np.int64)], 1)
        else:
            mine = np.array([color, key, self.rank], dtype=np.int64)
            table = np.asarray(self.allgather(mine)).reshape(self.size, 3)
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
        """``MPI_Comm_create_group``: non-collective over the parent; only
        group members take part.  In the device world the CID is the local
        next one; otherwise the members agree on it over parent p2p on a
        reserved tag."""
        if group.rank_of(self.rte.my_world_rank) < 0:
            return None
        if self.rte is not None and self.rte.is_device_world:
            from ompi_tpu_torch.runtime import init as rt

            cid = rt.next_local_cid()
        else:
            cid = self._agree_cid_group(group, tag)
        newcomm = Comm(group, cid, self.rte,
                       name=f"{self.name}~create_group")
        self._finish_create(newcomm)
        return newcomm

    def _next_cid(self) -> int:
        """Agree on the next free CID across members (``comm_cid.c:53``).

        One process backs every rank of the device world, so a local
        find-and-set is the agreement there.  Otherwise multi-round, as the
        reference: each member proposes its first locally-free id
        (unreserved), the group takes the MAX, then a second allreduce
        confirms the winner is free on every member; on a conflict,
        re-propose above it."""
        from ompi_tpu_torch.runtime import init as rt

        if self.rte is not None and self.rte.is_device_world:
            return rt.next_local_cid()
        floor = 0
        while True:
            local = rt.candidate_cid(floor)
            agreed = int(np.asarray(self.allreduce(
                np.array([local], dtype=np.int64), op_mod.MAX)).ravel()[0])
            ok = 1 if rt.is_cid_free(agreed) else 0
            all_ok = int(np.asarray(self.allreduce(
                np.array([ok], dtype=np.int64), op_mod.MIN)).ravel()[0])
            if all_ok:
                rt.reserve_cid(agreed)
                return agreed
            floor = agreed + 1

    def _agree_cid_group(self, group: Group, tag: int) -> int:
        """Multi-round CID agreement among group members via parent p2p
        (``ompi_tpu/api/comm.py:_agree_cid_group``)."""
        from ompi_tpu_torch.runtime import init as rt

        members = [self.group.rank_of(w) for w in group.world_ranks]
        leader = members[0]
        t = -(1 << 20) - tag  # reserved internal tag space

        def xchg(value: int, combine) -> int:
            if self.rank == leader:
                acc = value
                got = np.zeros(1, dtype=np.int64)
                for m in members[1:]:
                    self.recv(got, m, t)
                    acc = combine(acc, int(got[0]))
                out = np.array([acc], dtype=np.int64)
                for m in members[1:]:
                    self.send(out, m, t)
                return acc
            self.send(np.array([value], dtype=np.int64), leader, t)
            got = np.zeros(1, dtype=np.int64)
            self.recv(got, leader, t)
            return int(got[0])

        floor = 0
        while True:
            agreed = xchg(rt.candidate_cid(floor), max)
            all_ok = xchg(1 if rt.is_cid_free(agreed) else 0, min)
            if all_ok:
                rt.reserve_cid(agreed)
                return agreed
            floor = agreed + 1

    def _finish_create(self, newcomm: "Comm") -> None:
        """Every new comm (``_wire_new_comm``, ``comm.py:1095``): registered
        for finalize, the parent's pml attached, then coll selection."""
        from ompi_tpu_torch.mca.coll.base import comm_select
        from ompi_tpu_torch.runtime import init as rt

        rt.register_comm(newcomm)
        newcomm.errhandler = self.errhandler
        newcomm.pml = self.pml
        if self.pml is not None:
            self.pml.add_comm(newcomm)
        comm_select(newcomm)

    def free(self) -> None:
        """``MPI_Comm_free``: release the coll modules, drop the pml's
        matching state and retire the CID (never reused).  A second free is
        a no-op."""
        if self.freed:
            return
        self.release_coll_modules()
        if self.pml is not None:
            self.pml.del_comm(self)
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

    # -- p2p dispatch (→ selected pml, like MCA_PML_CALL) ---------------
    def send(self, buf, dest: int, tag: int = 0) -> None:
        self._check_state(dest)
        if dest == PROC_NULL:
            return
        self.pml.send(self, buf, dest, tag)

    def recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
        self._check_state(source)
        if source == PROC_NULL:
            return Status(source=PROC_NULL, tag=ANY_TAG)
        return self.pml.recv(self, buf, source, tag)

    def isend(self, buf, dest: int, tag: int = 0) -> Request:
        self._check_state(dest)
        if dest == PROC_NULL:
            return CompletedRequest()
        return self.pml.isend(self, buf, dest, tag)

    def irecv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Request:
        self._check_state(source)
        if source == PROC_NULL:
            return CompletedRequest(Status(source=PROC_NULL, tag=ANY_TAG))
        return self.pml.irecv(self, buf, source, tag)

    def ssend(self, buf, dest: int, tag: int = 0) -> None:
        """``MPI_Ssend``: returns only after the receiver matched."""
        self.issend(buf, dest, tag).wait()

    def issend(self, buf, dest: int, tag: int = 0) -> Request:
        self._check_state(dest)
        if dest == PROC_NULL:
            return CompletedRequest()
        return self.pml.isend(self, buf, dest, tag, sync=True)

    def rsend(self, buf, dest: int, tag: int = 0) -> None:
        """``MPI_Rsend``: with a posted recv it behaves exactly like send
        (MPI guarantees nothing extra), so it shares the standard path, as
        pml/ob1 does."""
        self.send(buf, dest, tag)

    def irsend(self, buf, dest: int, tag: int = 0) -> Request:
        return self.isend(buf, dest, tag)

    def bsend(self, buf, dest: int, tag: int = 0) -> None:
        """``MPI_Bsend``: copies into the attached buffer space and
        returns; the user's buffer is reusable on return."""
        self.ibsend(buf, dest, tag)   # ibsend is already locally complete

    def ibsend(self, buf, dest: int, tag: int = 0) -> Request:
        from ompi_tpu_torch.api import buffer as _bsend

        self._check_state(dest)
        if dest == PROC_NULL:
            return CompletedRequest()
        arr = np.ascontiguousarray(host_buffer(buf))
        _bsend.claim(arr.nbytes)
        try:
            inner = self.pml.isend(self, arr.copy(), dest, tag)
        except Exception:
            _bsend.release(arr.nbytes)   # claim must not leak
            raise
        _bsend.track(inner, arr.nbytes)
        # buffered semantics: the returned request is LOCALLY complete;
        # only Buffer_detach waits for the real delivery (a
        # rendezvous-size inner request must not leak to the caller, or a
        # bsend-then-wait-then-recv pair would deadlock)
        return CompletedRequest()

    # -- persistent point-to-point (``MPI_Send_init``/``Recv_init``) ----
    def send_init(self, buf, dest: int, tag: int = 0) -> Request:
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(dest)
        if dest == PROC_NULL:
            return PersistentP2P(CompletedRequest)
        return PersistentP2P(lambda: self.pml.isend(self, buf, dest, tag))

    def ssend_init(self, buf, dest: int, tag: int = 0) -> Request:
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(dest)
        if dest == PROC_NULL:
            return PersistentP2P(CompletedRequest)
        return PersistentP2P(
            lambda: self.pml.isend(self, buf, dest, tag, sync=True))

    def bsend_init(self, buf, dest: int, tag: int = 0) -> Request:
        """``MPI_Bsend_init``: every start() claims attach-buffer space and
        completes locally."""
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(dest)
        return PersistentP2P(lambda: self.ibsend(buf, dest, tag))

    def rsend_init(self, buf, dest: int, tag: int = 0) -> Request:
        """``MPI_Rsend_init``: ready mode shares the standard path."""
        return self.send_init(buf, dest, tag)

    def recv_init(self, buf, source: int = ANY_SOURCE,
                  tag: int = ANY_TAG) -> Request:
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(source)
        if source == PROC_NULL:
            return PersistentP2P(
                lambda: CompletedRequest(Status(source=PROC_NULL, tag=ANY_TAG)))
        return PersistentP2P(lambda: self.pml.irecv(self, buf, source, tag))

    def sendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                         sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
        """``MPI_Sendrecv_replace``: the received message overwrites the
        sent buffer (staged through a copy, like the reference).  ``buf``
        must be a writable ndarray."""
        if not isinstance(buf, np.ndarray) or not buf.flags.writeable:
            raise MpiError(ErrorClass.ERR_BUFFER,
                           "sendrecv_replace needs a writable ndarray")
        arr = np.ascontiguousarray(buf)
        st = self.sendrecv(arr.copy(), dest, arr, source, sendtag, recvtag)
        if buf is not arr:
            np.copyto(buf, arr)
        return st

    def sendrecv(self, sendbuf, dest: int, recvbuf, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
        self._check_state(dest)
        sreq = self.isend(sendbuf, dest, sendtag) if dest != PROC_NULL else None
        st = self.recv(recvbuf, source, recvtag)
        if sreq is not None:
            sreq.wait()
        return st

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
        self._check_state(source)
        return self.pml.probe(self, source, tag, blocking=True)

    def iprobe(self, source: int = ANY_SOURCE,
               tag: int = ANY_TAG) -> tuple[bool, Optional[Status]]:
        self._check_state(source)
        return self.pml.probe(self, source, tag, blocking=False)

    def mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check_state(source)
        return self.pml.mprobe(self, source, tag, blocking=True)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check_state(source)
        return self.pml.mprobe(self, source, tag, blocking=False)

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        from ompi_tpu_torch.api.request import waitall

        waitall(self.isend_obj(obj, dest, tag))

    def isend_obj(self, obj: Any, dest: int, tag: int = 0) -> list:
        """Nonblocking ``send_obj``: returns the requests to waitall (they
        keep the payload buffer alive)."""
        import pickle

        payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        hdr = np.array([payload.size], dtype=np.int64)
        return [self.isend(hdr, dest, tag), self.isend(payload, dest, tag)]

    def bcast_obj(self, obj: Any = None, root: int = 0) -> Any:
        """Broadcast an arbitrary picklable object (size agreed first)."""
        import pickle

        if self.rank == root:
            payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
            self.bcast(np.array([payload.size], np.int64), root=root)
            self.bcast(payload, root=root)
            return obj
        hdr = np.asarray(self.bcast(np.zeros(1, np.int64), root=root))
        payload = np.asarray(self.bcast(
            np.zeros(int(hdr[0]), np.uint8), root=root))
        return pickle.loads(payload.tobytes())

    def recv_obj(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Any:
        import pickle

        hdr = np.zeros(1, dtype=np.int64)
        st = self.recv(hdr, source, tag)
        payload = np.zeros(int(hdr[0]), dtype=np.uint8)
        self.recv(payload, st.source, tag)
        return pickle.loads(payload.tobytes())

    def release_coll_modules(self) -> None:
        """Tear down per-comm coll module state (``free``, and runtime
        finalize for the comms the user never frees): each module's
        ``comm_unquery`` runs (coll/han frees its sub-communicators), as
        the reference's ``release_coll_modules`` does."""
        for mod in self.coll_modules:
            close = getattr(mod, "comm_unquery", None)
            if close is not None:
                try:
                    close(self)
                except Exception:
                    pass
        self.coll_modules = []
        self.c_coll = {}

    def __repr__(self) -> str:
        return (f"Comm({self.name}, cid={self.cid}, rank={self.rank}/"
                f"{self.size})")
