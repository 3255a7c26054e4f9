"""coll/basic — naive linear algorithms over pml p2p, always available.

Copy of ``ompi_tpu/mca/coll/basic.py`` (after the reference's
``ompi/mca/coll/basic/``, priority 10, the fallback when nothing better
selects): linear fan-in/fan-out algorithms driven SPMD-style (each process
takes part with its own call) in the multi-process world.  Collective
traffic uses the internal (negative) tag space with a per-communicator
sequence so concurrent collectives on different comms can't cross-match —
the role the reference's separate collective context id plays.

Reductions fold in rank order, so non-commutative user ops are safe here.
A tensor given as a send buffer (on the card or not) is staged to the host
through ``torch_acc.to_host``, as the reference's ``np.asarray`` stages a
``jax.Array``; results are numpy, as the reference's are.
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.comm import host_buffer, is_tensor
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType

_TAG_BASE = 16
_TAG_SPACE = 1 << 20


def _host(buf) -> np.ndarray:
    """A contiguous host array of ``buf`` (a tensor is staged D2H)."""
    return np.ascontiguousarray(host_buffer(buf))


def staged(buf):
    """``buf`` with a tensor staged to the host (read-only numpy, as the
    reference's ``np.asarray`` of a ``jax.Array``); anything else as given.
    The host collective modules call it once, at a slot's entry."""
    return host_buffer(buf) if is_tensor(buf) else buf


def coll_tag(comm) -> int:
    """Next internal tag for one collective on this comm (ordered calls)."""
    seq = getattr(comm, "_coll_tag_seq", 0)
    comm._coll_tag_seq = seq + 1
    return -(_TAG_BASE + seq % _TAG_SPACE)


class BasicCollModule:
    # -- building blocks -------------------------------------------------
    def barrier(self, comm) -> None:
        tag = coll_tag(comm)
        token = np.zeros(1, np.uint8)
        if comm.rank == 0:
            for r in range(1, comm.size):
                comm.recv(np.zeros(1, np.uint8), source=r, tag=tag)
            for r in range(1, comm.size):
                comm.send(token, dest=r, tag=tag)
        else:
            comm.send(token, dest=0, tag=tag)
            comm.recv(np.zeros(1, np.uint8), source=0, tag=tag)

    def bcast(self, comm, buf, root=0):
        tag = coll_tag(comm)
        arr = _host(buf)
        if comm.rank == root:
            for r in range(comm.size):
                if r != root:
                    comm.send(arr, dest=r, tag=tag)
            return arr
        out = np.empty_like(arr)
        comm.recv(out, source=root, tag=tag)
        return out

    def gather(self, comm, sendbuf, root=0):
        tag = coll_tag(comm)
        arr = _host(sendbuf)
        if comm.rank == root:
            out = np.empty((comm.size, *arr.shape), arr.dtype)
            out[root] = arr
            for r in range(comm.size):
                if r != root:
                    # out[r:r+1] is always a view; out[r] would be a
                    # detached scalar for 1-elem rows and drop the data
                    comm.recv(out[r:r + 1], source=r, tag=tag)
            return out
        comm.send(arr, dest=root, tag=tag)
        return None

    def gatherv(self, comm, sendbuf, root=0):
        tag = coll_tag(comm)
        arr = _host(sendbuf).reshape(-1)
        sizes = self.gather(comm, np.array([arr.size], np.int64), root)
        if comm.rank == root:
            out = []
            for r in range(comm.size):
                if r == root:
                    out.append(arr)
                else:
                    buf = np.empty(int(sizes[r][0]), arr.dtype)
                    comm.recv(buf, source=r, tag=tag)
                    out.append(buf)
            return out
        comm.send(arr, dest=root, tag=tag)
        return None

    def scatter(self, comm, sendbuf, root=0):
        """Root passes the (size, ...) stack; non-roots pass a template
        array with their block's shape/dtype (the recvbuf spec MPI needs)."""
        tag = coll_tag(comm)
        if comm.rank == root:
            stack = _host(sendbuf)
            if stack.shape[0] != comm.size:
                raise ValueError("scatter needs (size, ...) on root")
            for r in range(comm.size):
                if r != root:
                    comm.send(np.ascontiguousarray(stack[r]), dest=r, tag=tag)
            return np.array(stack[root], copy=True)
        out = np.empty_like(_host(sendbuf))
        comm.recv(out, source=root, tag=tag)
        return out

    def allgather(self, comm, sendbuf):
        arr = _host(sendbuf)
        g = self.gather(comm, arr, 0)
        if comm.rank == 0:
            return self.bcast(comm, g, 0)
        return self.bcast(comm, np.empty((comm.size, *arr.shape), arr.dtype), 0)

    def allgatherv(self, comm, sendbuf):
        arr = _host(sendbuf).reshape(-1)
        sizes = self.allgather(comm, np.array([arr.size], np.int64))
        tag = coll_tag(comm)
        out = []
        reqs = []
        for r in range(comm.size):
            if r != comm.rank:
                reqs.append(comm.isend(arr, dest=r, tag=tag))
        for r in range(comm.size):
            if r == comm.rank:
                out.append(arr)
            else:
                buf = np.empty(int(sizes[r][0]), arr.dtype)
                comm.recv(buf, source=r, tag=tag)
                out.append(buf)
        from ompi_tpu_torch.api.request import waitall

        waitall(reqs)
        return out

    def alltoall(self, comm, sendbuf):
        tag = coll_tag(comm)
        stack = _host(sendbuf)
        if stack.shape[0] != comm.size:
            raise ValueError("alltoall needs (size, ...) per rank")
        out = np.empty_like(stack)
        out[comm.rank] = stack[comm.rank]
        reqs = []
        for r in range(comm.size):
            if r != comm.rank:
                reqs.append(comm.isend(np.ascontiguousarray(stack[r:r + 1]),
                                       dest=r, tag=tag))
        for r in range(comm.size):
            if r != comm.rank:
                comm.recv(out[r:r + 1], source=r, tag=tag)
        from ompi_tpu_torch.api.request import waitall

        waitall(reqs)
        return out

    def alltoallv(self, comm, sendbufs):
        """Received block from rank r is typed as ``sendbufs[r].dtype``
        — the symmetric-exchange contract every component returns
        (self_coll/conductor keep types trivially; the wire carries
        bytes and this view restores them).  Pairs exchanging DIFFERENT
        dtypes must use ``alltoallw`` with explicit ``recvtypes``, the
        exact split MPI itself makes (``ompi/mpi/c/alltoallw.c``)."""
        tag = coll_tag(comm)
        sendbufs = [_host(b) for b in sendbufs]
        reqs = []
        for r in range(comm.size):
            if r != comm.rank:
                reqs.append(comm.isend(sendbufs[r], dest=r, tag=tag))
        out = [None] * comm.size
        out[comm.rank] = sendbufs[comm.rank]
        for r in range(comm.size):
            if r != comm.rank:
                st = comm.probe(source=r, tag=tag)
                buf = np.empty(st._nbytes, np.uint8)
                comm.recv(buf, source=r, tag=tag)
                dt = sendbufs[r].dtype
                if buf.nbytes % max(1, dt.itemsize):
                    raise MpiError(
                        ErrorClass.ERR_TYPE,
                        f"alltoallv: peer {r} sent {buf.nbytes} bytes, "
                        f"not a multiple of this rank's send dtype {dt} "
                        f"(itemsize {dt.itemsize}) — alltoallv's contract "
                        "is a symmetric dtype per pair; use alltoallw "
                        "with explicit recvtypes for asymmetric-dtype "
                        "exchanges")
                out[r] = buf.view(dt)
        from ompi_tpu_torch.api.request import waitall

        waitall(reqs)
        return out

    def alltoallw(self, comm, sendbufs, recvtypes=None):
        """``MPI_Alltoallw``: per-peer buffers AND per-peer datatypes.

        ``sendbufs[i]`` (any dtype/shape each) goes to rank i;
        ``recvtypes[i]`` (numpy dtypes) types the block received from
        rank i (default uint8, the wire type).  The v-variant's
        byte-stream exchange already carries arbitrary layouts — the w
        semantics are the per-peer reinterpretation on both ends
        (``ompi/mpi/c/alltoallw.c``)."""
        raw = self.alltoallv(comm, sendbufs)
        if recvtypes is None:
            return raw
        out = []
        for i, b in enumerate(raw):
            arr = np.ascontiguousarray(b).reshape(-1).view(np.uint8)
            out.append(arr.view(np.dtype(recvtypes[i])))
        return out

    def reduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM, root=0):
        g = self.gather(comm, sendbuf, root)
        if comm.rank != root:
            return None
        # fold right-to-left so the op convention inout = in (op) inout
        # yields b0 (op) (b1 (op) (... bn-1)) — rank order preserved for
        # non-commutative ops
        acc = np.array(g[comm.size - 1], copy=True)
        for i in range(comm.size - 2, -1, -1):
            op(g[i], acc)
        return acc

    def allreduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        arr = _host(sendbuf)
        r = self.reduce(comm, arr, op, 0)
        if comm.rank == 0:
            return self.bcast(comm, r, 0)
        return self.bcast(comm, np.empty_like(arr), 0)

    def reduce_scatter(self, comm, sendbuf, recvcounts=None,
                       op: op_mod.Op = op_mod.SUM):
        total = self.allreduce(comm, sendbuf, op)
        n = comm.size
        if recvcounts is None:
            return np.array_split(total, n)[comm.rank]
        off = int(np.sum(recvcounts[:comm.rank]))
        return np.array(total[off:off + recvcounts[comm.rank]], copy=True)

    def scan(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        tag = coll_tag(comm)
        arr = np.array(_host(sendbuf), copy=True)
        if comm.rank > 0:
            prev = np.empty_like(arr)
            comm.recv(prev, source=comm.rank - 1, tag=tag)
            op(prev, arr)
        if comm.rank < comm.size - 1:
            comm.send(arr, dest=comm.rank + 1, tag=tag)
        return arr

    def exscan(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        tag = coll_tag(comm)
        arr = _host(sendbuf)
        out = np.zeros_like(arr)
        if comm.rank > 0:
            comm.recv(out, source=comm.rank - 1, tag=tag)
        if comm.rank < comm.size - 1:
            if comm.rank == 0:
                nxt = np.array(arr, copy=True)
            else:
                # nxt = out (op) arr, preserving rank order
                nxt = np.array(arr, copy=True)
                op(out, nxt)
            comm.send(nxt, dest=comm.rank + 1, tag=tag)
        return out

    def agree(self, comm, flag: int) -> int:
        out = self.allreduce(comm, np.array([flag], np.int64), op_mod.BAND)
        return int(out[0])

    # nonblocking wrappers (coll/libnbc's schedules take these slots) --
    def ibarrier(self, comm):
        from ompi_tpu_torch.api.request import CompletedRequest

        self.barrier(comm)
        return CompletedRequest()

    def iallreduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        from ompi_tpu_torch.api.request import CompletedRequest

        r = CompletedRequest()
        r.result = self.allreduce(comm, sendbuf, op)
        return r

    def ibcast(self, comm, buf, root=0):
        from ompi_tpu_torch.api.request import CompletedRequest

        r = CompletedRequest()
        r.result = self.bcast(comm, buf, root)
        return r


class BasicCollComponent(Component):
    name = "basic"
    priority = 10

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=10,
            help="Selection priority of coll/basic")

    def comm_query(self, comm):
        if comm.rte is not None and comm.rte.is_device_world:
            return None  # conductor model handles host collectives there
        if comm.size == 1 or comm.is_inter:
            return None  # intercomms take coll/inter's two-group protocol
        return self._prio.value, BasicCollModule()


COMPONENT = BasicCollComponent()
