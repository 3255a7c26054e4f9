"""coll/conductor — host-buffer collectives for the device-world model.

Port of ``ompi_tpu/mca/coll/conductor.py`` (priority 40).  In the
single-controller world every rank's host contribution already lives in
this process, so host collectives are direct computations.  Data model: the
leading axis of ``sendbuf`` indexes ranks (``sendbuf[i]`` is rank i's
contribution).  Host buffers (numpy, or anything ``np.asarray`` takes) fold
with the ops' numpy host kernels, right to left in rank order, so a
non-commutative user op sees its operands in rank order.

Device buffers (torch tensors, ``accelerator/torch_acc.is_device_array``)
passed to the host entry points are forwarded to the device slots: bcast,
allreduce, allgather, alltoall, reduce_scatter, scan and exscan to their
``*_array`` slot; reduce to the replicated allreduce and gather to the
replicated allgather (root's recvbuf is this process's result); scatter to
the device module's ``reshard``.  The reference stages a ``jax.Array``
given to scan or exscan to the host and folds it there in rank order; the
port keeps a tensor where it lies and scans it along the device slot's
combine tree, so a float SUM may differ from the reference's in its last
bits.  The ``i*`` forms are born complete; ``agree`` is the bitwise AND of
the flags.
Size-1 communicators go to coll/self_coll.
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.comm import is_tensor
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.request import CompletedRequest
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType


def _fold(op: op_mod.Op, stack: np.ndarray) -> np.ndarray:
    """Reduce over the leading (rank) axis with an MPI op.

    Folds right-to-left: with the op convention inout = in (op) inout this
    yields b0 (op) (b1 (op) (... bn-1)), preserving rank order for
    non-commutative user ops.
    """
    n = stack.shape[0]
    acc = np.array(stack[n - 1], copy=True)
    for i in range(n - 2, -1, -1):
        op(stack[i], acc)
    return acc


def _completed(result=None) -> CompletedRequest:
    r = CompletedRequest()
    r.result = result
    return r


class ConductorModule:
    def __init__(self, comm) -> None:
        pass

    _is_device = staticmethod(is_tensor)

    # -- blocking host collectives --------------------------------------
    def barrier(self, comm) -> None:
        fn = comm.c_coll.get("device_barrier")
        if fn is not None:
            fn(comm)

    def bcast(self, comm, buf, root=0):
        if self._is_device(buf):
            return comm.c_coll["bcast_array"](comm, buf, root)
        return np.asarray(buf)

    def reduce(self, comm, sendbuf, op, root=0):
        if self._is_device(sendbuf):
            # single-controller: root's recvbuf is this process's result, so
            # the replicated allreduce IS the reduce (root row masking is
            # the reduce_array slot's business)
            return comm.c_coll["allreduce_array"](comm, sendbuf, op)
        return _fold(op, self._stack(comm, sendbuf))

    def allreduce(self, comm, sendbuf, op):
        if self._is_device(sendbuf):
            return comm.c_coll["allreduce_array"](comm, sendbuf, op)
        return _fold(op, self._stack(comm, sendbuf))

    def gather(self, comm, sendbuf, root=0):
        if self._is_device(sendbuf):
            # single-controller: the replicated allgather is root's recvbuf
            return comm.c_coll["allgather_array"](comm, sendbuf)
        return np.array(self._stack(comm, sendbuf), copy=True)

    def gatherv(self, comm, sendbuf, root=0):
        return [np.asarray(b) for b in sendbuf]

    def scatter(self, comm, sendbuf, root=0):
        if self._is_device(sendbuf):
            # single-controller: root's (n, *S) buffer scattered over the
            # ranks is a resharding into the row-per-rank layout
            xm = next((m for m in getattr(comm, "coll_modules", ())
                       if hasattr(m, "reshard")), None)
            if xm is None:
                raise MpiError(
                    ErrorClass.ERR_UNSUPPORTED_OPERATION,
                    "device-buffer scatter needs a device coll module")
            return xm.reshard(sendbuf)
        return np.array(self._stack(comm, sendbuf), copy=True)

    def scatterv(self, comm, sendbufs, root=0):
        return [np.asarray(b) for b in sendbufs]

    def allgather(self, comm, sendbuf):
        if self._is_device(sendbuf):
            return comm.c_coll["allgather_array"](comm, sendbuf)
        return np.array(self._stack(comm, sendbuf), copy=True)

    def allgatherv(self, comm, sendbuf):
        return [np.asarray(b) for b in sendbuf]

    def alltoall(self, comm, sendbuf):
        if self._is_device(sendbuf):
            return comm.c_coll["alltoall_array"](comm, sendbuf)
        stack = self._stack(comm, sendbuf)
        if stack.ndim < 2 or stack.shape[1] != comm.size:
            raise ValueError("alltoall needs shape (size, size, ...)")
        return np.array(np.swapaxes(stack, 0, 1), copy=True)

    def alltoallv(self, comm, sendbufs):
        n = comm.size
        return [[np.asarray(sendbufs[j][i]) for j in range(n)]
                for i in range(n)]

    def alltoallw(self, comm, sendbufs, recvtypes=None):
        """Matrix form like alltoallv; ``recvtypes[i]`` retypes rank i's
        received blocks (single dtype or one per source)."""
        out = self.alltoallv(comm, sendbufs)
        if recvtypes is None:
            return out
        typed = []
        for i, row in enumerate(out):
            rt = recvtypes[i]
            per_src = list(rt) if isinstance(rt, (list, tuple)) \
                else [rt] * comm.size
            typed.append([
                np.ascontiguousarray(b).reshape(-1).view(np.uint8)
                .view(np.dtype(per_src[j])) for j, b in enumerate(row)])
        return typed

    def reduce_scatter(self, comm, sendbuf, recvcounts, op):
        if self._is_device(sendbuf):
            return comm.c_coll["reduce_scatter_array"](comm, sendbuf, op)
        stack = self._stack(comm, sendbuf)
        total = _fold(op, stack)
        n = comm.size
        if recvcounts is None:
            return np.array(np.split(total, n), copy=True)
        out, off = [], 0
        for c in recvcounts:
            out.append(np.array(total[off:off + c], copy=True))
            off += c
        return out

    def scan(self, comm, sendbuf, op):
        if self._is_device(sendbuf):
            return comm.c_coll["scan_array"](comm, sendbuf, op)
        stack = self._stack(comm, sendbuf)
        out = np.array(stack, copy=True)
        for i in range(1, out.shape[0]):
            op(out[i - 1], out[i])
        return out

    def exscan(self, comm, sendbuf, op):
        if self._is_device(sendbuf):
            return comm.c_coll["exscan_array"](comm, sendbuf, op)
        inc = self.scan(comm, sendbuf, op)
        out = np.zeros_like(inc)
        out[1:] = inc[:-1]
        return out

    # nonblocking: host computation is immediate in conductor mode -------
    def ibarrier(self, comm):
        self.barrier(comm)
        return CompletedRequest()

    def ibcast(self, comm, buf, root=0):
        return _completed(self.bcast(comm, buf, root))

    def iallreduce(self, comm, sendbuf, op):
        return _completed(self.allreduce(comm, sendbuf, op))

    def iallgather(self, comm, sendbuf):
        return _completed(self.allgather(comm, sendbuf))

    def ialltoall(self, comm, sendbuf):
        return _completed(self.alltoall(comm, sendbuf))

    def ireduce(self, comm, sendbuf, op, root=0):
        return _completed(self.reduce(comm, sendbuf, op, root))

    def agree(self, comm, flag: int) -> int:
        # single controller: agreement over live ranks is local (bitwise AND)
        flags = np.atleast_1d(np.asarray(flag, dtype=np.int64))
        return int(np.bitwise_and.reduce(flags))

    # helpers ------------------------------------------------------------
    def _stack(self, comm, sendbuf) -> np.ndarray:
        from ompi_tpu_torch.mca.accelerator import torch_acc

        arr = torch_acc.to_host(sendbuf)
        if arr.ndim == 0 or arr.shape[0] != comm.size:
            raise ValueError(
                f"conductor collectives need a leading rank axis of size "
                f"{comm.size}; got shape {arr.shape}")
        return arr


class ConductorComponent(Component):
    name = "conductor"
    priority = 40

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=40,
            help="Selection priority of coll/conductor (host-buffer "
                 "collectives of the device world)")

    def comm_query(self, comm):
        if comm.rte is None or not comm.rte.is_device_world:
            return None
        if comm.size == 1:
            return None  # self_coll handles it
        return self._prio.value, ConductorModule(comm)


COMPONENT = ConductorComponent()
