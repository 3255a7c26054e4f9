"""coll/self_coll — trivial host collectives for size-1 communicators.

Port of ``ompi_tpu/mca/coll/self_coll.py`` (the reference's
``ompi/mca/coll/self/``), priority 75: COMM_SELF and any split that leaves
one rank.  The device slots of such a comm stay with coll/builtin (and
coll/ring when raised), over a world of one row.
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.api.request import CompletedRequest
from ompi_tpu_torch.base.mca import Component


class SelfCollModule:
    def barrier(self, comm) -> None:
        pass

    def bcast(self, comm, buf, root=0):
        return np.asarray(buf)

    def reduce(self, comm, sendbuf, op, root=0):
        return np.array(np.asarray(sendbuf), copy=True)

    def allreduce(self, comm, sendbuf, op):
        return np.array(np.asarray(sendbuf), copy=True)

    def gather(self, comm, sendbuf, root=0):
        return np.asarray(sendbuf)[None, ...]

    def gatherv(self, comm, sendbuf, root=0):
        return [np.asarray(sendbuf)]

    def scatter(self, comm, sendbuf, root=0):
        return np.asarray(sendbuf)[0]

    def scatterv(self, comm, sendbufs, root=0):
        return np.asarray(sendbufs[0])

    def allgather(self, comm, sendbuf):
        return np.asarray(sendbuf)[None, ...]

    def allgatherv(self, comm, sendbuf):
        return [np.asarray(sendbuf)]

    def alltoall(self, comm, sendbuf):
        return np.array(np.asarray(sendbuf), copy=True)

    def alltoallv(self, comm, sendbufs):
        return [np.asarray(b) for b in sendbufs]

    def reduce_scatter(self, comm, sendbuf, recvcounts, op):
        return np.array(np.asarray(sendbuf), copy=True)

    def scan(self, comm, sendbuf, op):
        return np.array(np.asarray(sendbuf), copy=True)

    def exscan(self, comm, sendbuf, op):
        return np.zeros_like(np.asarray(sendbuf))

    def ibarrier(self, comm):
        return CompletedRequest()

    def ibcast(self, comm, buf, root=0):
        r = CompletedRequest()
        r.result = np.asarray(buf)
        return r

    def iallreduce(self, comm, sendbuf, op):
        r = CompletedRequest()
        r.result = self.allreduce(comm, sendbuf, op)
        return r

    def agree(self, comm, flag: int) -> int:
        return int(flag)


class SelfCollComponent(Component):
    name = "self_coll"
    priority = 75

    def comm_query(self, comm):
        if comm.size == 1:
            return self.priority, SelfCollModule()
        return None


COMPONENT = SelfCollComponent()
