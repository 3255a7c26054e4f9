"""coll/inter — inter-communicator collectives (two-group protocol).

Copy of ``ompi_tpu/mca/coll/inter.py`` (after the reference's
``ompi/mca/coll/inter/``): an
intercommunicator collective involves two groups bridged by p2p between
their leaders — each side runs a LOCAL collective, the leaders exchange
over the bridge, and results fan back out locally.  MPI's intercomm
semantics carry over:

- ``allreduce``/``allgather``: each group receives the reduction /
  concatenation of the OTHER group's contributions.
- ``bcast``/``reduce``: rooted in ONE group — the root passes
  ``ROOT`` (MPI_ROOT), its group peers pass ``PROC_NULL``, and the other
  group passes the root's rank within the root's group.
- ``barrier``: both groups synchronize through the leaders.

Requires the intercomm to carry its local-side collective channel
(``local_comm``, set by dpm at bridge construction), exactly as the
reference requires ``c_local_comm``.  A tensor (on the card or not) is
staged to the host at a slot's entry through ``torch_acc.to_host``, as the
reference's ``np.ascontiguousarray`` stages a ``jax.Array``, and results
are numpy, as coll/basic's are.
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.status import PROC_NULL, ROOT
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.coll.basic import _host, coll_tag


class InterCollModule:
    def __init__(self) -> None:
        pass

    def _local(self, comm):
        local = getattr(comm, "local_comm", None)
        if local is None:
            raise MpiError(ErrorClass.ERR_COMM,
                           "intercomm has no local collective channel")
        return local

    def barrier(self, comm) -> None:
        tag = coll_tag(comm)
        local = self._local(comm)
        token = np.zeros(1, np.uint8)
        local.barrier()
        if local.rank == 0:
            # leaders handshake over the bridge (both directions)
            req = comm.isend(token, 0, tag)
            comm.recv(np.zeros(1, np.uint8), 0, tag)
            req.wait()
        local.barrier()

    def allreduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        """Each group receives the reduction of the OTHER group's data."""
        tag = coll_tag(comm)
        local = self._local(comm)
        arr = _host(sendbuf)
        mine = local.reduce(arr, op, root=0) if local.size > 1 else arr
        out = np.empty_like(arr)
        if local.rank == 0:
            req = comm.isend(np.ascontiguousarray(mine), 0, tag)
            comm.recv(out, 0, tag)
            req.wait()
        return np.asarray(local.bcast(out, root=0)).reshape(arr.shape)

    def allgather(self, comm, sendbuf):
        """Each group receives the concatenation of the OTHER group."""
        tag = coll_tag(comm)
        local = self._local(comm)
        arr = _host(sendbuf)
        g = local.gather(arr, root=0) if local.size > 1 else arr[None]
        out = np.empty((comm.remote_size, *arr.shape), arr.dtype)
        if local.rank == 0:
            req = comm.isend(np.ascontiguousarray(g), 0, tag)
            comm.recv(out, 0, tag)
            req.wait()
        return np.asarray(local.bcast(out, root=0))

    def bcast(self, comm, buf, root):
        """Rooted: root passes ROOT, root's peers PROC_NULL, the other
        group the root's rank in the remote group."""
        tag = coll_tag(comm)
        local = self._local(comm)
        arr = _host(buf)
        if root == PROC_NULL:
            return arr                      # root's group, non-root: no-op
        if root == ROOT:
            # I am the root: ship to the other group's leader
            comm.send(arr, 0, tag)
            return arr
        # receiving group: leader takes the bridge message, local bcast
        if local.rank == 0:
            got = np.empty_like(arr)
            comm.recv(got, root, tag)
        else:
            got = np.empty_like(arr)
        return np.asarray(local.bcast(got, root=0)).reshape(arr.shape)

    def reduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM, root=0):
        """Rooted: the root (passing ROOT) receives the reduction of the
        OTHER group's contributions."""
        tag = coll_tag(comm)
        local = self._local(comm)
        arr = _host(sendbuf)
        if root == ROOT:
            out = np.empty_like(arr)
            comm.recv(out, 0, tag)          # from the other group's leader
            return out
        if root == PROC_NULL:
            return None
        # contributing group: local reduce, leader ships to the root
        red = local.reduce(arr, op, root=0) if local.size > 1 else arr
        if local.rank == 0:
            comm.send(np.ascontiguousarray(red), root, tag)
        return None


class InterCollComponent(Component):
    name = "inter"
    priority = 45

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=45,
            help="Selection priority of coll/inter (intercomm collectives)")

    def comm_query(self, comm):
        if not comm.is_inter:
            return None
        if getattr(comm, "local_comm", None) is None:
            return None
        return self._prio.value, InterCollModule()


COMPONENT = InterCollComponent()
