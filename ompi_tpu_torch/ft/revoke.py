"""``MPIX_Comm_revoke`` (``ompi/communicator/ft/comm_ft_revoke.c``).

Copy of ``ompi_tpu/ft/revoke.py``.  Revocation is non-collective: any
member may revoke, and every other member must learn of it even while
blocked in unrelated operations.  The revoked ``(scope, cid, epoch)`` lands
in the global FT state that every communicator's ``_check_state`` probes,
and the propagator carries it to the other processes (event bus and p2p
flood).  In the device world it is a local fact of the one process.
"""
from __future__ import annotations

from ompi_tpu_torch.ft import propagator


def revoke(comm) -> None:
    comm.revoked = True
    propagator.report_revoke(comm.rte, comm.cid, comm.epoch,
                             job=comm.ft_scope)
