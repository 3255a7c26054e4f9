"""part — MPI-4 partitioned point-to-point communication framework.

Copy of ``ompi_tpu/mca/part/__init__.py`` (after the reference's
``ompi/mca/part/``).  Partitioned communication splits one persistent
transfer into application-visible partitions: ``Psend_init``/``Precv_init``
build a reusable request, ``MPI_Start`` activates an epoch, the sender
releases individual partitions with ``Pready``/``Pready_range``/
``Pready_list`` as their data is produced, and the receiver observes
per-partition arrival with ``Parrived``.  It is the MPI feature behind
bucketed gradient overlap: per-partition readiness lets communication of
finished shards proceed while the rest are still being computed.

The single built-in component is ``persist``: ready partitions are mapped
onto ordinary pml/ob1 messages (so the eager/RNDV/RGET ladder, striping and
the FT semantics all apply), with N app partitions travelling as fewer wire
messages under the ``otpu_part_persist_min_partitions`` aggregation var.
Receive-side arrival tracking is byte-framed, so mismatched send/receive
partition counts pair correctly as MPI-4 requires.  ``pcoll`` holds the
partitioned persistent collective (``Comm.pallreduce_init``).
"""
from __future__ import annotations

from ompi_tpu_torch.base import mca


def part_framework() -> mca.Framework:
    return mca.framework("part", "partitioned point-to-point communication")


def part_module():
    """The selected part module (process singleton, like pml selection;
    the framework opens at its first use and again after a teardown)."""
    comp = part_framework().select()
    if comp is None:
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError

        raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                       "no part component available")
    return comp.get_module()
