"""topo — process topologies (``ompi/mca/topo/``).

Copy of ``ompi_tpu/mca/topo/__init__.py``: cartesian, graph and
distributed-graph topologies attached to communicators (``comm.topo``);
the creation routines live on ``Comm`` (``cart_create`` and friends).
"""
from __future__ import annotations

from ompi_tpu_torch.mca.topo.base import (CartTopo, DistGraphTopo, GraphTopo,
                                          dims_create)

__all__ = ["CartTopo", "GraphTopo", "DistGraphTopo", "dims_create"]
