"""Topology objects and the MPI_Dims_create factorizer.

Copy of ``ompi_tpu/mca/topo/base.py`` (after the reference's
``ompi/mca/topo/base/``: ``topo_base_cart_create.c``, ``topo_base_graph_*``,
``topo_base_dist_graph_*``) with its imports re-pointed: topologies are
value objects attached to ``comm.topo``; creation routines live on ``Comm``.
A cartesian row of the device world is a sub-communicator over rows of the
world's tensor, so ``cart_sub`` gives the ring kernels their sub-rings.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.status import PROC_NULL


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> list[int]:
    """``MPI_Dims_create``: balanced factorization of nnodes over ndims.

    Mirrors ``topo_base_dims_create.c``: fixed (nonzero) entries are
    honored; free (zero) entries get the remaining factors as evenly as
    possible, in decreasing order.
    """
    out = list(dims) if dims is not None else [0] * ndims
    if len(out) != ndims:
        raise MpiError(ErrorClass.ERR_DIMS, "dims length != ndims")
    fixed = 1
    for d in out:
        if d < 0:
            raise MpiError(ErrorClass.ERR_DIMS, f"negative dim {d}")
        if d > 0:
            fixed *= d
    free_idx = [i for i, d in enumerate(out) if d == 0]
    if not free_idx:
        if fixed != nnodes:
            raise MpiError(ErrorClass.ERR_DIMS,
                           f"dims product {fixed} != nnodes {nnodes}")
        return out
    rem, check = divmod(nnodes, fixed)
    if check:
        raise MpiError(ErrorClass.ERR_DIMS,
                       f"nnodes {nnodes} not divisible by fixed dims {fixed}")
    # prime-factorize the remainder, largest factors first, round-robin the
    # smallest current free dim (keeps the grid as square as possible)
    factors = []
    n = rem
    p = 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    sizes = [1] * len(free_idx)
    for f in sorted(factors, reverse=True):
        sizes[sizes.index(min(sizes))] *= f
    for i, s in zip(free_idx, sorted(sizes, reverse=True)):
        out[i] = s
    return out


class CartTopo:
    """Cartesian topology (``mca_topo_base_comm_cart_2_2_0_t``)."""

    kind = "cart"

    def __init__(self, dims: Sequence[int], periods: Sequence[bool]) -> None:
        self.dims = list(dims)
        self.periods = list(periods)
        self.ndims = len(self.dims)
        self.size = int(np.prod(self.dims)) if self.dims else 1

    # row-major rank<->coords (reference convention, cart_rank.c)
    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for dim, period, c in zip(self.dims, self.periods, coords):
            if period:
                c = c % dim
            elif not 0 <= c < dim:
                return PROC_NULL
            rank = rank * dim + c
        return rank

    def coords_of(self, rank: int) -> list[int]:
        coords = []
        for dim in reversed(self.dims):
            coords.append(rank % dim)
            rank //= dim
        return list(reversed(coords))

    def shift(self, rank: int, direction: int, disp: int) -> tuple[int, int]:
        """``MPI_Cart_shift`` → (source, dest) ranks (PROC_NULL at edges)."""
        if not 0 <= direction < self.ndims:
            raise MpiError(ErrorClass.ERR_DIMS,
                           f"invalid direction {direction}")
        here = self.coords_of(rank)
        up = list(here)
        up[direction] += disp
        down = list(here)
        down[direction] -= disp
        return self.rank_of(down), self.rank_of(up)

    def neighbors(self, rank: int) -> tuple[list[int], list[int]]:
        """(sources, destinations) in dimension order, -disp then +disp —
        the neighbor-collective ordering of ``MPI_NEIGHBOR_ALLTOALL`` on
        cartesian comms."""
        srcs, dsts = [], []
        for d in range(self.ndims):
            minus, plus = self.shift(rank, d, 1)
            srcs += [minus, plus]
            dsts += [minus, plus]
        return srcs, dsts


class GraphTopo:
    """Classic graph topology (index/edges arrays, ``MPI_Graph_create``)."""

    kind = "graph"

    def __init__(self, index: Sequence[int], edges: Sequence[int]) -> None:
        self.index = list(index)
        self.edges = list(edges)
        self.size = len(self.index)

    def neighbors_of(self, rank: int) -> list[int]:
        lo = self.index[rank - 1] if rank > 0 else 0
        return self.edges[lo:self.index[rank]]

    def neighbors(self, rank: int) -> tuple[list[int], list[int]]:
        ns = self.neighbors_of(rank)
        return ns, ns


class DistGraphTopo:
    """Distributed graph (``MPI_Dist_graph_create_adjacent``)."""

    kind = "dist_graph"

    def __init__(self, sources: Sequence[int], destinations: Sequence[int],
                 sourceweights=None, destweights=None) -> None:
        self.sources = list(sources)
        self.destinations = list(destinations)
        self.sourceweights = (list(sourceweights) if sourceweights is not None
                              else [1] * len(self.sources))
        self.destweights = (list(destweights) if destweights is not None
                            else [1] * len(self.destinations))

    def neighbors(self, rank: int) -> tuple[list[int], list[int]]:
        return self.sources, self.destinations
