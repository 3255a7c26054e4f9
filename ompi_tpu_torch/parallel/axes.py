"""The collectives of a ``shard_map`` body, as tensor ops over the mesh axes.

The reference runs the training step as one ``shard_map`` over a ``(dp,
pp, sp, tp)`` device mesh (``(dp, pp, sp, tp, expert)`` for the
expert-parallel step), and its body exchanges data with the ``jax.lax``
collectives.  On one card the ranks are slices of one tensor: every
per-rank tensor carries the mesh axes in front, ``(dp, pp, sp, tp,
*local)`` (``parallel/mesh.py``), and each collective becomes a plain torch
op along its axis.  These are not MPI calls: the reference does not route
them through a communicator either.

The axis set belongs to the mesh (``Mesh.names``): ``MeshAxes(names)``
holds the collectives over it.  The module-level functions are those of
the dense set ``AXES`` (``DENSE``), which the flagship step uses.

Local dims are counted after the mesh axes: ``dim=0`` is the first dim of
the per-rank tensor.  Every function keeps the mesh axes in front, with
their full sizes, so the result is again a per-rank tensor.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.parallel.mesh import AXES


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _fold(t: torch.Tensor, d: int) -> torch.Tensor:
    """The sum over dim ``d`` in rank order, ``((t0 + t1) + t2) + ...``,
    keeping the dim: elementwise, so a slice of the result is bit for bit
    the result of the slice."""
    acc = t.narrow(d, 0, 1)
    for i in range(1, t.shape[d]):
        acc = acc + t.narrow(d, i, 1)
    return acc


class MeshAxes:
    """The collectives over the mesh axes ``names``, the leading dims of
    every per-rank tensor, in that order."""

    def __init__(self, names) -> None:
        self.names = tuple(names)
        self.ndim = len(self.names)

    def _dim(self, axis: str) -> int:
        return self.names.index(axis)

    def axis_index(self, t: torch.Tensor, axis: str,
                   local_ndim: int = 0) -> torch.Tensor:
        """``lax.axis_index(axis)``: each rank's index along ``axis``, an
        int64 tensor of shape ``(1, .., n, .., 1)`` over the mesh axes, with
        ``local_ndim`` trailing 1s so it broadcasts against local dims."""
        d = self._dim(axis)
        shape = [1] * self.ndim + [1] * local_ndim
        shape[d] = t.shape[d]
        return torch.arange(t.shape[d], device=t.device).reshape(shape)

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``lax.psum(t, axes)``: the sum over the ranks of each axis (in
        rank order, axis by axis), held by every rank.  A value that every
        rank of an axis holds alike comes back n times larger, as a psum of
        a replicated value does in the reference."""
        out = t
        for a in _names(axes):
            out = _fold(out, self._dim(a))
        return out.expand(t.shape)

    def ppermute_next(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.ppermute(t, axis, [(i, (i + 1) % n)])``: rank i's value
        goes to rank i + 1."""
        return torch.roll(t, 1, self._dim(axis))

    def all_to_all(self, t: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
        each rank cuts local dim ``split_axis`` into n chunks and sends
        chunk j to rank j, which concatenates what it receives along
        ``concat_axis`` in source order."""
        d = self._dim(axis)
        n = t.shape[d]
        s, c = self.ndim + split_axis, self.ndim + concat_axis
        u = t.unflatten(s, (n, t.shape[s] // n))     # chunk index at s
        u = u.transpose(d, s)                        # mesh: dest, s: source
        c = c + 1 if c > s else c                    # concat dim after unflatten
        if c > s:
            u = u.movedim(s, c - 1)                  # source just before concat
            return u.flatten(c - 1, c)
        u = u.movedim(s, c)
        return u.flatten(c, c + 1)

    def all_to_all_untiled(self, t: torch.Tensor, axis: str,
                           dim: int) -> torch.Tensor:
        """``lax.all_to_all(t, axis, split_axis=dim, concat_axis=dim)`` with
        ``tiled=False`` (local dim ``dim`` of size n): rank i's slot j
        receives rank j's slot i."""
        return t.transpose(self._dim(axis), self.ndim + dim)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``lax.all_gather(t, axis, axis=dim, tiled=True)``: the ranks'
        values concatenated along local dim ``dim`` in rank order, held by
        every rank."""
        d = self._dim(axis)
        n = t.shape[d]
        at = self.ndim - 1 + dim
        g = t.movedim(d, at).flatten(at, at + 1)
        g = g.unsqueeze(d)
        return g.expand(*g.shape[:d], n, *g.shape[d + 1:])

    def psum_scatter(self, t: torch.Tensor, axis: str,
                     dim: int) -> torch.Tensor:
        """``lax.psum_scatter(t, axis, scatter_dimension=dim, tiled=False)``
        (local dim ``dim`` of size n): the sum over the ranks, of which rank
        i keeps slot i."""
        d = self._dim(axis)
        s = _fold(t, d).squeeze(d)
        return s.movedim(self.ndim - 1 + dim, d)

    def take_own(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``lax.dynamic_slice_in_dim(t, axis_index(axis) * size, size,
        dim)`` with ``size = t.shape[dim] // n``: rank i keeps block i of
        local dim ``dim``."""
        d = self._dim(axis)
        n = t.shape[d]
        u = t.unflatten(self.ndim + dim, (n, -1))
        u = torch.diagonal(u, dim1=d, dim2=self.ndim + dim)   # appended last
        return u.movedim(-1, d)


#: the dense step's axis set and its collectives
DENSE = MeshAxes(AXES)
MESH_NDIM = DENSE.ndim
axis_index = DENSE.axis_index
psum = DENSE.psum
ppermute_next = DENSE.ppermute_next
all_to_all = DENSE.all_to_all
all_to_all_untiled = DENSE.all_to_all_untiled
all_gather = DENSE.all_gather
psum_scatter = DENSE.psum_scatter
take_own = DENSE.take_own
