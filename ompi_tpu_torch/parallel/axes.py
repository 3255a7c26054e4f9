"""The collectives of a ``shard_map`` body, as tensor ops over the mesh axes.

The reference runs the training step as one ``shard_map`` over a ``(dp,
pp, sp, tp)`` device mesh, and its body exchanges data with the
``jax.lax`` collectives.  On one card the ranks are slices of one tensor:
every per-rank tensor carries the four mesh axes in front, ``(dp, pp, sp,
tp, *local)`` (``parallel/mesh.py``), and each collective becomes a plain
torch op along its axis.  These are not MPI calls: the reference does not
route them through a communicator either.

Local dims are counted after the mesh axes: ``dim=0`` is the first dim of
the per-rank tensor.  Every function keeps the mesh axes in front, with
their full sizes, so the result is again a per-rank tensor.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.parallel.mesh import AXES

MESH_NDIM = len(AXES)


def _dim(axis: str) -> int:
    return AXES.index(axis)


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(t: torch.Tensor, axis: str, local_ndim: int = 0) -> torch.Tensor:
    """``lax.axis_index(axis)``: each rank's index along ``axis``, an int64
    tensor of shape ``(1, .., n, .., 1)`` over the mesh axes, with
    ``local_ndim`` trailing 1s so it broadcasts against local dims."""
    d = _dim(axis)
    shape = [1] * MESH_NDIM + [1] * local_ndim
    shape[d] = t.shape[d]
    return torch.arange(t.shape[d], device=t.device).reshape(shape)


def _fold(t: torch.Tensor, d: int) -> torch.Tensor:
    """The sum over dim ``d`` in rank order, ``((t0 + t1) + t2) + ...``,
    keeping the dim: elementwise, so a slice of the result is bit for bit
    the result of the slice."""
    acc = t.narrow(d, 0, 1)
    for i in range(1, t.shape[d]):
        acc = acc + t.narrow(d, i, 1)
    return acc


def psum(t: torch.Tensor, axes) -> torch.Tensor:
    """``lax.psum(t, axes)``: the sum over the ranks of each axis (in rank
    order, axis by axis), held by every rank.  A value that every rank of
    an axis holds alike comes back n times larger, as a psum of a
    replicated value does in the reference."""
    out = t
    for a in _names(axes):
        out = _fold(out, _dim(a))
    return out.expand(t.shape)


def ppermute_next(t: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.ppermute(t, axis, [(i, (i + 1) % n)])``: rank i's value goes
    to rank i + 1."""
    return torch.roll(t, 1, _dim(axis))


def all_to_all(t: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
    each rank cuts local dim ``split_axis`` into n chunks and sends chunk j
    to rank j, which concatenates what it receives along ``concat_axis`` in
    source order."""
    d, n = _dim(axis), t.shape[_dim(axis)]
    s, c = MESH_NDIM + split_axis, MESH_NDIM + concat_axis
    u = t.unflatten(s, (n, t.shape[s] // n))     # chunk index at s
    u = u.transpose(d, s)                        # mesh: dest, s: source
    c = c + 1 if c > s else c                    # concat dim after unflatten
    if c > s:
        u = u.movedim(s, c - 1)                  # source just before concat
        return u.flatten(c - 1, c)
    u = u.movedim(s, c)
    return u.flatten(c, c + 1)


def all_to_all_untiled(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_axis=dim, concat_axis=dim)`` with
    ``tiled=False`` (local dim ``dim`` of size n): rank i's slot j receives
    rank j's slot i."""
    return t.transpose(_dim(axis), MESH_NDIM + dim)


def all_gather(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``lax.all_gather(t, axis, axis=dim, tiled=True)``: the ranks' values
    concatenated along local dim ``dim`` in rank order, held by every
    rank."""
    d, n = _dim(axis), t.shape[_dim(axis)]
    at = MESH_NDIM - 1 + dim
    g = t.movedim(d, at).flatten(at, at + 1)
    g = g.unsqueeze(d)
    return g.expand(*g.shape[:d], n, *g.shape[d + 1:])


def psum_scatter(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(t, axis, scatter_dimension=dim, tiled=False)``
    (local dim ``dim`` of size n): the sum over the ranks, of which rank i
    keeps slot i."""
    d = _dim(axis)
    s = _fold(t, d).squeeze(d)
    return s.movedim(MESH_NDIM - 1 + dim, d)


def take_own(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim(t, axis_index(axis) * size, size, dim)``
    with ``size = t.shape[dim] // n``: rank i keeps block i of local dim
    ``dim``."""
    d, n = _dim(axis), t.shape[_dim(axis)]
    u = t.unflatten(MESH_NDIM + dim, (n, -1))
    u = torch.diagonal(u, dim1=d, dim2=MESH_NDIM + dim)   # appended last
    return u.movedim(-1, d)
