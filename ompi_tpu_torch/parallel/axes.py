"""The collectives of a ``shard_map`` body, as tensor ops over the mesh axes.

The reference runs the training step as one ``shard_map`` over a ``(dp,
pp, sp, tp)`` device mesh (``(dp, pp, sp, tp, expert)`` for the
expert-parallel step), and its body exchanges data with the ``jax.lax``
collectives.  On one card the ranks are slices of one tensor: every
per-rank tensor carries the mesh axes in front, ``(dp, pp, sp, tp,
*local)`` (``parallel/mesh.py``), and each collective becomes a plain torch
op along its axis.  These are not MPI calls: the reference does not route
them through a communicator either.

The axis set belongs to the mesh: ``for_mesh(mesh)`` gives
``MeshAxes(mesh.names)``, the collectives over its axes, or, for a
process's block of a global mesh (``mesh.process_block``), a
``ProcessAxes``.  The module-level functions are those of the dense set
``AXES`` (``DENSE``).

``ProcessAxes`` is the multi-process device world's axis set.  Each
process holds a contiguous block of the global mesh, so the axes that span
processes are the leading ones.  A collective over such an axis folds the
local slice in rank order first and then crosses the process boundary
through the job's process group (``torch.distributed``, gloo), folding the
processes' partials in rank order (an all-gather, then the fold: the same
sum on every process, whatever the process count).  With one rank a
process on the axis (``dp = 2`` over 2 processes) that is the single
process's fold, operand for operand.  ``psum``, ``all_gather``,
``psum_scatter``, ``take_own``, ``axis_index`` and the pipeline's
``ppermute_next`` cross the boundary; the two all-to-alls over a spanning
axis raise ``ERR_UNSUPPORTED_OPERATION`` (the step never runs them there).
Autograd crosses ``ppermute_next`` (its transpose is the shift the other
way, itself across the boundary) and ``psum`` (its transpose is the
identity: the sum is the same on every process and each differentiates its
own copy, as JAX transposes a psum into an invariant value); a spanning
``all_gather`` or ``psum_scatter`` under autograd raises.

Local dims are counted after the mesh axes: ``dim=0`` is the first dim of
the per-rank tensor.  Every function keeps the mesh axes in front, with
their full sizes, so the result is again a per-rank tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
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


class _Boundary:
    """The processes along one spanning axis: the process group (None:
    the job's own), this process's position and their count."""

    def __init__(self, group, pos: int, count: int) -> None:
        self.group, self.pos, self.count = group, pos, count

    def gather(self, t: torch.Tensor) -> list:
        """Every process's ``t`` along the axis, in rank order."""
        import torch.distributed as dist

        t = t.contiguous()
        bufs = [torch.empty_like(t) for _ in range(self.count)]
        dist.all_gather(bufs, t, group=self.group)
        return bufs


def _fold_list(parts: list) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _CrossSum(torch.autograd.Function):
    """The cross-process fold of the partials; transposed to the
    identity (the invariant result's cotangent, once a process)."""

    @staticmethod
    def forward(ctx, t, boundary):
        return _fold_list(boundary.gather(t))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shift(t: torch.Tensor, d: int, boundary, step: int) -> torch.Tensor:
    """Roll ``t`` by ``step`` (+1 or -1) along dim ``d`` of a spanning
    axis: the slot leaving this block enters the neighbouring process's."""
    n = t.shape[d]
    edge = t.narrow(d, n - 1 if step > 0 else 0, 1)
    incoming = boundary.gather(edge)[(boundary.pos - step) % boundary.count]
    if step > 0:
        return torch.cat([incoming, t.narrow(d, 0, n - 1)], d)
    return torch.cat([t.narrow(d, 1, n - 1), incoming], d)


class _CrossShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, d, boundary):
        ctx.d, ctx.boundary = d, boundary
        return _shift(t, d, boundary, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.d, ctx.boundary, -1), None, None


class ProcessAxes(MeshAxes):
    """The collectives of a process's block of a global mesh
    (``mesh.origin``, ``mesh.local_dims``): local along the axes the block
    holds whole, across the process group along the others."""

    def __init__(self, mesh) -> None:
        import torch.distributed as dist

        super().__init__(mesh.names)
        self.sizes = tuple(mesh.dims)
        self.origin = tuple(mesh.local_origin)
        self.block = tuple(mesh.local_dims)
        spanning = [i for i, (b, n) in enumerate(zip(self.block, self.sizes))
                    if b < n]
        # the process grid: each process's block coordinate on the
        # spanning axes, from its rank (process-major layout)
        nprocs, me = dist.get_world_size(), dist.get_rank()
        k = math.prod(self.block)
        grid = {p: tuple(int(c) // b for c, b in zip(
                    np.unravel_index(p * k, self.sizes), self.block))
                for p in range(nprocs)}
        self._boundaries = {}
        for i in spanning:
            # one group a line of processes along axis i; every process
            # makes every line's group in the same order (new_group is
            # collective over the job's group)
            lines: dict = {}
            for p in range(nprocs):
                key = grid[p][:i] + grid[p][i + 1:]
                lines.setdefault(key, []).append(p)
            for key in sorted(lines):
                ranks = sorted(lines[key], key=lambda p: grid[p][i])
                group = (None if len(ranks) == nprocs
                         else dist.new_group(ranks))
                if me in ranks:
                    self._boundaries[self.names[i]] = _Boundary(
                        group, ranks.index(me), len(ranks))

    def _span(self, axis: str):
        return self._boundaries.get(axis)

    def _refuse(self, what: str, axis: str):
        raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                       f"{what} over the axis {axis!r}, which spans "
                       "processes")

    def axis_index(self, t: torch.Tensor, axis: str,
                   local_ndim: int = 0) -> torch.Tensor:
        return super().axis_index(t, axis, local_ndim) \
            + self.origin[self._dim(axis)]

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        out = t
        for a in _names(axes):
            out = _fold(out, self._dim(a))
            b = self._span(a)
            if b is not None:
                out = _CrossSum.apply(out, b)
        return out.expand(t.shape)

    def ppermute_next(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        b = self._span(axis)
        if b is None:
            return super().ppermute_next(t, axis)
        return _CrossShift.apply(t, self._dim(axis), b)

    def all_to_all(self, t, axis, split_axis, concat_axis):
        if self._span(axis) is not None:
            self._refuse("all_to_all", axis)
        return super().all_to_all(t, axis, split_axis, concat_axis)

    def all_to_all_untiled(self, t, axis, dim):
        if self._span(axis) is not None:
            self._refuse("all_to_all", axis)
        return super().all_to_all_untiled(t, axis, dim)

    def _no_grad_span(self, what: str, t, axis: str):
        b = self._span(axis)
        if b is not None and t.requires_grad and torch.is_grad_enabled():
            self._refuse(f"a differentiated {what}", axis)
        return b

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        b = self._no_grad_span("all_gather", t, axis)
        if b is None:
            return super().all_gather(t, axis, dim)
        d = self._dim(axis)
        at = self.ndim - 1 + dim
        local = t.movedim(d, at).flatten(at, at + 1)   # this block's ranks
        g = torch.cat(b.gather(local), at).unsqueeze(d)
        return g.expand(*g.shape[:d], t.shape[d], *g.shape[d + 1:])

    def psum_scatter(self, t: torch.Tensor, axis: str,
                     dim: int) -> torch.Tensor:
        b = self._no_grad_span("psum_scatter", t, axis)
        if b is None:
            return super().psum_scatter(t, axis, dim)
        d = self._dim(axis)
        s = _fold_list(b.gather(_fold(t, d))).squeeze(d)
        s = s.movedim(self.ndim - 1 + dim, d)
        return s.narrow(d, self.origin[d], t.shape[d])

    def take_own(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        d = self._dim(axis)
        u = t.unflatten(self.ndim + dim, (self.sizes[d], -1))
        u = u.narrow(self.ndim + dim, self.origin[d], t.shape[d])
        u = torch.diagonal(u, dim1=d, dim2=self.ndim + dim)
        return u.movedim(-1, d)


def for_mesh(mesh) -> MeshAxes:
    """The axis set of ``mesh``: its own axes, or, for a process's block
    of a global mesh, the cross-process set."""
    if mesh.block is None or tuple(mesh.block) == tuple(mesh.dims):
        return MeshAxes(mesh.names)
    return ProcessAxes(mesh)


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
