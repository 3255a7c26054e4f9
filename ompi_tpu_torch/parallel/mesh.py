"""The (dp, pp, sp, tp[, expert]) axis set of the flagship training step.

Copy of ``ompi_tpu/parallel/mesh.py``'s ``AXES``, ``MeshSpec`` and
``default_axis_sizes``.  The reference builds a ``jax.sharding.Mesh`` over
devices; on one card the ranks are slices of one tensor, so ``make_mesh``
returns the layout the port's per-rank tensors carry: every such tensor
has the mesh axes in front, ``(dp, pp, sp, tp, *local)``, and an
expert-parallel spec (ep > 1) appends ``expert`` after them, ``(dp, pp, sp,
tp, expert, *local)``, as the reference's mesh does (``mesh.py:80-83``).

The multi-process device world (``tpurun --device-world``) splits a global
mesh over the job's processes.  The reference lays the global mesh out
process-major, ``np.array(devices).reshape(dp, pp, sp, tp)`` over the
devices in process order (``mesh.py:84``), so process p holds the ranks
``p·K .. (p+1)·K - 1`` of the row-major rank order (K ranks a process).
``process_block`` returns that block as a ``Mesh`` whose ``origin`` is the
global coordinate of its first rank and whose ``local_dims`` are its
sizes: whole trailing axes, at most one axis cut, and 1 on the leading
ones.  A layout where a process's ranks are no such box (K not a product
of whole trailing axes times a divisor of the next) raises
``ERR_UNSUPPORTED_OPERATION``.  ``ranks()`` lists the global coordinates of
the block's ranks.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv

AXES = ("dp", "pp", "sp", "tp")

#: the MoE axis name: appended after the dense axes only when the spec
#: asks for expert parallelism (ep > 1), so every dense caller keeps the
#: 4-axis mesh it always had
EXPERT_AXIS = "expert"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    # expert-parallel ways; defaulted so every MeshSpec(...) construction
    # and equality pin matches the reference's
    ep: int = 1

    @property
    def n(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def sizes(self) -> dict:
        d = {"dp": self.dp, "pp": self.pp, "sp": self.sp, "tp": self.tp}
        if self.ep > 1:
            d["ep"] = self.ep
        return d


def _prime_factors(n: int) -> list:
    fs, d = [], 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def default_axis_sizes(n_devices: int) -> MeshSpec:
    """Deterministically factor a rank count over (tp, sp, dp[, pp]).

    tp and sp claim factors first; pp only activates at >= 16 ranks, as in
    the reference.
    """
    sizes = {"dp": 1, "pp": 1, "sp": 1, "tp": 1}
    order = ["tp", "sp", "dp", "pp"] if n_devices >= 16 else ["tp", "sp", "dp"]
    for i, f in enumerate(_prime_factors(n_devices)):
        sizes[order[i % len(order)]] *= f
    return MeshSpec(**sizes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis layout of the per-rank tensors: ``shape[a]`` ranks along
    axis ``a`` (in ``names`` order, the leading dims of every per-rank
    tensor), all on ``device``.  A process-local block of a global mesh
    also has ``origin``, the global coordinate of its first rank, and
    ``block``, its sizes: its per-rank tensors carry ``local_dims``."""

    shape: dict
    device: torch.device
    origin: tuple = None
    block: tuple = None

    @property
    def names(self) -> tuple:
        """The mesh axes: ``AXES``, then ``EXPERT_AXIS`` when ep > 1."""
        return tuple(self.shape)

    @property
    def dims(self) -> tuple:
        """The global mesh's sizes."""
        return tuple(self.shape.values())

    @property
    def local_dims(self) -> tuple:
        """The sizes of the ranks held here (the whole mesh, or the
        process's block)."""
        return self.dims if self.block is None else tuple(self.block)

    @property
    def local_origin(self) -> tuple:
        return (0,) * len(self.shape) if self.origin is None \
            else tuple(self.origin)

    def ranks(self) -> list:
        """The global coordinates of the ranks held here, row-major."""
        return [tuple(o + i for o, i in zip(self.local_origin, idx))
                for idx in itertools.product(
                    *(range(b) for b in self.local_dims))]


def make_mesh(n_ranks: int, spec: MeshSpec = None, device=None):
    """``(Mesh, spec)`` for a world of ``n_ranks`` virtual ranks on
    ``device`` (the card unless the caller names another; with no card
    and no ``device`` it raises); ``spec`` defaults to
    ``default_axis_sizes(n_ranks)``."""
    if spec is None:
        spec = default_axis_sizes(n_ranks)
    if spec.n != n_ranks:
        raise ValueError(f"mesh spec {spec} needs {spec.n} devices, "
                         f"got {n_ranks}")
    shape = {a: getattr(spec, a) for a in AXES}
    if spec.ep > 1:
        shape[EXPERT_AXIS] = spec.ep
    return Mesh(shape, cudaenv.resolve_device(device)), spec


def process_block(spec: MeshSpec, nprocs: int, proc: int, device=None):
    """``(Mesh, spec)`` for process ``proc`` of ``nprocs`` holding its
    contiguous block of the global mesh of ``spec`` (process-major, as the
    reference's ``reshape`` of the global device list)."""
    from ompi_tpu_torch.api.errors import ErrorClass, MpiError

    mesh, spec = make_mesh(spec.n, spec, device=device)
    dims = mesh.dims
    if nprocs < 1 or spec.n % nprocs or not 0 <= proc < nprocs:
        raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                       f"a mesh of {spec.n} ranks does not split over "
                       f"{nprocs} processes")
    rem, block = spec.n // nprocs, []
    for d in reversed(dims):
        if rem % d == 0:
            block.append(d)             # a whole trailing axis
            rem //= d
        elif rem < d and d % rem == 0:
            block.append(rem)           # the one axis the block cuts
            rem = 1
        else:
            raise MpiError(
                ErrorClass.ERR_UNSUPPORTED_OPERATION,
                f"the process blocks of {spec.sizes()} over {nprocs} "
                "processes are not contiguous in the leading axes")
    origin = np.unravel_index(proc * (spec.n // nprocs), dims)
    return dataclasses.replace(mesh, origin=tuple(int(c) for c in origin),
                               block=tuple(reversed(block))), spec
