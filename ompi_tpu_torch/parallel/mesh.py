"""The (dp, pp, sp, tp[, expert]) axis set of the flagship training step.

Copy of ``ompi_tpu/parallel/mesh.py``'s ``AXES``, ``MeshSpec`` and
``default_axis_sizes``.  The reference builds a ``jax.sharding.Mesh`` over
devices; on one card the ranks are slices of one tensor, so ``make_mesh``
returns the layout the port's per-rank tensors carry: every such tensor
has the four mesh axes in front, ``(dp, pp, sp, tp, *local)``.
"""
from __future__ import annotations

import dataclasses

import torch

from ompi_tpu_torch.base import cudaenv

AXES = ("dp", "pp", "sp", "tp")

#: the MoE axis name: appended after the dense axes only when the spec
#: asks for expert parallelism (ep > 1); the expert-parallel trainer is not
#: ported yet, so ``make_mesh`` refuses such a spec
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
    axis ``a`` (in ``AXES`` order, the leading dims of every per-rank
    tensor), all on ``device``."""

    shape: dict
    device: torch.device

    @property
    def dims(self) -> tuple:
        return tuple(self.shape[a] for a in AXES)


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
    if spec.ep > 1:
        raise NotImplementedError(
            "expert-parallel meshes (ep > 1) wait for the MoE trainer")
    shape = {a: getattr(spec, a) for a in AXES}
    return Mesh(shape, cudaenv.resolve_device(device)), spec
