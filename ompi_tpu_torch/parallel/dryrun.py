"""Dry run of the flagship path: full dp/pp/sp/tp training steps.

Port of ``ompi_tpu/parallel/dryrun.py``.  The ranks are the
``otpu_rte_virtual_ranks`` virtual ranks (default 8) on one device: the
card unless the caller passes ``device="cpu"`` (with no card and no
``device`` it raises, as ``cudaenv.resolve_device`` does).
``run_mp_training_step`` waits for the multi-process world.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.parallel.mesh import MeshSpec, default_axis_sizes, make_mesh


def make_step_and_args(device=None, spec=None, layers=None, ranks=None,
                       use_flash=None, lr=1e-4):
    """Shared flagship-path setup: ``(step, (params, x), spec)`` on a mesh
    of ``ranks`` virtual ranks (default: the world size)."""
    from ompi_tpu_torch.parallel.train import (build_train_step, init_params,
                                               model_dims)

    n = cudaenv.virtual_ranks() if ranks is None else int(ranks)
    mesh, mspec = make_mesh(n, spec, device=device)
    dims = model_dims(mspec, layers)
    step, place = build_train_step(mesh, mspec, lr=lr, layers=layers,
                                   use_flash=use_flash)
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (dims["batch"], dims["seq"], dims["d"]))
    params, xd = place(init_params(mspec, layers=layers), x)
    return step, (params, xd), mspec


def parse_spec(text: str) -> MeshSpec:
    """'dp=1,pp=2,sp=2,tp=2' -> MeshSpec (the dryrun override)."""
    sizes = {}
    for part in str(text).split(","):
        k, _, v = part.partition("=")
        sizes[k.strip()] = int(v)
    return MeshSpec(**sizes)


def run_training_step(device=None, spec=None, lr=1e-4) -> float:
    """Run two steps on the world's mesh (the loss must descend).

    ``lr`` defaults to the reference's; at ``OTPU_MODEL_SCALE=64`` it
    overshoots (the loss, 0.5·Σy², and its gradient grow with the width),
    and 1e-5 descends.

    When no spec override is given and the default mesh leaves the
    pipeline axis inactive (pp only self-activates at >= 16 ranks), two
    more steps run with pp = 2 over half the factorization, so every dry
    run covers the composed dp x pp x sp x tp program."""
    n = cudaenv.virtual_ranks()
    loss = _one_descending_step(device, spec, n, lr)
    half = default_axis_sizes(n // 2) if n >= 4 else None
    if (spec is None and half is not None and half.pp == 1
            and default_axis_sizes(n).pp == 1):
        sizes = half.sizes()
        sizes["pp"] = 2
        _one_descending_step(device, MeshSpec(**sizes), 2 * (n // 2), lr)
    return loss


def run_bucket_overlap_check(device=None, spec=None) -> None:
    """One step with the single-psum dp sync and one with the bucketed
    (late-layer-first) sync must give BIT-IDENTICAL parameters and loss:
    a psum per bucket is elementwise the same sum."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import train as _train  # noqa: F401  (registers the var)

    var = registry.lookup("otpu_parallel_bucket_overlap")
    old = bool(var.value)
    var.set(False)
    try:
        step, (params, xd), mspec = make_step_and_args(device, spec)
        base_params, base_loss = step(params, xd)
        var.set(True)
        step2, (params2, xd2), _ = make_step_and_args(device, spec)
        new_params, new_loss = step2(params2, xd2)
    finally:
        var.set(old)
    if float(base_loss) != float(new_loss):
        raise RuntimeError(
            f"bucket-overlap loss diverged: {float(base_loss)!r} vs "
            f"{float(new_loss)!r}")
    for k in base_params:
        a, b = base_params[k], new_params[k]
        if not torch.equal(a, b):
            raise RuntimeError(
                f"bucket-overlap param {k!r} not bit-identical "
                f"(max abs diff {(a - b).abs().max().item()})")
    print(f"bucket-overlap dryrun ok: mesh={mspec.sizes()} params "
          "bit-identical")


def _one_descending_step(device, spec, ranks, lr) -> float:
    step, state, spec = make_step_and_args(device, spec, ranks=ranks, lr=lr)
    new_state, loss = step(*state)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    # one more step on the updated params: SGD must have moved them
    _, loss2 = step(new_state, state[1])
    if not float(loss2) < loss:
        raise RuntimeError(
            f"training step did not descend: {loss} -> {float(loss2)}")
    print(f"dryrun ok: mesh={spec.sizes()} loss {loss:.6f} -> "
          f"{float(loss2):.6f}")
    return loss
