"""Dry run of the flagship path: full dp/pp/sp/tp training steps.

Port of ``ompi_tpu/parallel/dryrun.py``.  The ranks are the
``otpu_rte_virtual_ranks`` virtual ranks (default 8) on one device: the
card unless the caller passes ``device="cpu"`` (with no card and no
``device`` it raises, as ``cudaenv.resolve_device`` does).
``run_tolerance_check`` is a copy of the reference's (numpy only), the
band harness of the lossy tiers; ``parallel/moe.run_quant_dispatch_check``
holds the int8 dispatch to it.

The multi-process device world (``dryrun.py:140-184``):
``run_mp_training_step`` runs inside each rank of a ``tpurun
--device-world`` job.  ``init()`` boots the instance, which joined the
job's process group, and the check is the reference's: the world booted,
more than one process, then two descending steps of the flagship step over
the global mesh of every process's virtual ranks (``otpu_rte_virtual_ranks``
a process, ``tpurun --local-devices``), each process holding its block
(``mesh.process_block``) and its cross-process axes going through the
process group; it prints ``dryrun ok: mesh=... loss a -> b``.
``dryrun_multichip(n, nprocs)`` is the twin of the multi-process mode of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:47-70``): it
launches the port's tpurun with ``--device-world --local-devices n/nprocs``
and that body in every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.parallel.mesh import (MeshSpec, default_axis_sizes,
                                          make_mesh, process_block)


def make_step_and_args(device=None, spec=None, layers=None, ranks=None,
                       use_flash=None, lr=1e-4, procs=None):
    """Shared flagship-path setup: ``(step, (params, x), spec)`` on a mesh
    of ``ranks`` virtual ranks (default: the world size).  ``procs`` =
    ``(nprocs, proc)`` places only process ``proc``'s block of that global
    mesh (the multi-process device world)."""
    from ompi_tpu_torch.parallel.train import (build_train_step, init_params,
                                               model_dims)

    n = cudaenv.virtual_ranks() if ranks is None else int(ranks)
    if procs is None:
        mesh, mspec = make_mesh(n, spec, device=device)
    else:
        mesh, mspec = process_block(spec or default_axis_sizes(n), *procs,
                                    device=device)
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


def run_mp_training_step(spec_text: str = "", device=None,
                         lr: float = 1e-4) -> float:
    """The multi-process dry run's body, in each rank of a ``tpurun
    --device-world`` job: two descending steps over the global mesh."""
    import torch.distributed as dist

    import ompi_tpu_torch

    w = ompi_tpu_torch.init(device=device)
    rte = w.rte
    if not getattr(rte, "device_world_booted", False):
        raise RuntimeError(
            "device world did not boot (launch with tpurun --device-world)")
    if dist.get_world_size() < 2:
        raise RuntimeError(
            f"expected a multi-process device world, got "
            f"{dist.get_world_size()} process(es)")
    loss = _one_descending_step(
        rte.device, parse_spec(spec_text) if spec_text else None,
        len(rte.global_ranks), lr,
        procs=(dist.get_world_size(), dist.get_rank()))
    ompi_tpu_torch.finalize()
    return loss


def dryrun_multichip(n_ranks: int, nprocs: int, spec: str = "",
                     device=None, lr: float = 1e-4,
                     timeout: float = None) -> None:
    """Launch ``run_mp_training_step`` over ``nprocs`` processes of
    ``n_ranks // nprocs`` virtual ranks each through the port's tpurun;
    raises if the job fails."""
    import os
    import subprocess
    import sys

    if nprocs < 2 or n_ranks % nprocs:
        raise ValueError(f"{n_ranks} ranks do not split over {nprocs} "
                         "processes")
    env = dict(os.environ)
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD", "OTPU_DEVICE_WORLD",
              "OTPU_DIST_COORD"):
        env.pop(k, None)
    body = ("from ompi_tpu_torch.parallel.dryrun import "
            f"run_mp_training_step; run_mp_training_step({spec!r}, "
            f"device={device!r}, lr={lr!r})")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
         "-n", str(nprocs), "--device-world",
         "--local-devices", str(n_ranks // nprocs),
         sys.executable, "-c", body],
        env=env, cwd=root, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(
            f"multi-process dry run failed (exit {proc.returncode})")


def _one_descending_step(device, spec, ranks, lr, procs=None) -> float:
    step, state, spec = make_step_and_args(device, spec, ranks=ranks, lr=lr,
                                           procs=procs)
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


def run_tolerance_check(coll, approx_fn, exact_fn=None,
                        sizes=(1 << 10, 1 << 14), dtypes=("float32",),
                        nranks=4, band=0.02, seed=0) -> dict:
    """Tolerance-band twin of the bit-exactness checks: lossy collective
    tiers (coll/quant) cannot promise bit-identical results, so this harness
    pins them to a RELATIVE-ERROR BAND against the exact result instead.

    For every (size, dtype) cell: seeded inputs ``(nranks, size)``,
    ``exact_fn(stack)`` (default: the f64-accumulated sum, the allreduce
    reference), ``approx_fn(stack)`` (the path under test), and the max
    absolute deviation normalized by ``max(|exact|)``.  Returns
    ``{"coll/size/dtype": rel_error}``; any cell outside the band raises a
    report naming the failing (coll, size, dtype) cell."""
    report: dict = {}
    failures = []
    for size in sizes:
        for di, dtype in enumerate(dtypes):
            rng = np.random.default_rng([int(seed), int(size), di])
            stack = rng.standard_normal((nranks, int(size))).astype(dtype)
            exact = np.asarray(
                np.sum(stack.astype(np.float64), axis=0).astype(dtype)
                if exact_fn is None else exact_fn(stack))
            approx = np.asarray(approx_fn(stack))
            denom = max(float(np.max(np.abs(exact))), 1e-12)
            rel = float(np.max(np.abs(approx.astype(np.float64)
                                      - exact.astype(np.float64)))
                        / denom)
            report[f"{coll}/{size}/{dtype}"] = rel
            if not np.isfinite(rel) or rel > band:
                failures.append((size, dtype, rel))
    if failures:
        cells = "; ".join(
            f"({coll}, {size}, {dtype}) rel error {rel:.3e} > band "
            f"{band:g}" for size, dtype, rel in failures)
        raise RuntimeError(f"tolerance check FAILED: {cells}")
    worst = max(report.values()) if report else 0.0
    print(f"tolerance dryrun ok: {coll} {len(report)} cells, max rel "
          f"error {worst:.3e} within band {band:g}")
    return report
