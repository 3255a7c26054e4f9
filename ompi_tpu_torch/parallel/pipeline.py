"""GPipe-style pipeline over the pp mesh axis.

Port of ``ompi_tpu/parallel/pipeline.py``.  Stage-to-stage activation
handoff is a ``ppermute`` ring (a roll along the pp axis of the per-rank
tensors); microbatches stream through M + pp − 1 steps, a Python loop in
place of ``lax.scan``; per-rank control flow is a mask over the pp axis,
and bubble steps compute on masked-out state.  At pp == 1 every mask is
all-true and the roll is the identity: the same loop is a plain microbatch
loop, as in the reference.

The reference pre-marks its carries with ``pcast(to="varying")`` so its
backward transposes the collectives right under ``check_vma``; autograd
over per-rank tensors needs no such marking (ROADMAP C).
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.parallel import axes

def pipeline_apply(stage_fn, stage_params, x_microbatches, *, pp: int,
                   ax=axes.DENSE):
    """Run microbatches through pp stages; returns ``(*mesh, M, *mb)``.

    ``stage_fn(stage_params, x_mb) -> y_mb`` is each rank's stage (its
    shard of the layer stack).  ``x_microbatches`` ``(*mesh, M, *mb)`` is
    read at stage 0 only; outputs are collected at stage pp − 1 and are zero
    elsewhere.  ``ax`` is the step's axis set: its ``ppermute_next`` and
    ``axis_index`` over pp (global indices, across processes where pp spans
    them).
    """
    mbd = ax.ndim     # the local dim of the microbatch index
    M = x_microbatches.shape[mbd]
    mb_ndim = x_microbatches.dim() - mbd - 1
    steps = M + pp - 1
    r = ax.axis_index(x_microbatches, "pp", mb_ndim)
    # every step's masks at once, (steps, *mesh, 1..): a step reads a view
    ts = torch.arange(steps, device=r.device).reshape(steps, *[1] * r.dim())
    first = r == 0
    valid = (ts >= r) & (ts - r < M)
    collect = valid & (r == pp - 1)
    state = torch.zeros_like(x_microbatches.select(mbd, 0))
    outs = [torch.zeros_like(state) for _ in range(M)]
    for t in range(steps):
        inp = x_microbatches.select(mbd, min(t, M - 1))
        cur = torch.where(first, inp, state)
        y = stage_fn(stage_params, cur)
        y = torch.where(valid[t], y, 0.0)
        oidx = max(t - (pp - 1), 0)
        outs[oidx] = torch.where(collect[t], y, outs[oidx])
        state = ax.ppermute_next(y, "pp")
    return torch.stack(outs, dim=mbd)
