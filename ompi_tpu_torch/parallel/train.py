"""The flagship training step: dp × pp × sp × tp over the virtual ranks.

Port of ``ompi_tpu/parallel/train.py``.  The reference jits one
``shard_map`` over a 4-axis device mesh; here the step runs eagerly on
per-rank tensors ``(dp, pp, sp, tp, *local)`` (``parallel/mesh.py``), so
one kernel launch serves every rank:

- activations sharded (dp: batch, sp: sequence), weights sharded (pp:
  layers, tp: hidden/heads/experts), each parameter a per-rank leaf tensor
  (real copies on the ranks it is replicated over);
- the loss is the reference's tp-0-masked sum over all ranks, and autograd
  of that one scalar gives every copy its gradient.  A leaf replicated over
  some axes is one parameter held in copies; its gradient is the sum over
  its copies, held by each copy — what the reference's autodiff gives a
  replicated input under ``check_vma`` (the transpose of the implicit
  broadcast is a psum).  The explicit syncs then run on those sums as the
  reference writes them: psum over (dp, sp), ``wr`` over tp, the bucketed
  form, or ZeRO-1's reduce-scatter.  A psum of a value every rank holds
  alike multiplies it by the axis size, there as here, so the update is
  dp·sp times the loss's gradient (``wr``: dp·sp·tp times); the port keeps
  that for parity (ROADMAP C).

Model dims are derived from the mesh spec so every axis size divides its
tensor dims, as in the reference.

The step takes its axis set from the mesh (``axes.for_mesh``): the
collectives over ``mesh.names``, or, on a process's block of a global mesh
(``mesh.process_block``, the multi-process device world), the set whose
spanning axes cross the process group.  ``shard`` places a process's
block only; ``gather`` takes the mesh, as ``shard`` does, and reads a
whole mesh.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.parallel import axes
from ompi_tpu_torch.parallel.mesh import AXES, MeshSpec
from ompi_tpu_torch.parallel.model import transformer_block
from ompi_tpu_torch.parallel.pipeline import pipeline_apply

_sp_impl_var = registry.register(
    "parallel", None, "sp_impl", vtype=VarType.STRING, default="ring",
    enum_values={"ring": 0, "ulysses": 1},
    help="Sequence/context-parallel attention scheme: 'ring' (K/V rotation "
         "around the sp axis, O(s_local) memory) or 'ulysses' (all-to-all "
         "head<->seq reshard, 2 collectives; local heads must divide sp)")

_causal_var = registry.register(
    "parallel", None, "causal", vtype=VarType.BOOL, default=False,
    help="Autoregressive (causal) attention masking at GLOBAL sequence "
         "positions — ring attention builds the per-step block bias "
         "from the shard offsets; ulysses masks the full sequence "
         "after its reshard")

_remat_var = registry.register(
    "parallel", None, "remat", vtype=VarType.BOOL, default=False,
    help="Rematerialize each transformer block in the backward pass "
         "(torch.utils.checkpoint): activation memory drops from all layers' "
         "intermediates to one block's, paying ~1/3 more FLOPs")

_zero1_var = registry.register(
    "parallel", None, "zero1", vtype=VarType.BOOL, default=False,
    help="ZeRO-1 distributed optimizer: gradients reduce-scatter over "
         "dp (instead of allreduce), each dp rank updates its 1/dp "
         "parameter slice + momentum shard, and the updated slices "
         "rebuild via an exact masked psum — optimizer state memory "
         "drops by dp")

_bucket_var = registry.register(
    "parallel", None, "bucket_overlap", vtype=VarType.BOOL, default=False,
    help="Bucketed dp-gradient sync: one psum per local-layer bucket issued "
         "late-layer-first instead of one whole-tree psum — bit-identical "
         "parameters to the single-psum path "
         "(parallel/dryrun.py run_bucket_overlap_check pins it)")

_momentum_var = registry.register(
    "parallel", None, "momentum", vtype=VarType.FLOAT, default=0.0,
    help="SGD momentum for the flagship step (state is dp-sharded "
         "under parallel_zero1)")

_compute_dtype_var = registry.register(
    "parallel", None, "compute_dtype", vtype=VarType.STRING,
    default="float32", enum_values={"float32": 0, "bfloat16": 1},
    help="Block compute precision: bfloat16 halves activation bytes "
         "(params stay float32 storage; cast at block entry, loss/grads "
         "accumulate in float32)")


def model_dims(spec: MeshSpec, layers: int = None) -> dict:
    """``layers`` defaults to one per pipeline stage; override (a multiple
    of pp) to hold model depth fixed across mesh specs.

    ``OTPU_MODEL_SCALE`` multiplies the width/sequence dims (default 1: the
    scale of the correctness tests); the reference's bench measures this
    program at 64."""
    scale = max(1, int(os.environ.get("OTPU_MODEL_SCALE", "1") or 1))
    tp, sp, dp, pp = spec.tp, spec.sp, spec.dp, spec.pp
    L = pp if layers is None else int(layers)
    if L % pp:
        raise ValueError(f"layers={L} not divisible by pp={pp}")
    d = 8 * scale
    hd = 4 * scale
    n_heads = 2 * tp
    ff = 8 * tp * scale
    n_experts = 2 * tp
    ffe = 4 * scale
    s_local = 4 * scale
    M = 2                      # microbatches
    mb = tp                    # microbatch rows per rank (keeps MoE even)
    t_local = mb * s_local     # MoE tokens per rank per microbatch
    cap = max(1, (t_local // tp) // n_experts * 2)
    return dict(
        d=d, hd=hd, n_heads=n_heads, h_local=n_heads // tp, ff=ff,
        n_experts=n_experts, ffe=ffe, seq=s_local * sp, s_local=s_local,
        M=M, mb=mb, batch=mb * M * dp, b_local=mb * M, capacity=cap,
        layers=L, layers_local=L // pp,
    )


def init_params(spec: MeshSpec, seed: int = 0, layers: int = None) -> dict:
    """Global float32 numpy parameters, the reference's bytes."""
    dims = model_dims(spec, layers)
    rng = np.random.RandomState(seed)
    d, L = dims["d"], dims["layers"]
    hh = dims["n_heads"] * dims["hd"]

    def w(*shape):
        return rng.normal(0, 0.5 / np.sqrt(shape[-2]), shape).astype(
            np.float32)

    return {
        "wq": w(L, d, hh), "wk": w(L, d, hh), "wv": w(L, d, hh),
        "wo": w(L, hh, d),
        "w1": w(L, d, dims["ff"]), "w2": w(L, dims["ff"], d),
        "wr": w(L, d, dims["n_experts"]),
        "we1": w(L, dims["n_experts"], d, dims["ffe"]),
        "we2": w(L, dims["n_experts"], dims["ffe"], d),
    }


def param_specs() -> dict:
    """The mesh axis each dim of a leaf is split over (None: whole)."""
    return {
        "wq": ("pp", None, "tp"), "wk": ("pp", None, "tp"),
        "wv": ("pp", None, "tp"), "wo": ("pp", "tp", None),
        "w1": ("pp", None, "tp"), "w2": ("pp", "tp", None),
        "wr": ("pp", None, None),
        "we1": ("pp", "tp", None, None), "we2": ("pp", "tp", None, None),
    }


#: the input's split: batch over dp, sequence over sp
X_SPEC = ("dp", "sp", None)


def shard(a, spec: tuple, mesh) -> torch.Tensor:
    """A global array (numpy, or a tensor whose autograd graph is kept) as
    a per-rank tensor on ``mesh.device``: each dim split over its axis in
    ``spec``, real copies on the other axes."""
    t = torch.as_tensor(a, dtype=torch.float32)
    shape, at = [], {}
    for size, ax in zip(t.shape, spec):
        if ax is None:
            shape.append(size)
        else:
            at[ax] = len(shape)
            shape += [mesh.shape[ax], size // mesh.shape[ax]]
    t = t.reshape(shape)
    split = [at[a] for a in mesh.names if a in at]
    t = t.permute(split + [i for i in range(len(shape)) if i not in split])
    local = t.shape[len(split):]
    t = t.reshape([mesh.shape[a] if a in at else 1 for a in mesh.names]
                  + list(local))
    if mesh.block is not None:
        # a process's block: its slice of each split axis
        t = t[tuple(slice(o, o + b) if a in at else slice(None)
                    for a, o, b in zip(mesh.names, mesh.local_origin,
                                       mesh.local_dims))]
    return t.to(mesh.device).expand(*mesh.local_dims, *local).contiguous()


def gather(t: torch.Tensor, spec: tuple, mesh=None) -> np.ndarray:
    """The global array of a per-rank tensor over the axes of ``mesh``
    (default: the dense ``AXES``; rank 0's copy on the axes it is
    replicated over).  A process's block is not the whole mesh: it
    raises."""
    if mesh is not None and mesh.local_dims != mesh.dims:
        raise ValueError("gather reads a whole mesh, not a process's block")
    names = AXES if mesh is None else mesh.names
    t = t.detach()[tuple(slice(None) if a in spec else 0 for a in names)]
    kept = [a for a in names if a in spec]
    perm, shape = [], []
    for dim, ax in enumerate(spec):
        size = t.shape[len(kept) + dim]
        if ax is None:
            perm.append(len(kept) + dim)
            shape.append(size)
        else:
            perm += [kept.index(ax), len(kept) + dim]
            shape.append(size * t.shape[kept.index(ax)])
    return cudaenv.to_numpy(t.permute(perm).reshape(shape))


def gather_params(params: dict, mesh=None) -> dict:
    """Per-rank parameters back as the global numpy arrays."""
    specs = param_specs()
    return {k: gather(v, specs[k], mesh) for k, v in params.items()}


def _replicated(spec: tuple) -> tuple:
    return tuple(a for a in AXES if a not in spec)


def build_train_step(mesh, spec: MeshSpec, lr: float = 1e-4,
                     layers: int = None, use_flash=None):
    """Return ``(step, place)`` where ``step(params, x) -> (params, loss)``.

    ``place(params, x_np)`` turns global numpy parameters and input into
    per-rank tensors on the mesh's device (``((params, m), x)`` under
    ZeRO-1).  ``use_flash`` is ring attention's switch (None: K21 on the
    card, its plain version on the CPU)."""
    ax = axes.for_mesh(mesh)
    nd = ax.ndim
    dims = model_dims(spec, layers)
    tp, sp_n, pp, dp = spec.tp, spec.sp, spec.pp, spec.dp
    M, mb, s_l, d = dims["M"], dims["mb"], dims["s_local"], dims["d"]
    sp_impl = str(_sp_impl_var.value)
    causal = bool(_causal_var.value)
    compute_dtype = getattr(torch, str(_compute_dtype_var.value))
    pspecs = param_specs()
    names = sorted(pspecs)       # ravel_pytree's order: sorted dict keys

    def apply_block(x_mb, *leaves):
        layer = dict(zip(names, leaves))
        if compute_dtype != torch.float32:
            # params cast per block (storage stays float32), activations
            # stay in compute_dtype across the stack
            layer = {k: v.to(compute_dtype) for k, v in layer.items()}
        return transformer_block(
            layer, x_mb, sp=sp_n, tp=tp, n_heads_local=dims["h_local"],
            n_experts=dims["n_experts"], capacity=dims["capacity"],
            sp_impl=sp_impl, causal=causal, use_flash=use_flash, ax=ax)

    remat = bool(_remat_var.value)

    def stage_fn(stage_params, x_mb):
        for i in range(dims["layers_local"]):
            leaves = [stage_params[k].select(nd, i) for k in names]
            if remat:
                # recompute the block in the backward instead of storing
                # its activations
                x_mb = torch.utils.checkpoint.checkpoint(
                    apply_block, x_mb, *leaves, use_reentrant=False)
            else:
                x_mb = apply_block(x_mb, *leaves)
        return x_mb

    zero1 = bool(_zero1_var.value)
    mu = float(_momentum_var.value)
    if mu and not zero1:
        raise ValueError(
            "parallel_momentum is implemented by the ZeRO-1 sharded "
            "optimizer state — set --mca parallel_zero1 1 with it "
            "(a silently momentum-free run would corrupt comparisons)")
    bucket_overlap = bool(_bucket_var.value)
    if bucket_overlap and zero1:
        raise ValueError(
            "parallel_bucket_overlap buckets the dp ALLREDUCE; ZeRO-1 "
            "already reduce-scatters the dp sum — the combination is "
            "unsupported (a silent fallback would corrupt comparisons)")

    def bucketed_dp_sync(g):
        """Per-local-layer psum buckets, LATE layer first; an elementwise
        psum over the same ranks makes each bucket bit-identical to its
        slice of the whole-leaf psum."""
        n = g.shape[nd]
        parts = [ax.psum(g.select(nd, i), ("dp", "sp"))
                 for i in range(n - 1, -1, -1)]
        return torch.stack(parts[::-1], dim=nd)

    def loss_fn(ps, x):
        # activations enter the pipeline in compute_dtype
        xmb = x.reshape(*x.shape[:nd], M, mb, s_l, d).to(compute_dtype)
        y = pipeline_apply(stage_fn, ps, xmb, pp=pp, ax=ax)
        # outputs are zero off the last pp stage; count the tp-0 replica
        yf = y.float()
        local = 0.5 * (yf * yf).sum(dim=tuple(range(nd, yf.dim())))
        local = torch.where(ax.axis_index(local, "tp") == 0, local, 0.0)
        return ax.psum(local, AXES).reshape(-1)[0]

    def step(state, x):
        params, m = state if zero1 else (state, None)
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        loss = loss_fn(leaves, x)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            # each copy's gradient -> the sum over the leaf's copies
            grads = {k: ax.psum(g, _replicated(pspecs[k]))
                     for k, g in zip(names, grads)}
            if not zero1:
                for k in names:
                    grads[k] = (bucketed_dp_sync(grads[k]) if bucket_overlap
                                else ax.psum(grads[k], ("dp", "sp")))
                if tp > 1:
                    grads["wr"] = ax.psum(grads["wr"], "tp")
                new = {k: params[k] - lr * grads[k] for k in names}
                return new, loss.detach()
            new, m_new = _zero1_update(params, grads, m)
        return (new, m_new), loss.detach()

    def _zero1_update(params, grads, m):
        """ZeRO-1: the dp sum rides a reduce-scatter, each dp rank owns
        1/dp of the flat parameter/momentum state, and the updated slices
        come back through an exact masked psum."""
        grads = {k: ax.psum(g, "sp") for k, g in grads.items()}
        if tp > 1:
            grads["wr"] = ax.psum(grads["wr"], "tp")
        mesh_shape = grads[names[0]].shape[:nd]
        gflat = torch.cat([grads[k].flatten(nd) for k in names], dim=-1)
        total = gflat.shape[-1]
        chunk = -(-total // dp)
        gpad = F.pad(gflat, (0, chunk * dp - total))
        gsl = ax.psum_scatter(gpad.reshape(*mesh_shape, dp, chunk), "dp", 0)
        m_new = mu * m + gsl
        mine = ax.axis_index(gsl, "dp", 1) == torch.arange(
            dp, device=gsl.device)                     # (*mesh, dp): slot r
        contrib = torch.where(mine[..., None], (-lr * m_new)[..., None, :],
                              torch.zeros((), device=gsl.device))
        delta = ax.psum(contrib.reshape(*mesh_shape, dp * chunk), "dp")
        delta = delta[..., :total]
        dtree, at = {}, 0
        for k in names:
            local = params[k].shape[nd:]
            size = math.prod(local)
            dtree[k] = delta[..., at:at + size].reshape(*mesh_shape, *local)
            at += size
        tp0 = ax.axis_index(gsl, "tp", 0) == 0
        for k in names:
            if "tp" not in pspecs[k]:
                # exact: only tp rank 0 contributes
                t0 = tp0.reshape(*tp0.shape, *[1] * (dtree[k].dim() - 4))
                dtree[k] = ax.psum(torch.where(t0, dtree[k], 0.0), "tp")
        return {k: params[k] + dtree[k] for k in names}, m_new

    def place(params, x_np):
        p = {k: shard(params[k], pspecs[k], mesh) for k in names}
        x = shard(x_np, X_SPEC, mesh)
        if zero1:
            # each rank's flat local parameter count, split over dp
            total = sum(math.prod(v.shape[nd:]) for v in p.values())
            m0 = torch.zeros(*mesh.local_dims, -(-total // dp),
                             device=mesh.device)
            return (p, m0), x
        return p, x

    return step, place
