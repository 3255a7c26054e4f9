"""parallel/moe — expert parallelism: the gating and the device tier.

Port of ``ompi_tpu/parallel/moe.py``'s gating (``:102-227``) and device
tier (``:445-778``):

- **Gating is a pure function** (:func:`plan_step`): integer hash scores,
  strict top-k with a deterministic tie-break, and global-token-order
  capacity assignment, numpy only, so the port's plans are the reference's
  plans (the dispatch wire protocol carries no metadata: a receiver
  recomputes the sender's plan).
- **The expert-parallel step** (:func:`build_moe_train_step`) runs the
  reference's ``shard_map`` step over a ``(dp, …, expert)`` mesh on per-rank
  tensors ``(dp, pp, sp, tp, expert, *local)`` (``parallel/mesh.py``): the
  expert FFN sharded over ``expert``, dispatch and return as all-to-alls
  over it (``parallel/axes.py``), gradients by autograd of the
  expert-0-masked loss and the reference's explicit psums.
- **The expert FFN's fused form** (:func:`expert_ffn_fused`) goes through
  coll/tuned's device cell (``matmul_allreduce``, K20 in
  ``ops/overlap.py``), else the reference's own unfused einsum.
- **Dispatch** (:func:`dispatch_tokens`) rides the comm's
  ``alltoallv_array`` slot (coll/ring: K15), int8-packed into an int32 slab
  when the comm's ``otpu_quant_budget`` admits coll/quant's int8 codec,
  recording ``n * n`` ``quant_encodes`` and ``quant_decodes`` SPC counts
  as the reference does (``moe.py:726``, ``:730``).

Not ported yet (they need the fault-tolerance tier):
``MoeTrainer``, ``main`` and the ``moe`` telemetry source, and with them
the six ``otpu_moe_*`` vars only the trainer reads (``n_experts``,
``top_k``, ``drop_policy``, ``hot_expert``, ``hot_boost``,
``compute_us_per_token``); the device tier reads ``capacity_factor``.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.parallel import axes as axes_mod
from ompi_tpu_torch.parallel.elastic import (DEFAULT_LR, _P1, _P2, _P3,
                                             grad_field)
from ompi_tpu_torch.parallel.mesh import EXPERT_AXIS, MeshSpec, make_mesh
from ompi_tpu_torch.parallel.model import gelu

_capacity_factor_var = registry.register(
    "moe", None, "capacity_factor", vtype=VarType.FLOAT, default=1.25,
    help="Per-expert capacity = ceil(factor * tokens * top_k / "
         "n_experts); tokens routed past a full expert are dropped "
         "(they keep the residual path)")


# -- gating: a pure, hash-seeded function of (step, tokens, experts) -----

class Assign(NamedTuple):
    token: int      # global token index
    slot: int       # which of the token's top-k choices this is
    expert: int
    weight: float   # dyadic gate weight (exact in f64)
    pos: int        # row within the expert's capacity buffer


@dataclass(frozen=True)
class DispatchPlan:
    """One step's complete routing decision — identical on every process
    by construction, so it IS the wire protocol."""
    step: int
    tokens: int
    n_experts: int
    top_k: int
    capacity: int
    kept: tuple         # Assign rows, global (token, slot) order
    dropped: tuple      # (token, expert) pairs past capacity
    loads: tuple        # kept rows per expert

    def imbalance(self) -> float:
        """max-expert-load / mean-load (1.0 = perfectly balanced)."""
        loads = np.asarray(self.loads, np.float64)
        mean = float(loads.mean()) if loads.size else 0.0
        return float(loads.max() / mean) if mean > 0 else 1.0

    def to_json(self) -> str:
        return json.dumps({
            "step": self.step, "capacity": self.capacity,
            "kept": [list(a) for a in self.kept],
            "dropped": [list(p) for p in self.dropped],
            "loads": list(self.loads)})


def gate_weights(top_k: int) -> tuple:
    """Dyadic gate weights: ``2^-(i+1)`` per slot with the tail ``2^-k``
    folded into slot 0 — they sum to exactly 1."""
    k = int(top_k)
    w = [2.0 ** -(i + 1) for i in range(k)]
    w[0] += 2.0 ** -k
    return tuple(w)


def capacity_for(tokens: int, n_experts: int, top_k: int,
                 factor: float) -> int:
    return max(1, int(math.ceil(
        float(factor) * int(tokens) * int(top_k) / int(n_experts))))


def gate_scores(step: int, tokens: int, n_experts: int, seed: int = 0,
                hot_expert: int = -1, hot_boost: float = 0.0):
    """Integer (tokens, n_experts) score table: pure modular arithmetic
    over int64, so neither PYTHONHASHSEED nor the platform perturbs
    routing."""
    t = np.arange(int(tokens), dtype=np.int64)[:, None]
    e = np.arange(int(n_experts), dtype=np.int64)[None, :]
    a = (int(step) * _P1 + (t * n_experts + e) * _P2 + e * _P3
         + int(seed) * 13) % 997
    # quadratic mixing: the linear residue alone leaves per-token expert
    # rankings an arithmetic progression mod 997
    s = (a * (a + 7)) % 997
    if hot_expert is not None and 0 <= int(hot_expert) < int(n_experts) \
            and hot_boost > 0:
        boosted = ((t[:, 0] * _P3 + int(seed) * 7) % 1000) \
            < int(round(float(hot_boost) * 1000))
        s[boosted, int(hot_expert)] = 1_000_000
    return s


def plan_step(step: int, tokens: int, n_experts: int, top_k: int,
              capacity_factor: float, seed: int = 0,
              hot_expert: int = -1,
              hot_boost: float = 0.0) -> DispatchPlan:
    """Gate + capacity-assign one step.  Tie-break is total: tokens prefer
    the lower expert id at equal score, and capacity slots fill in global
    (token, slot) order — there is exactly one valid plan."""
    T, E, k = int(tokens), int(n_experts), int(top_k)
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} must be in [1, {E}]")
    s = gate_scores(step, T, E, seed, hot_expert, hot_boost)
    # one key encodes (score desc, expert-id asc): argsort stays total
    key = s * E + (E - 1 - np.arange(E, dtype=np.int64))[None, :]
    order = np.argsort(-key, axis=1, kind="stable")[:, :k]
    wts = gate_weights(k)
    cap = capacity_for(T, E, k, capacity_factor)
    fill = [0] * E
    kept, dropped = [], []
    for t in range(T):
        for i in range(k):
            e = int(order[t, i])
            if fill[e] < cap:
                kept.append(Assign(t, i, e, wts[i], fill[e]))
                fill[e] += 1
            else:
                dropped.append((t, e))
    return DispatchPlan(step, T, E, k, cap, tuple(kept), tuple(dropped),
                        tuple(fill))


def token_grad(step: int, token: int, dims: int,
               seed: int = 0) -> np.ndarray:
    """Per-token integer gradient row — ``elastic.grad_field`` for the
    single sample [token, token+1)."""
    return grad_field(step, token, token + 1, dims, seed)


def reference_moe_run(w0: np.ndarray, from_step: int, to_step: int, *,
                      tokens: int, n_experts: int, expert_dim: int,
                      top_k: int = 2, capacity_factor: float = 1.25,
                      lr: float = DEFAULT_LR, seed: int = 0,
                      hot_expert: int = -1,
                      hot_boost: float = 0.0) -> np.ndarray:
    """Failure-free single-process replay — the oracle an expert-sharded
    MoE run must match bit for bit."""
    w = np.array(w0, np.float64, copy=True).reshape(n_experts, expert_dim)
    for s in range(int(from_step), int(to_step)):
        plan = plan_step(s, tokens, n_experts, top_k, capacity_factor,
                         seed, hot_expert, hot_boost)
        upd = np.zeros_like(w)
        for a in plan.kept:
            upd[a.expert] += token_grad(s, a.token, expert_dim, seed) \
                * a.weight
        w -= lr * upd
    return w.ravel()


# -- device tier: expert-sharded FFN over the expert mesh axis ----------

def moe_model_dims(spec: MeshSpec, top_k: int = None,
                   capacity_factor: float = None) -> dict:
    """Tracing-scale dims derived from the mesh spec so ep always divides
    the expert count and the per-shard token chunk (the reference's)."""
    ep = spec.ep
    E = 2 * ep
    k = int(top_k if top_k is not None else min(2, E))
    cf = float(capacity_factor if capacity_factor is not None
               else _capacity_factor_var.value)
    tc = 4                       # tokens per expert-shard chunk
    cap = max(1, int(math.ceil(cf * tc * k / E)))
    return dict(d=8, ff=16, n_experts=E, e_local=E // ep, top_k=k,
                capacity=cap, t_local=tc * ep, tokens=tc * ep * spec.dp)


def init_moe_params(spec: MeshSpec, seed: int = 0) -> dict:
    """Global float32 numpy parameters, the reference's bytes."""
    dims = moe_model_dims(spec)
    rng = np.random.RandomState(seed)

    def w(*shape):
        return rng.normal(0, 0.5 / np.sqrt(shape[-2]), shape).astype(
            np.float32)

    return {"wr": w(dims["d"], dims["n_experts"]),
            "we1": w(dims["n_experts"], dims["d"], dims["ff"]),
            "we2": w(dims["n_experts"], dims["ff"], dims["d"])}


def moe_param_specs(spec: MeshSpec) -> dict:
    """The mesh axis each dim of a leaf is split over (None: whole)."""
    ex = EXPERT_AXIS if spec.ep > 1 else None
    return {"wr": (None, None), "we1": (ex, None, None),
            "we2": (ex, None, None)}


#: the input's split: tokens over dp, replicated over expert
X_SPEC = ("dp", None)


def top_k_indices(probs: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(probs, k)``'s indices: descending, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def moe_ep_block(p, x, *, ep: int, n_experts: int, capacity: int,
                 top_k: int, mesh_axes: axes_mod.MeshAxes):
    """Top-k expert-parallel FFN block on per-rank tensors.

    ``x`` is ``(*mesh, t_local, d)``, replicated over the expert axis;
    ``p['we1']``/``p['we2']`` are the ``(*mesh, E/ep, ...)`` local expert
    shards.  Each expert rank routes its chunk of the tokens, dispatch and
    return ride all-to-alls over ``expert``, and the chunks are
    re-replicated with an all-gather.  Routing bookkeeping is float32;
    positions past capacity are clamped into the one-hot and zeroed by the
    ``keep`` mask (``jax.nn.one_hot`` gives a zero row there), so dropped
    tokens keep the residual path."""
    ax = mesh_axes
    mesh = x.shape[:ax.ndim]
    d = x.shape[-1]
    E, cap, k = int(n_experts), int(capacity), int(top_k)
    e_l = E // ep
    chunk = ax.take_own(x, EXPERT_AXIS, 0) if ep > 1 else x   # (*mesh, tc, d)
    logits = torch.matmul(chunk, p["wr"]).float()             # (*mesh, tc, E)
    probs = torch.softmax(logits, dim=-1)
    oh = F.one_hot(top_k_indices(probs, k), E).float().sum(-2)
    pos = (torch.cumsum(oh, dim=-2) - 1.0) * oh
    keep = oh * (pos < cap)
    pos_oh = F.one_hot(pos.long().clamp(0, cap - 1), cap).float()
    disp = keep[..., None] * pos_oh                           # (.., tc, E, cap)
    ex_in = torch.einsum("...tec,...td->...ecd", disp, chunk.float())
    if ep > 1:
        ex_in = ex_in.reshape(*mesh, ep, e_l, cap, d)
        ex_in = ax.all_to_all(ex_in, EXPERT_AXIS, 0, 0)       # dim 0: source
        ex_in = ex_in.transpose(-4, -3).reshape(*mesh, e_l, ep * cap, d)
    else:
        ex_in = ex_in.reshape(*mesh, e_l, cap, d)
    hid = gelu(torch.einsum("...ncd,...ndf->...ncf", ex_in, p["we1"].float()))
    out = torch.einsum("...ncf,...nfd->...ncd", hid, p["we2"].float())
    if ep > 1:
        out = out.reshape(*mesh, e_l, ep, cap, d).transpose(-4, -3)
        out = ax.all_to_all(out, EXPERT_AXIS, 0, 0)           # dim 0: home
    ex_out = out.reshape(*mesh, E, cap, d)
    gates = probs * keep
    comb = torch.einsum("...tec,...ecd,...te->...td", disp, ex_out, gates)
    if ep > 1:
        comb = ax.all_gather(comb, EXPERT_AXIS, 0)
    return x + comb.to(x.dtype)


def build_moe_train_step(mesh, spec: MeshSpec, lr: float = 0.02):
    """Return ``(step, place)``: ``step(params, x) -> (params, loss)`` over
    the (dp, expert) axes of ``mesh`` (from ``make_mesh`` with ``spec.ep >
    1``; ep == 1 degrades to plain dp).

    The loss is the reference's: ``0.5·Σy²`` counted on expert rank 0 (y is
    replicated over expert) and summed over (dp, expert).  Autograd of that
    one scalar gives every copy of a leaf its gradient; the sum over the
    copies is what the reference's autodiff gives a replicated input, and
    the explicit psums follow as the reference writes them: every leaf over
    dp, ``wr`` over expert as well (``moe.py:546-583``).  ``place(params,
    x_np)`` turns ``init_moe_params``' arrays and the global tokens into
    per-rank tensors on the mesh's device: ``we1``/``we2`` sharded on
    expert, ``wr`` replicated, the tokens split over dp."""
    from ompi_tpu_torch.parallel.train import shard

    dims = moe_model_dims(spec)
    ep = spec.ep
    ax = axes_mod.MeshAxes(mesh.names)
    sync = ("dp", EXPERT_AXIS) if ep > 1 else ("dp",)
    pspecs = moe_param_specs(spec)
    names = sorted(pspecs)

    def loss_fn(ps, x):
        y = moe_ep_block(ps, x, ep=ep, n_experts=dims["n_experts"],
                         capacity=dims["capacity"], top_k=dims["top_k"],
                         mesh_axes=ax)
        yf = y.float()
        local = 0.5 * (yf * yf).sum(dim=tuple(range(ax.ndim, yf.dim())))
        if ep > 1:
            # y is replicated over expert: count replica 0 only
            local = torch.where(ax.axis_index(local, EXPERT_AXIS) == 0,
                                local, 0.0)
        return ax.psum(local, sync).reshape(-1)[0]

    def step(params, x):
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        loss = loss_fn(leaves, x)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            # each copy's gradient -> the sum over the leaf's copies
            grads = {k: ax.psum(g, tuple(a for a in mesh.names
                                         if a not in pspecs[k]))
                     for k, g in zip(names, grads)}
            grads = {k: ax.psum(g, "dp") for k, g in grads.items()}
            if ep > 1:
                # wr is expert-replicated; its grad arrives per token
                # chunk, one chunk per expert shard: sum them
                grads["wr"] = ax.psum(grads["wr"], EXPERT_AXIS)
            new = {k: params[k] - lr * grads[k] for k in names}
        return new, loss.detach()

    def place(params, x_np):
        p = {k: shard(params[k], pspecs[k], mesh) for k in names}
        return p, shard(np.asarray(x_np, np.float32), X_SPEC, mesh)

    return step, place


def gather_moe_params(params: dict, spec: MeshSpec, mesh) -> dict:
    """Per-rank parameters back as the global numpy arrays."""
    from ompi_tpu_torch.parallel.train import gather

    pspecs = moe_param_specs(spec)
    return {k: gather(v, pspecs[k], mesh.names) for k, v in params.items()}


def run_moe_training_step(device=None, spec: MeshSpec = None,
                          steps: int = 3) -> list:
    """Dryrun: the expert-parallel step descends and is BIT-STABLE — two
    fresh builds give identical loss curves.  The mesh spans the world's
    virtual ranks (default ep = 4 where it divides them, dp the rest) on
    ``device``: the card unless the caller names another."""
    n = cudaenv.virtual_ranks()
    if spec is None:
        ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
        spec = MeshSpec(dp=n // ep, ep=ep)
    mesh, spec = make_mesh(n, spec, device=device)
    dims = moe_model_dims(spec)
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1.0, (dims["tokens"], dims["d"])).astype(np.float32)
    curves = []
    for _trial in range(2):
        step, place = build_moe_train_step(mesh, spec)
        params, xd = place(init_moe_params(spec), x)
        losses = []
        for _s in range(int(steps)):
            params, loss = step(params, xd)
            losses.append(float(loss))
        curves.append(losses)
    if not all(np.isfinite(curves[0])):
        raise RuntimeError(f"moe dryrun loss not finite: {curves[0]}")
    if not curves[0][-1] < curves[0][0]:
        raise RuntimeError(f"moe dryrun loss did not descend: {curves[0]}")
    if curves[0] != curves[1]:
        raise RuntimeError(
            f"moe dryrun loss not bit-stable across builds: "
            f"{curves[0]} vs {curves[1]}")
    print(f"moe dryrun ok: mesh={spec.sizes()} "
          f"experts={dims['n_experts']} cap={dims['capacity']} "
          f"loss {curves[0][0]:.6f} -> {curves[0][-1]:.6f}")
    return curves[0]


def expert_ffn_fused(a, b, device=None):
    """Expert-sharded GEMM with its reduction epilogue through coll/tuned's
    device cell (``ops/overlap.matmul_allreduce``, K20) when the ladder
    admits it, else the reference's unfused ``einsum("nmk,nko->mo")`` — the
    var's explicit choice (``otpu_coll_tuned_fused_cells``), not a
    fallback: with the var empty a card runs K20, and a build or launch
    failure raises.  ``a``: ``(n, M, K/n)`` expert-sharded activations,
    ``b``: ``(n, K/n, N)`` matching weight shards; returns ``(M, N)``.
    Tensors stay on their device; arrays go to ``device`` (the card unless
    the caller names another)."""
    from ompi_tpu_torch.mca.coll import tuned

    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        dev = cudaenv.resolve_device(device)
        a, b = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    cell = tuned.device_cell("matmul_allreduce")
    if cell is not None:
        return cell(a, b, a.shape[0])
    return torch.einsum("nmk,nko->mo", a, b)


# -- quantized dispatch: coll/quant's codec on the ragged device slot -----

#: scale lanes appended per row by the int8 dispatch packing (holds up to
#: 128 block scales, i.e. payload widths up to 16384)
_SCALE_PAD = 128


def encode_dispatch_int8(x) -> torch.Tensor:
    """Pack float32 token rows for the ragged device slot: per-128-block
    int8 quantization (round-half-even, ``x · 127/absmax``; scales
    ``absmax/127``) with the int8 lanes bitcast 4 to an int32 in
    little-endian lane order and the block scales appended as float32 bits
    padded to 128 lanes, so the payload is a plain int32 slab the ``*v``
    kernels move unchanged.  The wire dtype is INTEGER on purpose: int8
    lane groups read as float32 form NaN payloads that a transport hop may
    canonicalize.  ``(..., R, W) -> (..., R, W/4 + 128)``; W % 512 == 0."""
    x = torch.as_tensor(x).to(torch.float32)
    lead, (R, W) = x.shape[:-2], x.shape[-2:]
    if W % 512:
        raise ValueError(f"int8 dispatch packing needs width % 512 "
                         f"== 0, got {W}")
    nb = W // 128
    if nb > _SCALE_PAD:
        raise ValueError(f"width {W} exceeds the {_SCALE_PAD}-block "
                         "scale budget")
    blocks = x.reshape(*lead, R, nb, 128)
    amax = blocks.abs().amax(dim=-1)
    inv = torch.where(amax > 0, 127.0 / amax, 0.0)
    q = torch.round(blocks * inv[..., None]).to(torch.int8)
    qi = q.reshape(*lead, R, W).view(torch.int32)            # (..., R, W/4)
    scales = F.pad(amax / 127.0, (0, _SCALE_PAD - nb))
    return torch.cat([qi, scales.view(torch.int32)], dim=-1)


def decode_dispatch_int8(y, width: int) -> torch.Tensor:
    """Inverse of :func:`encode_dispatch_int8` for rows of original width
    ``width``; accepts any ``(..., R', W/4 + 128)`` slab (R' may be a
    ragged count slice)."""
    y = torch.as_tensor(y).to(torch.int32)
    W = int(width)
    nb = W // 128
    q = y[..., :W // 4].contiguous().view(torch.int8)        # (..., W)
    q = q.reshape(*y.shape[:-1], nb, 128)
    scales = y[..., W // 4:W // 4 + nb].contiguous().view(torch.float32)
    out = q.float() * scales[..., None]
    return out.reshape(*y.shape[:-1], W)


def dispatch_tokens(comm, x, counts):
    """MoE token dispatch over the comm's ragged device slot
    (``alltoallv_array``; on coll/ring, K15).

    When the comm carries an ``otpu_quant_budget`` info key admitting int8
    (coll/quant's ladder), rows cross the wire block-int8 packed and are
    decoded on arrival.  Returns ``(outs, codec)`` where ``outs[i][j]`` is
    the ``(counts[j][i], W)`` float32 block rank i received from rank j and
    ``codec`` is the engaged codec or None.  ``x`` is a tensor on the
    comm's device or an array placed there."""
    from ompi_tpu_torch.mca.coll import quant as quant_mod
    from ompi_tpu_torch.runtime import spc

    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
    else:
        x = cudaenv.make_world_array(np.asarray(x, np.float32),
                                     comm.rte.device)
    n, R, W = x.shape[0], int(x.shape[2]), int(x.shape[3])
    codec = quant_mod.pick(comm, "alltoallv", torch.float32,
                           x.numel() * x.element_size())
    if codec != "int8" or W % 512 or R == 0:
        return comm.alltoallv_array(x, counts), None
    enc = encode_dispatch_int8(x)
    spc.record("quant_encodes", n * n)
    outs = comm.alltoallv_array(enc, counts)
    dec = [[decode_dispatch_int8(outs[i][j], W) for j in range(n)]
           for i in range(n)]
    spc.record("quant_decodes", n * n)
    return dec, codec


def run_quant_dispatch_check(nranks: int = 4, sizes=(1 << 14, 1 << 16),
                             band: float = None, device=None) -> dict:
    """Acceptance for the quantized dispatch: the int8-packed path through
    the ragged exchange (``ops.ring_collectives.all_to_all_v``: K15 on the
    card, its plain version on the CPU) must stay inside the int8 band
    (``dryrun.run_tolerance_check`` names any failing cell).  The exact
    reference is the dispatch permutation itself, ``out[j, i] = x[i,
    j]``."""
    from ompi_tpu_torch.mca.coll import quant as quant_mod
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.parallel import dryrun

    band = float(band if band is not None else quant_mod.CODEC_BANDS["int8"])
    W = 512
    dev = cudaenv.resolve_device(device)

    def exact(stack):
        n, size = stack.shape
        x = stack.reshape(n, n, size // (n * W), W)
        return np.swapaxes(x, 0, 1).reshape(n, size)

    def approx(stack):
        n, size = stack.shape
        R = size // (n * W)
        x = torch.from_numpy(stack.reshape(n, n, R, W)).to(dev)
        out = rc.all_to_all_v(encode_dispatch_int8(x),
                              np.full((n, n), R, np.int32), n)
        return cudaenv.to_numpy(decode_dispatch_int8(out, W)).reshape(n, size)

    return dryrun.run_tolerance_check("alltoallv", approx, exact_fn=exact,
                                      sizes=sizes, nranks=nranks, band=band)
