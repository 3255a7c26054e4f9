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

- **The host trainer** (:class:`MoeTrainer`, ``moe.py:257-443``) subclasses
  ``parallel/elastic.ElasticTrainer``: token payloads move with
  ``comm.alltoallv`` and refreshed expert slabs with ``comm.allgatherv``
  (ranks owning no experts contribute zero-length buffers), inside the
  ``moe_dispatch`` and ``moe_combine`` spans.  Expert ownership is
  ``partition(rank, size, n_experts)`` of the CURRENT comm every step, so a
  chaos kill and shrink re-shards the experts over the survivors
  (``respawn=False``); the integer gradients and dyadic gates keep the run
  bit-identical to :func:`reference_moe_run`.  The parameter table is the
  trainer's float64 tensor on the rank's device; the plan and the rows are
  numpy, each owner's update goes to the device once a step.  It feeds the
  ``moe`` telemetry source and the ``moe_*`` SPC counters, and reads the
  six ``otpu_moe_*`` vars only it uses (``n_experts``, ``top_k``,
  ``drop_policy``, ``hot_expert``, ``hot_boost``,
  ``compute_us_per_token``); the device tier reads ``capacity_factor``.
  :func:`main` runs one rank: ``python -m ompi_tpu_torch.parallel.moe
  '<json>'`` under the port's ``tpurun``.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.parallel import axes as axes_mod
from ompi_tpu_torch.parallel.elastic import (DEFAULT_LR, ElasticTrainer, _P1,
                                             _P2, _P3, grad_field, partition)
from ompi_tpu_torch.parallel.mesh import EXPERT_AXIS, MeshSpec, make_mesh
from ompi_tpu_torch.parallel.model import gelu
from ompi_tpu_torch.runtime import spc, telemetry, trace

_n_experts_var = registry.register(
    "moe", None, "n_experts", vtype=VarType.INT, default=8,
    help="Number of experts in the MoE layer (host trainer default; "
         "the device tier derives it from the mesh spec)")

_top_k_var = registry.register(
    "moe", None, "top_k", vtype=VarType.INT, default=2,
    help="Experts each token routes to; gate weights are the dyadic "
         "ladder 1/2, 1/4, ... with the tail 2^-k folded into the top "
         "expert so they sum to exactly 1 (combines stay bit-exact)")

_capacity_factor_var = registry.register(
    "moe", None, "capacity_factor", vtype=VarType.FLOAT, default=1.25,
    help="Per-expert capacity = ceil(factor * tokens * top_k / "
         "n_experts); tokens routed past a full expert follow "
         "otpu_moe_drop_policy")

_drop_policy_var = registry.register(
    "moe", None, "drop_policy", vtype=VarType.STRING, default="drop",
    enum_values={"drop": 0, "error": 1},
    help="Over-capacity token policy: 'drop' (counted in "
         "moe_dropped_tokens, token keeps its residual path) or "
         "'error' (raise ERR_TRUNCATE — for runs where any drop is a "
         "configuration bug)")

_hot_expert_var = registry.register(
    "moe", None, "hot_expert", vtype=VarType.INT, default=-1,
    help="Designated hot expert for designed-imbalance runs (-1 = "
         "none): tokens selected by otpu_moe_hot_boost route their "
         "top-1 here, skewing load for critical-path/imbalance tests")

_hot_boost_var = registry.register(
    "moe", None, "hot_boost", vtype=VarType.FLOAT, default=0.0,
    help="Fraction (0..1) of tokens deterministically biased toward "
         "otpu_moe_hot_expert")

_pace_var = registry.register(
    "moe", None, "compute_us_per_token", vtype=VarType.INT, default=0,
    help="Host-trainer pacing: microseconds of simulated expert "
         "compute per RECEIVED token, so the hot expert's home rank "
         "is measurably the straggler (otpu_analyze --critical-path "
         "acceptance); 0 disables")


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


# -- telemetry: the "moe" live source ------------------------------------

_TELEM = {"steps": 0, "dispatch_tokens": 0, "dropped_tokens": 0,
          "n_experts": 0, "capacity": 0, "imbalance": 0.0,
          "world_size": 0}


def _telem_snapshot() -> dict:
    return dict(_TELEM)


def _imbalance_high_water(imb: float) -> None:
    """Publish the load-imbalance factor as a monotonic high-water in
    milli-units — the SPC plane is append-only counters, so a gauge is
    expressed as read + delta-record."""
    milli = int(round(float(imb) * 1000))
    cur = spc.read("moe_imbalance_max")
    if milli > cur:
        spc.record("moe_imbalance_max", milli - cur)


# -- the host trainer: expert-sharded, elastic, bit-exact ----------------

class MoeTrainer(ElasticTrainer):
    """Expert-parallel trainer that trains through failure.

    The model is ``(n_experts, expert_dim)`` expert weights (the trainer's
    float64 tensor on the rank's device); every rank holds the full (small)
    table but OWNS the contiguous expert range ``partition(rank, size,
    n_experts)`` — owners apply updates, everyone else receives the
    refreshed slabs through the ragged ``allgatherv`` combine.  Ownership
    is recomputed from the live comm each step, so recovery's shrink
    re-shards the experts over the survivors with no extra code path."""

    def __init__(self, comm, ckpt_dir: str, n_experts: int = None,
                 expert_dim: int = 8, tokens_per_step: int = 64,
                 top_k: int = None, capacity_factor: float = None,
                 drop_policy: str = None, lr: float = DEFAULT_LR,
                 ckpt_every: int = 5, seed: int = 0,
                 hot_expert: int = None, hot_boost: float = None,
                 compute_us_per_token: int = None, device=None):
        self.n_experts = int(n_experts if n_experts is not None
                             else _n_experts_var.value)
        self.expert_dim = int(expert_dim)
        self.top_k = int(top_k if top_k is not None
                         else _top_k_var.value)
        self.capacity_factor = float(
            capacity_factor if capacity_factor is not None
            else _capacity_factor_var.value)
        self.drop_policy = str(drop_policy if drop_policy is not None
                               else _drop_policy_var.value)
        if self.drop_policy not in ("drop", "error"):
            raise MpiError(ErrorClass.ERR_ARG,
                           f"otpu_moe_drop_policy={self.drop_policy!r} "
                           "(want 'drop' or 'error')")
        self.hot_expert = int(hot_expert if hot_expert is not None
                              else _hot_expert_var.value)
        self.hot_boost = float(hot_boost if hot_boost is not None
                               else _hot_boost_var.value)
        self.compute_us_per_token = int(
            compute_us_per_token if compute_us_per_token is not None
            else _pace_var.value)
        super().__init__(comm, ckpt_dir,
                         model_size=self.n_experts * self.expert_dim,
                         global_batch=int(tokens_per_step), lr=lr,
                         ckpt_every=ckpt_every, respawn=False,
                         seed=seed, device=device)
        self.capacity = capacity_for(self.global_batch, self.n_experts,
                                     self.top_k, self.capacity_factor)
        self._dispatched = 0
        self._dropped = 0
        self._imb_max = 0.0
        _TELEM.update(n_experts=self.n_experts, capacity=self.capacity)
        telemetry.register_source("moe", _telem_snapshot)

    # -- expert ownership ------------------------------------------------
    def my_experts(self) -> tuple:
        """[lo, hi) expert range this rank owns under the CURRENT comm
        — the single source of re-shard truth after a shrink."""
        return partition(self.comm.rank, self.comm.size, self.n_experts)

    # -- checkpoint at expert boundaries ---------------------------------
    def _checkpoint(self) -> None:
        from ompi_tpu_torch.parallel import checkpoint

        t0 = time.perf_counter_ns()
        path = self._ckpt_path(self.step)
        elo, ehi = self.my_experts()
        d = self.expert_dim
        tree = {
            "w": checkpoint.Shard(self.w[elo * d:ehi * d], [elo * d],
                                  [self.model_size]),
            "step": np.array([self.step], np.int64),
        }
        checkpoint.save(path, tree, comm=self.comm)
        self.comm.barrier()
        if self.comm.rank == 0:
            with open(os.path.join(path, "COMPLETE"), "w") as f:
                f.write(str(self.step))
        if trace.enabled:
            trace.span("elastic_checkpoint", "ft", t0,
                       args={"step": self.step,
                             "experts": [elo, ehi]})

    # -- one expert-parallel step ----------------------------------------
    def _train_step(self) -> None:
        E, d, k = self.n_experts, self.expert_dim, self.top_k
        T = self.global_batch
        me, size = self.comm.rank, self.comm.size
        plan = plan_step(self.step, T, E, k, self.capacity_factor,
                         self.seed, self.hot_expert, self.hot_boost)
        if plan.dropped and self.drop_policy == "error":
            raise MpiError(
                ErrorClass.ERR_TRUNCATE,
                f"step {self.step}: {len(plan.dropped)} tokens over "
                f"capacity {plan.capacity} with "
                "otpu_moe_drop_policy=error")
        tlo, thi = partition(me, size, T)
        mine = [a for a in plan.kept if tlo <= a.token < thi]
        my_dropped = sum(1 for t, _ in plan.dropped if tlo <= t < thi)
        imb = plan.imbalance()
        spc.record("moe_dispatch_tokens", len(mine))
        if my_dropped:
            spc.record("moe_dropped_tokens", my_dropped)
        _imbalance_high_water(imb)
        self._dispatched += len(mine)
        self._dropped += my_dropped
        self._imb_max = max(self._imb_max, imb)
        _TELEM.update(steps=_TELEM["steps"] + 1,
                      dispatch_tokens=_TELEM["dispatch_tokens"]
                      + len(mine),
                      dropped_tokens=_TELEM["dropped_tokens"]
                      + my_dropped,
                      imbalance=imb, world_size=size)

        # dispatch: weighted token-gradient rows to each expert's home
        # rank, in plan order — NO metadata rides the wire, the receiver
        # recomputes the plan and knows every row's expert
        send = []
        for dest in range(size):
            delo, dehi = partition(dest, size, E)
            rows = [token_grad(self.step, a.token, d, self.seed)
                    * a.weight
                    for a in mine if delo <= a.expert < dehi]
            send.append(np.concatenate(rows) if rows
                        else np.zeros(0, np.float64))
        t0 = trace.now() if trace.enabled else 0
        recv = self.comm.alltoallv(send)
        if trace.enabled:
            trace.span("moe_dispatch", "coll", t0,
                       args={"step": self.step, "rows": len(mine)})

        # owner side: fold received rows into my expert slice, exactly
        elo, ehi = self.my_experts()
        upd = np.zeros((max(0, ehi - elo), d), np.float64)
        n_recv = 0
        for src in range(size):
            slo, shi = partition(src, size, T)
            expected = [a for a in plan.kept
                        if slo <= a.token < shi and elo <= a.expert < ehi]
            blk = np.asarray(recv[src])
            rows = (blk if blk.dtype == np.float64
                    else blk.view(np.float64)).reshape(-1, d)
            if rows.shape[0] != len(expected):
                raise MpiError(
                    ErrorClass.ERR_TRUNCATE,
                    f"step {self.step}: rank {src} sent "
                    f"{rows.shape[0]} rows, plan says {len(expected)} "
                    "— gating diverged across processes")
            for a, row in zip(expected, rows):
                upd[a.expert - elo] += row
            n_recv += len(expected)
        if self.compute_us_per_token and n_recv:
            # simulated expert compute ∝ received load: the hot expert's
            # home rank becomes the designed straggler
            time.sleep(self.compute_us_per_token * n_recv / 1e6)
        we = self.w.view(E, d)
        if ehi > elo:
            # lr is a power of two: lr * upd is exact on the host, and the
            # device applies one IEEE subtraction an element, as numpy does
            we[elo:ehi] -= torch.from_numpy(self.lr * upd).to(self.device)

        # combine: owners publish refreshed expert slabs; expert-less
        # ranks contribute zero-length buffers (the ragged edge case)
        t0 = trace.now() if trace.enabled else 0
        blocks = self.comm.allgatherv(cudaenv.to_numpy(we[elo:ehi]).ravel())
        if trace.enabled:
            trace.span("moe_combine", "coll", t0,
                       args={"step": self.step,
                             "experts": [elo, ehi]})
        for r in range(size):
            rlo, rhi = partition(r, size, E)
            if rhi <= rlo or r == me:
                continue
            blk = np.asarray(blocks[r])
            blk = (blk if blk.dtype == np.float64
                   else blk.view(np.float64)).reshape(rhi - rlo, d)
            we[rlo:rhi] = torch.from_numpy(blk).to(self.device)
        self.step += 1

    def report(self) -> dict:
        rep = super().report()
        elo, ehi = self.my_experts()
        rep.update({"n_experts": self.n_experts, "top_k": self.top_k,
                    "capacity": self.capacity, "experts": [elo, ehi],
                    "dispatched": self._dispatched,
                    "dropped": self._dropped,
                    "imbalance_max": round(self._imb_max, 6)})
        return rep


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
    return {k: gather(v, pspecs[k], mesh) for k, v in params.items()}


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


# -- worker entry --------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    """``python -m ompi_tpu_torch.parallel.moe '<json-conf>'`` — one
    self-contained expert-parallel training rank (``tpurun`` jobs launch
    these).  The conf holds ``steps``, ``ckpt_dir`` and the trainer's
    keywords (``"device": "cpu"`` for a rank without a card).  Rank 0
    prints ``MOE <report-json>``."""
    import sys

    import ompi_tpu_torch

    args = sys.argv[1:] if argv is None else list(argv)
    conf = json.loads(args[0]) if args else {}
    steps = int(conf.pop("steps", 8))
    ckpt_dir = conf.pop("ckpt_dir")
    ompi_tpu_torch.init(device=conf.get("device"))
    w = ompi_tpu_torch.COMM_WORLD
    trainer = MoeTrainer(w, ckpt_dir, **conf)
    trainer.train(steps)
    if trainer.comm.rank == 0:
        print("MOE " + json.dumps(trainer.report()))
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
