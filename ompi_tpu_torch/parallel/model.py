"""Per-rank transformer block bodies with explicit mesh collectives.

Port of ``ompi_tpu/parallel/model.py``.  The reference's functions run
inside ``shard_map`` on one device's slice; here every tensor is a
per-rank tensor ``(dp, pp, sp, tp, *local)`` holding all ranks' slices
(``parallel/mesh.py``), and each ``jax.lax`` collective is its tensor op
in ``parallel/axes.py``, taken from the axis set ``ax`` the step passes
(the dense ``axes.DENSE`` by default; the multi-process step's
``ProcessAxes``).  Parameters are dicts of per-rank tensors, as the
reference's are dicts of arrays; ``p[name]`` of one block is ``(dp, pp,
sp, tp, *leaf_local)``.

Where the port differs on purpose (ROADMAP C): GELU is the tanh form,
``jax.nn.gelu``'s default; the causal bias of ring attention is one block
per rank, so one K21 launch serves every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import flash_attention as fa
from ompi_tpu_torch.parallel import axes


def rmsnorm(x, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def gelu(x):
    """``jax.nn.gelu`` (its default, ``approximate=True``): the tanh form."""
    return F.gelu(x, approximate="tanh")


def ring_attention(q, k, v, axis: str, n_shards: int, use_flash=None,
                   causal: bool = False, ax=axes.DENSE):
    """Flash-style ring attention over the sequence-parallel axis.

    q/k/v ``(*mesh, b, h_local, s_local, hd)``.  K/V blocks rotate one rank
    along ``axis`` per step (``ppermute``) while ``(m, num, den)`` fold
    each block in with the running-max rescaling.  ``use_flash`` (None: on
    the card) takes each step's block update through K21
    (``ops/flash_attention.py``), one launch for all ranks; False takes the
    same math in plain torch (``update_twin``, differentiated by autograd),
    the reference's own switch.

    ``causal=True`` masks at GLOBAL positions: rank i's queries own rows
    ``[i·s_local, (i+1)·s_local)``, the block visiting at step t came from
    rank ``(i − t) mod n``, and the 0/−inf bias built from the two offsets
    is one ``(s_local, s_local)`` block per rank.  Step 0 is the diagonal
    block, so the running max is finite before a fully masked block comes.
    """
    s_local = q.shape[-2]
    if use_flash is None:
        use_flash = cudaenv.on_card(q)
    if use_flash:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # accumulator inits derived from q (0*q + const), as the reference's
    m = q[..., 0] * 0 - math.inf
    num = q * 0
    den = q[..., 0] * 0
    my = ax.axis_index(q, axis) if n_shards > 1 else torch.zeros(
        [1] * ax.ndim, dtype=torch.long, device=q.device)
    rows = torch.arange(s_local, device=q.device)

    def step_bias(t):
        # the K/V block at step t came from rank (my - t) mod n; one
        # (s_local, s_local) block per rank, in q.dtype as the reference's
        src = torch.remainder(my - t + n_shards, n_shards)[..., None, None]
        qpos = my[..., None, None] * s_local + rows[:, None]
        kpos = src * s_local + rows[None, :]
        return torch.where(qpos >= kpos, 0.0, -math.inf).to(q.dtype)

    for t in range(n_shards):
        bias = step_bias(t) if causal else None
        if use_flash:
            if causal:
                m, num, den = fa.flash_block_update_biased(q, k, v, m, num,
                                                           den, bias)
            else:
                m, num, den = fa.flash_block_update(q, k, v, m, num, den)
        else:
            m, num, den = fa.update_twin(q, k, v, m, num, den, bias)
        if n_shards > 1 and t < n_shards - 1:
            k, v = ax.ppermute_next(k, axis), ax.ppermute_next(v, axis)
    return num / den[..., None]


def ulysses_attention(q, k, v, axis: str, n_shards: int,
                      causal: bool = False, ax=axes.DENSE):
    """DeepSpeed-Ulysses sequence parallelism: an all-to-all head↔sequence
    reshard instead of the ring's K/V rotation (h_local % n_shards == 0).
    After the reshard each rank holds h_local/n heads over the FULL
    sequence, attends locally, and the inverse all-to-all restores the
    sequence sharding."""
    if n_shards == 1:
        return _full_attention(q, k, v, causal)

    def scatter_heads(t):   # (b, h_l, s_l, hd) -> (b, h_l/n, s, hd)
        return ax.all_to_all(t, axis, split_axis=1, concat_axis=2)

    o = _full_attention(scatter_heads(q), scatter_heads(k), scatter_heads(v),
                        causal)
    return ax.all_to_all(o, axis, split_axis=2, concat_axis=1)


def _full_attention(q, k, v, causal: bool = False):
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(skv, device=s.device)[None, :])
        s = torch.where(mask, s, -math.inf)
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w, v)


def _cols(h, w):
    """``h @ w`` per rank: h ``(*mesh, b, s, k)``, w ``(*mesh, k, n)``."""
    return torch.matmul(h, w.unsqueeze(-3))


def attention_block(p, x, *, sp: int, tp: int, n_heads_local: int,
                    sp_impl: str = "ring", causal: bool = False,
                    use_flash=None, ax=axes.DENSE):
    """Sequence-parallel attention with tp-sharded heads; psum output proj.

    x ``(*mesh, b, s_local, d)``, replicated over tp.  The head projections
    are column-sharded over tp, the output projection row-sharded, so its
    partial products combine with a psum over tp.
    """
    b, s_l, _ = x.shape[-3:]
    h = rmsnorm(x)

    def heads(w):   # (*mesh, b, h_local, s_l, hd)
        y = _cols(h, w)
        return y.reshape(*y.shape[:-1], n_heads_local, -1).transpose(-3, -2)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    if sp_impl == "ulysses" and sp > 1:
        if n_heads_local % sp:
            raise ValueError(
                f"ulysses needs local heads divisible by sp "
                f"({n_heads_local} % {sp}); use sp_impl='ring'")
        o = ulysses_attention(q, k, v, "sp", sp, causal=causal, ax=ax)
    else:
        o = ring_attention(q, k, v, "sp", sp, use_flash=use_flash,
                           causal=causal, ax=ax)
    o = _cols(o.transpose(-3, -2).flatten(-2), p["wo"])
    if tp > 1:
        o = ax.psum(o, "tp")
    return x + o


def mlp_block(p, x, *, tp: int, ax=axes.DENSE):
    """Megatron-style tp MLP: column-shard w1, row-shard w2, psum combine."""
    y = _cols(gelu(_cols(rmsnorm(x), p["w1"])), p["w2"])
    if tp > 1:
        y = ax.psum(y, "tp")
    return x + y


def moe_block(p, x, *, tp: int, n_experts: int, capacity: int,
              ax=axes.DENSE):
    """Top-1 MoE with experts sharded over tp via all-to-all.

    Each tp rank routes its chunk of the local tokens, dispatches to the
    expert-home ranks (all-to-all), runs its local experts, returns the
    results (inverse all-to-all), and the chunks are re-replicated with an
    all-gather.  Static capacity per (expert, source rank); overflow
    tokens fall through on the residual path.  Ties of the router's argmax
    go to the first expert, as ``jnp.argmax``'s do.
    """
    b, s_l, d = x.shape[-3:]
    mesh = x.shape[:-3]
    xf = rmsnorm(x).reshape(*mesh, b * s_l, d)
    e_l = n_experts // tp
    chunk = ax.take_own(xf, "tp", 0) if tp > 1 else xf     # (*mesh, tc, d)

    logits = torch.matmul(chunk, p["wr"])                     # (*mesh, tc, E)
    probs = torch.softmax(logits, dim=-1)
    eid = torch.argmax(probs, dim=-1)
    # routing bookkeeping in float32 always (a bf16 cumsum cannot count
    # past 256 exactly)
    oh = F.one_hot(eid, n_experts).to(torch.float32)
    pos = (torch.cumsum(oh, dim=-2) - 1.0) * oh
    keep = oh * (pos < capacity)
    pos_oh = F.one_hot(torch.clamp(pos.to(torch.int64), 0, capacity - 1),
                       capacity).to(xf.dtype)                 # (.., tc, E, cap)
    disp = (keep[..., None] * pos_oh).to(xf.dtype)

    ex_in = torch.einsum("...tec,...td->...ecd", disp, chunk)  # (.., E, cap, d)
    ex_in = ex_in.reshape(*mesh, tp, e_l, capacity, d)
    if tp > 1:
        ex_in = ax.all_to_all_untiled(ex_in, "tp", 0)
    # (tp, e_l, cap, d): the leading local dim is now the source rank
    ex_in = ex_in.transpose(-4, -3).reshape(*mesh, e_l, tp * capacity, d)
    hid = gelu(torch.einsum("...etd,...edf->...etf", ex_in, p["we1"]))
    ex_out = torch.einsum("...etf,...efd->...etd", hid, p["we2"])
    ex_out = ex_out.reshape(*mesh, e_l, tp, capacity, d).transpose(-4, -3)
    if tp > 1:
        ex_out = ax.all_to_all_untiled(ex_out, "tp", 0)
    ex_out = ex_out.reshape(*mesh, n_experts, capacity, d)

    gate = torch.einsum("...tec,...te->...t", disp, probs)
    out = torch.einsum("...tec,...ecd->...td", disp, ex_out) * gate[..., None]
    if tp > 1:
        out = ax.all_gather(out, "tp", 0)                   # (*mesh, t, d)
    return x + out.reshape(*mesh, b, s_l, d)


def transformer_block(p, x, *, sp, tp, n_heads_local, n_experts, capacity,
                      sp_impl: str = "ring", causal: bool = False,
                      use_flash=None, ax=axes.DENSE):
    x = attention_block(p, x, sp=sp, tp=tp, n_heads_local=n_heads_local,
                        sp_impl=sp_impl, causal=causal, use_flash=use_flash,
                        ax=ax)
    x = mlp_block(p, x, tp=tp, ax=ax)
    x = moe_block(p, x, tp=tp, n_experts=n_experts, capacity=capacity,
                  ax=ax)
    return x
