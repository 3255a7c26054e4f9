"""coll/han — hierarchical two-level collectives (intra-node × inter-node).

Copy of ``ompi_tpu/mca/coll/han.py`` (after the reference's
``ompi/mca/coll/han/coll_han.h:189-215``): a communicator spanning multiple
nodes is split into a *low* sub-communicator (ranks sharing a node) and *up*
sub-communicators (one per low-rank, connecting peers across nodes), and
each collective is composed from sub-collectives on those two levels so the
slow inter-node links carry the minimum number of bytes:

    allreduce = reduce_scatter(low) → allreduce(up) → allgather(low)
                (symmetric fast path; leader reduce/bcast otherwise)
    bcast     = root→node-leader → bcast(leaders) → bcast(low)
    allgather = gather(low) → allgatherv(leaders) → bcast(low)
    barrier   = gather(low) → barrier(leaders) → bcast(low)

The sub-communicators select their own coll modules (tuned ladders), so the
composition reuses the whole algorithm menu per level.  They are built
lazily, with the multi-process ``split``, on a slot's first use, and freed
by ``comm_unquery`` (``Comm.free`` and finalize).  Unlike the reference,
a revocation of the comm revokes its sub-communicators too
(``ft_state.link_revocation``), so a member blocked in one level on a live
peer that has left the collective to recover is released, as ULFM's revoke
requires.  A tensor given to a slot is staged to the host once, at the
slot's entry, and results are numpy.

Node identity comes from the RTE modex ("node" key: ``OTPU_NODE_ID`` or the
hostname), so ``tpurun --fake-nodes K`` exercises the hierarchy on one host
the way the reference tests han with ``mpirun --oversubscribe``.

The device half, :class:`HierarchicalColl` (the reference's
``XlaHierarchicalColl``, two-level ``psum_scatter``/``psum``/``all_gather``
over a ('dcn', 'ici') mesh), composes the same schedule over the rank axis
of one world tensor with torch reductions, as coll/builtin computes
coll/xla's psum: the low level, then the up level, then the replicated or
scattered result.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.ft import state as ft_state
from ompi_tpu_torch.mca.coll.basic import BasicCollModule, coll_tag, staged


def _rev_key(comm) -> tuple:
    """A comm's revocation key (``ft_state.mark_revoked``'s)."""
    return (comm.ft_scope, comm.cid, comm.epoch)


class HanModule:
    """Per-communicator hierarchical module (lazy sub-comm construction)."""

    def __init__(self, component: "HanCollComponent", node_of: list):
        self._c = component
        self._node_of = list(node_of)      # comm rank -> node color (int)
        self._low = None                   # intra-node sub-comm
        self._up = None                    # same-low-rank-across-nodes
        self._leaders = None               # low-rank-0 ranks (None elsewhere)
        self._building = False
        self._fallback = BasicCollModule()
        # per-node bookkeeping (computable locally from node_of)
        colors = sorted(set(self._node_of))
        self._ranks_of_node = {c: [r for r, n in enumerate(self._node_of)
                                   if n == c] for c in colors}
        self._node_index = {c: i for i, c in enumerate(colors)}
        self._low_rank_of = {}
        self._leader_of_node = {}
        for c, ranks in self._ranks_of_node.items():
            self._leader_of_node[c] = ranks[0]
            for j, r in enumerate(ranks):
                self._low_rank_of[r] = j
        sizes = {len(v) for v in self._ranks_of_node.values()}
        self._symmetric = len(sizes) == 1

    # -- sub-communicator construction (collective, lazy) ----------------
    def _ready(self, comm) -> bool:
        """Build the sub-comms on first use; False while building.

        Construction itself issues collectives on the parent (split's
        allgather + CID agreement), which route back through this module —
        during that window every slot delegates to the rank-ordered basic
        fallback, identically on all members, so the recursion grounds out.
        """
        if self._building:
            # mid-construction (an earlier split already set _low but the
            # leaders comm may not exist yet): stay on the fallback
            return False
        if self._low is not None:
            return True
        self._building = True
        try:
            me = comm.rank
            my_node = self._node_of[me]
            # low: ranks of my node, ordered by parent rank
            self._low = comm.split(self._node_index[my_node], key=me)
            # up: peers holding my low-rank on every node (the inter-node plane)
            self._up = comm.split(self._low_rank_of[me], key=me)
            # leaders: one rank per node (low rank 0); None elsewhere
            self._leaders = comm.split(
                0 if self._low_rank_of[me] == 0 else -1, key=me)
            # a revocation of comm reaches the sub-comms its collectives
            # block on (ULFM): a member waiting there on a live peer that
            # has left to recover is released
            ft_state.link_revocation(
                _rev_key(comm), [_rev_key(c) for c in
                                 (self._low, self._up, self._leaders)
                                 if c is not None])
        finally:
            self._building = False
        return True

    # leaders-comm rank of a node = position among node colors in index
    # order (leaders split keyed by parent rank; node groups are disjoint
    # but their leader ranks sort by parent rank, not color index)
    def _leaders_rank_of_node(self, node_color) -> int:
        leaders = sorted(self._leader_of_node.values())
        return leaders.index(self._leader_of_node[node_color])

    # -- collectives ------------------------------------------------------
    def allreduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        sendbuf = staged(sendbuf)
        if not self._ready(comm):
            return self._fallback.allreduce(comm, sendbuf, op)
        arr = np.ascontiguousarray(sendbuf)
        low, up = self._low, self._up
        if (op.commute and self._symmetric and arr.size
                and arr.size % low.size == 0):
            # reduce_scatter(low) → allreduce(up) → allgather(low): the
            # up level carries size/low.size elements a node, not size
            flat = arr.reshape(-1)
            seg = low.reduce_scatter(flat, op=op)
            seg = np.asarray(up.allreduce(seg, op))
            full = np.asarray(low.allgather(seg))
            return full.reshape(arr.shape)
        if not op.commute:
            # node grouping reorders operands; stay rank-ordered
            return self._fallback.allreduce(comm, arr, op)
        red = low.reduce(arr, op, root=0)
        if low.rank == 0:
            red = np.ascontiguousarray(self._leaders.allreduce(red, op))
            return np.asarray(low.bcast(red, root=0)).reshape(arr.shape)
        out = low.bcast(np.empty_like(arr), root=0)
        return np.asarray(out).reshape(arr.shape)

    def bcast(self, comm, buf, root: int = 0):
        tag = coll_tag(comm)
        buf = staged(buf)
        if not self._ready(comm):
            return self._fallback.bcast(comm, buf, root)
        low = self._low
        arr = np.ascontiguousarray(buf)
        root_node = self._node_of[root]
        leader = self._leader_of_node[root_node]
        data = arr if comm.rank == root else np.empty_like(arr)
        if root != leader:          # hop 0: root → its node's leader
            if comm.rank == root:
                comm.send(arr, leader, tag)
            elif comm.rank == leader:
                comm.recv(data, root, tag)
        if low.rank == 0:           # hop 1: across nodes
            data = np.ascontiguousarray(self._leaders.bcast(
                data, root=self._leaders_rank_of_node(root_node)))
        return np.asarray(low.bcast(data, root=0)).reshape(arr.shape)

    def reduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM,
               root: int = 0):
        tag = coll_tag(comm)
        sendbuf = staged(sendbuf)
        if not self._ready(comm):
            return self._fallback.reduce(comm, sendbuf, op, root)
        if not op.commute:
            return self._fallback.reduce(comm, sendbuf, op, root)
        low = self._low
        arr = np.ascontiguousarray(sendbuf)
        root_node = self._node_of[root]
        leader = self._leader_of_node[root_node]
        red = low.reduce(arr, op, root=0)
        if low.rank == 0:
            red = self._leaders.reduce(
                np.ascontiguousarray(red), op,
                root=self._leaders_rank_of_node(root_node))
        if root == leader:
            return red if comm.rank == root else None
        # final hop: root's node leader → root
        if comm.rank == leader:
            comm.send(np.ascontiguousarray(red), root, tag)
            return None
        if comm.rank == root:
            out = np.empty_like(arr)
            comm.recv(out, leader, tag)
            return out
        return None

    def allgather(self, comm, sendbuf):
        sendbuf = staged(sendbuf)
        if not self._ready(comm):
            return self._fallback.allgather(comm, sendbuf)
        low = self._low
        arr = np.ascontiguousarray(sendbuf)
        g_low = low.gather(arr, root=0)            # (low.size, *S) at leader
        out = np.empty((comm.size, *arr.shape), arr.dtype)
        if low.rank == 0:
            parts = self._leaders.allgatherv(
                np.ascontiguousarray(g_low).reshape(-1))
            # leaders comm ranks sort by parent rank; map back to nodes
            leaders_sorted = sorted(self._leader_of_node.items(),
                                    key=lambda kv: kv[1])
            for (node_color, _), flat in zip(leaders_sorted, parts):
                ranks = self._ranks_of_node[node_color]
                stack = np.asarray(flat).reshape((len(ranks), *arr.shape))
                for j, r in enumerate(ranks):
                    out[r] = stack[j]
        return np.asarray(low.bcast(out, root=0))

    def barrier(self, comm) -> None:
        if not self._ready(comm):
            return self._fallback.barrier(comm)
        low = self._low
        token = np.zeros(1, np.uint8)
        low.gather(token, root=0)
        if low.rank == 0:
            self._leaders.barrier()
        low.bcast(token, root=0)

    def gather(self, comm, sendbuf, root: int = 0):
        tag = coll_tag(comm)
        sendbuf = staged(sendbuf)
        if not self._ready(comm):
            return self._fallback.gather(comm, sendbuf, root)
        low = self._low
        arr = np.ascontiguousarray(sendbuf)
        root_node = self._node_of[root]
        leader = self._leader_of_node[root_node]
        g_low = low.gather(arr, root=0)
        assembled = None
        if low.rank == 0:
            parts = self._leaders.gatherv(
                np.ascontiguousarray(g_low).reshape(-1),
                root=self._leaders_rank_of_node(root_node))
            if parts is not None:    # I am root's node leader
                assembled = np.empty((comm.size, *arr.shape), arr.dtype)
                leaders_sorted = sorted(self._leader_of_node.items(),
                                        key=lambda kv: kv[1])
                for (node_color, _), flat in zip(leaders_sorted, parts):
                    ranks = self._ranks_of_node[node_color]
                    stack = np.asarray(flat).reshape(
                        (len(ranks), *arr.shape))
                    for j, r in enumerate(ranks):
                        assembled[r] = stack[j]
        if root == leader:
            return assembled if comm.rank == root else None
        if comm.rank == leader:
            comm.send(assembled, root, tag)
            return None
        if comm.rank == root:
            out = np.empty((comm.size, *arr.shape), arr.dtype)
            comm.recv(out, leader, tag)
            return out
        return None

    def scatter(self, comm, sendbuf, root: int = 0):
        tag = coll_tag(comm)
        sendbuf = staged(sendbuf)
        if not self._ready(comm):
            return self._fallback.scatter(comm, sendbuf, root)
        low = self._low
        my_node = self._node_of[comm.rank]
        if comm.rank == root:
            stack = np.ascontiguousarray(sendbuf)
            if stack.shape[0] != comm.size:
                raise ValueError("scatter needs (size, ...) on root")
            block = np.ascontiguousarray(stack[root])
            sub_for_me = None
            # one message per *node* across nodes, not per rank
            for node_color, ranks in self._ranks_of_node.items():
                sub = np.ascontiguousarray(stack[ranks])
                leader = self._leader_of_node[node_color]
                if leader == root:
                    sub_for_me = sub
                else:
                    comm.send(sub, leader, tag)
        else:
            block = np.ascontiguousarray(sendbuf)  # template: my block shape
            sub_for_me = None
        if low.rank == 0 and sub_for_me is None:
            sub_for_me = np.empty((low.size, *block.shape), block.dtype)
            if self._leader_of_node[my_node] != root:
                comm.recv(sub_for_me, root, tag)
        if low.rank == 0:
            return low.scatter(sub_for_me, root=0)
        return low.scatter(block, root=0)

    # NOTE: han deliberately does NOT provide `agree` — the agreement slot
    # (coll/ftagree in the reference, coll/basic here) must not be
    # shadowed by a higher-priority non-FT composition.

    def comm_unquery(self, comm) -> None:
        if self._low is not None:
            ft_state.unlink_revocation(_rev_key(comm))
        for sub in (self._low, self._up, self._leaders):
            if sub is not None:
                sub.free()
        self._low = self._up = self._leaders = None


class HanCollComponent(Component):
    """Selects only on communicators genuinely spanning >= 2 nodes with
    >= 2 ranks somewhere (``coll_han`` disqualifies itself the same way)."""

    name = "han"
    priority = 40

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=40,
            help="Selection priority of coll/han (hierarchical collectives)")
        self._node_cache: dict[int, object] = {}

    def _node_of_world_rank(self, rte, w: int):
        # shared cached locality lookup (published before the init fence)
        return rte.node_of(w)

    def comm_query(self, comm):
        rte = comm.rte
        if rte is None or rte.is_device_world or comm.size < 2:
            return None
        if comm.is_inter:
            return None
        try:
            nodes = [self._node_of_world_rank(rte, w)
                     for w in comm.group.world_ranks]
        except Exception:
            return None
        if any(n is None for n in nodes):
            return None
        colors = sorted(set(nodes))
        if len(colors) < 2:
            return None
        by_node = {c: sum(1 for n in nodes if n == c) for c in colors}
        if max(by_node.values()) < 2:
            return None
        node_of = [colors.index(n) for n in nodes]
        return self._prio.value, HanModule(self, node_of)


class HierarchicalColl:
    """Device-side two-level composition over the rank axis of one world
    tensor (the reference's ``XlaHierarchicalColl``).

    ``n_up * n_low`` ranks: rank ``u * n_low + l`` is low rank ``l`` of up
    group ``u``, and a world tensor carries a leading rank axis of that
    size.  ``allreduce`` sums over the low level, then over the up level.
    The reference splits rows whose first axis ``n_low`` divides into
    blocks (``psum_scatter``, ``psum``, ``all_gather``) because each mesh
    device holds its own block; on one tensor on one device that block
    path is the same sum element for element, so every shape takes the
    whole-row form.  The world's device is the card unless the caller
    names another (``device="cpu"``).
    """

    def __init__(self, n_up: int, n_low: int, device=None) -> None:
        self.n_up, self.n_low = int(n_up), int(n_low)
        self.device = cudaenv.resolve_device(device)

    @property
    def size(self) -> int:
        return self.n_up * self.n_low

    def make_world_array(self, host_stack) -> torch.Tensor:
        arr = np.asarray(host_stack)
        if arr.shape[0] != self.size:
            raise ValueError(f"world array needs leading axis {self.size}")
        return cudaenv.make_world_array(arr, self.device)

    def _world(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            return self.make_world_array(x)
        if x.ndim == 0 or x.shape[0] != self.size:
            raise ValueError(f"world array needs leading axis {self.size}")
        return x

    def _levels(self, x: torch.Tensor) -> torch.Tensor:
        """(n_up, n_low, *S) view of the world rows, summed over the low
        level (the node's reduction)."""
        v = x.reshape(self.n_up, self.n_low, *x.shape[1:])
        return torch.sum(v, 1, dtype=x.dtype)

    def allreduce(self, x) -> torch.Tensor:
        """Hierarchical sum of the world rows of ``x``: the ``x.shape[1:]``
        result every rank holds (replicated)."""
        x = self._world(x)
        return torch.sum(self._levels(x), 0, dtype=x.dtype)

    def reduce_scatter(self, x) -> torch.Tensor:
        """World ``(n, n, *S)`` → ``(n, *S)``: row i is rank i's reduced
        block, the sum over every rank's row i (low level, then up)."""
        x = self._world(x)
        if x.ndim < 2 or x.shape[1] != self.size:
            raise ValueError(
                f"reduce_scatter needs a ({self.size}, {self.size}, ...) "
                f"world array, got {tuple(x.shape)}")
        return torch.sum(self._levels(x), 0, dtype=x.dtype)


COMPONENT = HanCollComponent()
