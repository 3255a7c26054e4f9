"""The collective algorithm library — the menu coll/tuned picks from.

Copy of ``ompi_tpu/mca/coll/algorithms.py`` (after the reference's
``ompi/mca/coll/base/coll_base_*.c``): the same algorithm *menus*
(allreduce×6 ``coll_base_allreduce.c:53-1245``, bcast
binomial/chain/scatter-allgather ``coll_base_bcast.c``, allgather
bruck/recursive-doubling/ring/neighbor ``coll_base_allgather.c``, alltoall
bruck/pairwise ``coll_base_alltoall.c``, barrier rd/bruck/tree
``coll_base_barrier.c``, reduce binomial/pipeline ``coll_base_reduce.c``,
reduce_scatter recursive-halving/ring ``coll_base_reduce_scatter.c``,
binomial gather/scatter ``coll_base_gather.c``/``coll_base_scatter.c``)
implemented SPMD over the framework's pml p2p — the host path of the
multi-process world.  The entries take host buffers (numpy): the module
slots that call them (coll/tuned, coll/quant's blockq) stage a tensor once,
at their entry, through ``torch_acc.to_host``.

Every function takes the communicator first and uses one internal collective
tag per call (``ompi_tpu_torch.mca.coll.basic.coll_tag``), so concurrent
collectives on one comm stay ordered, like the reference's collective
context ids.  Reduction argument order follows the MPI convention
``inout = in (op) inout``; algorithms that cannot preserve rank order
(ring, recursive-halving, Rabenseifner, binomial reduce) are only selected
for commutative ops, mirroring ``coll_tuned_decision_fixed.c:77-80``.  The
folds are numpy ufuncs in a fixed order, so each entry is bit-identical to
the reference's on the same data.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.request import waitall
from ompi_tpu_torch.mca.coll.basic import BasicCollModule, coll_tag
from ompi_tpu_torch.runtime import spc

_basic = BasicCollModule()


def _sched_cache(fn):
    """``lru_cache`` plus SPC accounting: each lookup records
    ``fastpath_sched_hits`` / ``fastpath_sched_misses``, making the
    schedule reuse of a repeated-collective loop observable (and
    pinnable by the perf guard) without a tracing run."""
    cached = lru_cache(maxsize=1024)(fn)

    def wrapper(*args):
        hits0 = cached.cache_info().hits
        out = cached(*args)
        spc.record("fastpath_sched_hits"
                   if cached.cache_info().hits > hits0
                   else "fastpath_sched_misses")
        return out

    wrapper.cache_info = cached.cache_info
    wrapper.cache_clear = cached.cache_clear
    return wrapper


# ---------------------------------------------------------------------------
# helpers
#
# fastpath: the peer/segment schedules below depend only on small
# integer tuples (comm size, rank, payload length) — a training loop
# replays the SAME collective shape every step, so they are memoized on
# the module (lru_cache) instead of being rebuilt per call.  This is the
# Python analog of the reference caching its binomial/topo trees on the
# communicator (``coll_base_topo.c`` ompi_coll_base_topo_build_*).


def _pof2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


@_sched_cache
def _blocks(total: int, nblocks: int) -> tuple[tuple[int, int], ...]:
    """(offset, count) decomposition of ``total`` items into nblocks pieces,
    earlier blocks one larger when it doesn't divide (MPI block convention)."""
    base, rem = divmod(total, nblocks)
    out = []
    off = 0
    for i in range(nblocks):
        cnt = base + (1 if i < rem else 0)
        out.append((off, cnt))
        off += cnt
    return tuple(out)


@_sched_cache
def _ring_schedule(size: int, rank: int, total: int) -> tuple:
    """The ring allreduce's full per-step slice schedule for this rank:
    ``(max_block, reduce_steps, gather_steps)`` where each step is
    (send_off, send_cnt, recv_off, recv_cnt)."""
    blocks = _blocks(total, size)
    red = []
    for k in range(size - 1):
        soff, scnt = blocks[(rank - k) % size]
        roff, rcnt = blocks[(rank - k - 1) % size]
        red.append((soff, scnt, roff, rcnt))
    gat = []
    for k in range(size - 1):
        soff, scnt = blocks[(rank + 1 - k) % size]
        roff, rcnt = blocks[(rank - k) % size]
        gat.append((soff, scnt, roff, rcnt))
    return (max(c for _, c in blocks), tuple(red), tuple(gat))


@_sched_cache
def _rd_peers(size: int, newrank: int) -> tuple[int, ...]:
    """Recursive-doubling peer sequence for pof2-participant ``newrank``
    (already folded): one real-rank peer per mask round."""
    pof2 = _pof2_floor(size)
    rem = size - pof2
    peers = []
    mask = 1
    while mask < pof2:
        peers.append(_pof2_real_rank(newrank ^ mask, rem))
        mask <<= 1
    return tuple(peers)


def _pof2_real_rank(newrank: int, rem: int) -> int:
    """Real rank behind pof2-participant virtual rank ``newrank`` after the
    fold phase (odd ranks < 2*rem become newrank rank//2; the rest shift
    down by rem) — the MPICH/reference non-power-of-2 mapping."""
    return newrank * 2 + 1 if newrank < rem else newrank + rem


def _fold_to_pof2(comm, acc: np.ndarray, op, tag: int, rem: int) -> int:
    """Pre-phase of the pof2 algorithms: even ranks < 2*rem send their data
    to the odd neighbor (which folds it, keeping rank order) and sit out.
    Returns this rank's virtual rank, or -1 if it sits out."""
    rank = comm.rank
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.send(acc, dest=rank + 1, tag=tag)
            return -1
        other = np.empty_like(acc)
        comm.recv(other, source=rank - 1, tag=tag)
        op(other, acc)   # acc = lower-rank (op) acc: rank order kept
        return rank // 2
    return rank - rem


def _unfold_from_pof2(comm, acc: np.ndarray, tag: int, rem: int) -> None:
    """Post-phase: odd ranks < 2*rem return the result to the even
    neighbor that sat out."""
    rank = comm.rank
    if rank < 2 * rem:
        if rank % 2 != 0:
            comm.send(acc, dest=rank - 1, tag=tag)
        else:
            comm.recv(acc, source=rank + 1, tag=tag)


@_sched_cache
def _binomial_tree(rank: int, size: int, root: int):
    """(parent, children) of ``rank`` in the binomial tree rooted at root.

    Virtual rank v = (rank - root) mod size; v's parent clears its lowest
    set bit, its children are v + 2^k for 2^k below that bit (all of them
    for v = 0) — the tree shape of the reference's ``coll_base_topo.c``
    binomial builders.
    """
    vrank = (rank - root) % size
    if vrank == 0:
        parent = None
        limit = size
    else:
        lowbit = vrank & -vrank
        parent = ((vrank - lowbit) + root) % size
        limit = lowbit
    children = []
    mask = 1
    while mask < limit and vrank + mask < size:
        children.append((vrank + mask + root) % size)
        mask <<= 1
    return parent, tuple(children)


# ---------------------------------------------------------------------------
# allreduce menu (coll_base_allreduce.c)


def allreduce_nonoverlapping(comm, sendbuf, op=op_mod.SUM):
    """reduce-to-0 + bcast (``coll_base_allreduce.c:53``).  Order-safe."""
    r = _basic.reduce(comm, sendbuf, op, 0)
    arr = np.ascontiguousarray(sendbuf)
    if comm.rank == 0:
        return _basic.bcast(comm, r, 0)
    return _basic.bcast(comm, np.empty_like(arr), 0)


def allreduce_recursive_doubling(comm, sendbuf, op=op_mod.SUM):
    """Recursive doubling (``coll_base_allreduce.c:130``): lg(p) exchange
    rounds; non-power-of-2 handled by folding the first 2*rem ranks.
    Keeps operands in rank order (contiguous-range invariant), so safe for
    non-commutative ops."""
    size, rank = comm.size, comm.rank
    tag = coll_tag(comm)
    acc = np.array(np.ascontiguousarray(sendbuf), copy=True)
    if size == 1:
        return acc
    pof2 = _pof2_floor(size)
    rem = size - pof2
    newrank = _fold_to_pof2(comm, acc, op, tag, rem)

    if newrank >= 0:
        for peer in _rd_peers(size, newrank):   # cached peer schedule
            other = np.empty_like(acc)
            comm.sendrecv(acc, dest=peer, recvbuf=other, source=peer,
                          sendtag=tag, recvtag=tag)
            if peer < rank:
                op(other, acc)              # acc = theirs (op) mine
            else:
                op(acc, other)              # other = mine (op) theirs
                acc = other

    _unfold_from_pof2(comm, acc, tag, rem)
    return acc


def allreduce_ring(comm, sendbuf, op=op_mod.SUM):
    """Ring allreduce (``coll_base_allreduce.c:341``): p-1 reduce-scatter
    steps + p-1 allgather steps around the ring.  Commutative only —
    bandwidth-optimal, the DP-gradient-sync classic."""
    size, rank = comm.size, comm.rank
    flat = np.ascontiguousarray(sendbuf).reshape(-1)
    if size == 1:
        return np.array(flat, copy=True).reshape(np.asarray(sendbuf).shape)
    if flat.size < size:  # degenerate blocks -> latency algorithm instead
        return allreduce_recursive_doubling(comm, sendbuf, op)
    tag = coll_tag(comm)
    acc = np.array(flat, copy=True)
    right = (rank + 1) % size
    left = (rank - 1) % size
    # cached per-(size, rank, length) slice schedule: a gradient-sync
    # loop replays the same shape every step and pays the block math once
    max_block, red_steps, gat_steps = _ring_schedule(size, rank, acc.size)

    # ONE pooled staging buffer serves every step (grdma-style reuse:
    # repeated 4MB allreduces re-fault fresh np.empty pages per call
    # otherwise); block sizes differ by <=1 element, so slice to fit
    from ompi_tpu_torch.mca.accelerator import torch_acc

    tmp = torch_acc.staging_acquire(max_block, acc.dtype)
    try:
        # reduce-scatter phase: step k sends block (rank-k), recvs (rank-k-1)
        for soff, scnt, roff, rcnt in red_steps:
            inbuf = tmp[:rcnt]
            comm.sendrecv(acc[soff:soff + scnt], dest=right, recvbuf=inbuf,
                          source=left, sendtag=tag, recvtag=tag)
            op(inbuf, acc[roff:roff + rcnt])

        # allgather phase: circulate the completed blocks
        for soff, scnt, roff, rcnt in gat_steps:
            inbuf = tmp[:rcnt]
            comm.sendrecv(acc[soff:soff + scnt], dest=right, recvbuf=inbuf,
                          source=left, sendtag=tag, recvtag=tag)
            acc[roff:roff + rcnt] = inbuf
    finally:
        torch_acc.staging_release(tmp)
    return acc.reshape(np.asarray(sendbuf).shape)


def allreduce_ring_segmented(comm, sendbuf, op=op_mod.SUM,
                             segsize: int = 1 << 20):
    """Segmented ring (``coll_base_allreduce.c:618``): the ring run chunk by
    chunk so pipeline depth is bounded by ``segsize``.  Commutative only."""
    arr = np.ascontiguousarray(sendbuf)
    seg_elems = max(1, segsize // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunk_elems = seg_elems * comm.size
    if comm.size == 1 or flat.size <= chunk_elems:
        return allreduce_ring(comm, sendbuf, op)
    out = np.empty_like(flat)
    for off in range(0, flat.size, chunk_elems):
        chunk = flat[off:off + chunk_elems]
        out[off:off + chunk.size] = allreduce_ring(comm, chunk, op)
    return out.reshape(arr.shape)


def allreduce_redscat_allgather(comm, sendbuf, op=op_mod.SUM):
    """Rabenseifner (``coll_base_allreduce.c:970``): recursive-halving
    reduce-scatter + recursive-doubling allgather.  Commutative only;
    bandwidth-optimal with lg(p) latency for large payloads."""
    size, rank = comm.size, comm.rank
    flat = np.ascontiguousarray(sendbuf).reshape(-1)
    shape = np.asarray(sendbuf).shape
    pof2 = _pof2_floor(size)
    if size == 1:
        return np.array(flat, copy=True).reshape(shape)
    if flat.size < pof2:
        return allreduce_recursive_doubling(comm, sendbuf, op)
    tag = coll_tag(comm)
    acc = np.array(flat, copy=True)
    rem = size - pof2
    newrank = _fold_to_pof2(comm, acc, op, tag, rem)

    if newrank >= 0:
        blocks = _blocks(acc.size, pof2)

        def span(lo_b: int, hi_b: int) -> tuple[int, int]:
            """Element range covered by blocks [lo_b, hi_b)."""
            return blocks[lo_b][0], blocks[hi_b - 1][0] + blocks[hi_b - 1][1]

        # recursive halving reduce-scatter: window [lo, hi) of blocks
        lo, hi = 0, pof2
        mask = pof2 // 2
        while mask > 0:
            mid = (lo + hi) // 2
            peer = _pof2_real_rank(newrank ^ mask, rem)
            if newrank < mid:   # keep low half, trade away high half
                keep_lo, keep_hi = span(lo, mid)
                send_lo, send_hi = span(mid, hi)
                new_lo, new_hi = lo, mid
            else:
                keep_lo, keep_hi = span(mid, hi)
                send_lo, send_hi = span(lo, mid)
                new_lo, new_hi = mid, hi
            recv_seg = np.empty(keep_hi - keep_lo, acc.dtype)
            comm.sendrecv(acc[send_lo:send_hi], dest=peer, recvbuf=recv_seg,
                          source=peer, sendtag=tag, recvtag=tag)
            op(recv_seg, acc[keep_lo:keep_hi])
            lo, hi = new_lo, new_hi
            mask //= 2

        # recursive doubling allgather: widen [lo, hi) back to [0, pof2)
        mask = 1
        while mask < pof2:
            peer = _pof2_real_rank(newrank ^ mask, rem)
            width = hi - lo
            if newrank & mask:
                p_lo, p_hi = lo - width, lo
            else:
                p_lo, p_hi = hi, hi + width
            m_lo, m_hi = span(lo, hi)
            q_lo, q_hi = span(p_lo, p_hi)
            recv_seg = np.empty(q_hi - q_lo, acc.dtype)
            comm.sendrecv(acc[m_lo:m_hi], dest=peer, recvbuf=recv_seg,
                          source=peer, sendtag=tag, recvtag=tag)
            acc[q_lo:q_hi] = recv_seg
            lo, hi = min(lo, p_lo), max(hi, p_hi)
            mask <<= 1

    _unfold_from_pof2(comm, acc, tag, rem)
    return acc.reshape(shape)


# ---------------------------------------------------------------------------
# bcast menu (coll_base_bcast.c)


def bcast_binomial(comm, buf, root=0):
    """Binomial-tree bcast: lg(p) depth, the small-message winner."""
    tag = coll_tag(comm)
    arr = np.ascontiguousarray(buf)
    parent, children = _binomial_tree(comm.rank, comm.size, root)
    if parent is not None:
        out = np.empty_like(arr)
        comm.recv(out, source=parent, tag=tag)
        arr = out
    waitall([comm.isend(arr, dest=c, tag=tag) for c in children])
    return arr


def bcast_chain(comm, buf, root=0, segsize: int = 1 << 17):
    """Segmented chain bcast: the message flows vrank→vrank+1 in segments so
    every link carries a segment per step (pipeline fill lg-free)."""
    size, rank = comm.size, comm.rank
    arr = np.ascontiguousarray(buf)
    if size == 1:
        return arr
    tag = coll_tag(comm)
    vrank = (rank - root) % size
    prev = (rank - 1) % size
    nxt = (rank + 1) % size
    flat = (np.array(arr, copy=True).reshape(-1) if rank == root
            else np.empty(arr.size, arr.dtype))
    seg_elems = max(1, segsize // arr.dtype.itemsize)
    nseg = (flat.size + seg_elems - 1) // seg_elems
    reqs = []
    for s in range(nseg):
        sl = flat[s * seg_elems:(s + 1) * seg_elems]
        if vrank != 0:
            comm.recv(sl, source=prev, tag=tag)
        if vrank != size - 1:
            reqs.append(comm.isend(sl, dest=nxt, tag=tag))
    waitall(reqs)
    return flat.reshape(arr.shape)


def bcast_scatter_allgather(comm, buf, root=0):
    """Scatter + ring allgather (bandwidth-optimal large-message bcast)."""
    size, rank = comm.size, comm.rank
    arr = np.ascontiguousarray(buf)
    if size == 1:
        return arr
    if arr.size < size:
        return bcast_binomial(comm, buf, root)
    tag = coll_tag(comm)
    flat = (np.array(arr, copy=True).reshape(-1) if rank == root
            else np.empty(arr.size, arr.dtype))
    blocks = _blocks(flat.size, size)
    if rank == root:
        reqs = []
        for r in range(size):
            if r != root:
                off, cnt = blocks[r]
                reqs.append(comm.isend(flat[off:off + cnt], dest=r, tag=tag))
        waitall(reqs)
    else:
        off, cnt = blocks[rank]
        comm.recv(flat[off:off + cnt], source=root, tag=tag)
    right, left = (rank + 1) % size, (rank - 1) % size
    for k in range(size - 1):
        soff, scnt = blocks[(rank - k) % size]
        roff, rcnt = blocks[(rank - k - 1) % size]
        comm.sendrecv(flat[soff:soff + scnt], dest=right,
                      recvbuf=flat[roff:roff + rcnt], source=left,
                      sendtag=tag, recvtag=tag)
    return flat.reshape(arr.shape)


# ---------------------------------------------------------------------------
# reduce menu (coll_base_reduce.c)


def reduce_binomial(comm, sendbuf, op=op_mod.SUM, root=0):
    """Binomial-tree reduce: lg(p) rounds.  Fold order is tree order, so
    commutative ops only (the reference's in-order binary tree serves the
    non-commutative case; here that role falls to linear ``basic.reduce``)."""
    tag = coll_tag(comm)
    acc = np.array(np.ascontiguousarray(sendbuf), copy=True)
    size = comm.size
    vrank = (comm.rank - root) % size
    mask = 1
    while mask < size:
        if vrank & mask:
            peer = ((vrank - mask) + root) % size
            comm.send(acc, dest=peer, tag=tag)
            break
        peer_v = vrank | mask
        if peer_v < size:
            other = np.empty_like(acc)
            comm.recv(other, source=(peer_v + root) % size, tag=tag)
            op(other, acc)
        mask <<= 1
    return acc if comm.rank == root else None


def reduce_pipeline(comm, sendbuf, op=op_mod.SUM, root=0,
                    segsize: int = 1 << 17):
    """Segmented chain reduce: segments fold from rank p-1 down the chain to
    rank 0, preserving MPI rank order (b0 op (b1 op (… b_{p-1})));
    rank 0 forwards the result to root if different.  Order-safe."""
    size, rank = comm.size, comm.rank
    arr = np.ascontiguousarray(sendbuf)
    if size == 1:
        return np.array(arr, copy=True)
    tag = coll_tag(comm)
    flat = arr.reshape(-1)
    seg_elems = max(1, segsize // arr.dtype.itemsize)
    nseg = (flat.size + seg_elems - 1) // seg_elems
    acc = np.array(flat, copy=True)
    reqs = []
    for s in range(nseg):
        sl = slice(s * seg_elems, (s + 1) * seg_elems)
        if rank < size - 1:
            inbuf = np.empty(acc[sl].size, acc.dtype)
            comm.recv(inbuf, source=rank + 1, tag=tag)
            # inbuf holds the fold of ranks > me; mine is the earlier operand
            op(acc[sl], inbuf)
            acc[sl] = inbuf
        if rank > 0:
            reqs.append(comm.isend(acc[sl], dest=rank - 1, tag=tag))
    waitall(reqs)
    if root != 0:
        if rank == 0:
            comm.send(acc, dest=root, tag=tag)
        elif rank == root:
            comm.recv(acc, source=0, tag=tag)
    return acc.reshape(arr.shape) if rank == root else None


# ---------------------------------------------------------------------------
# allgather menu (coll_base_allgather.c)


def allgather_bruck(comm, sendbuf):
    """Bruck allgather: lg(p) rounds of doubling block exchanges, works for
    any p.  Output is the (size, ...) stack in rank order."""
    size, rank = comm.size, comm.rank
    arr = np.ascontiguousarray(sendbuf)
    out = np.empty((size, *arr.shape), arr.dtype)
    if size == 1:
        out[0] = arr
        return out
    tag = coll_tag(comm)
    # work in vrank space: slot k holds the block of rank (rank + k) % size
    work = np.empty_like(out)
    work[0] = arr
    have = 1
    step = 1
    while step < size:
        dst = (rank - step) % size
        cnt = min(step, size - have)
        sendblk = work[:cnt]
        recvblk = np.empty((cnt, *arr.shape), arr.dtype)
        comm.sendrecv(sendblk, dest=dst, recvbuf=recvblk,
                      source=(rank + step) % size, sendtag=tag, recvtag=tag)
        work[have:have + cnt] = recvblk
        have += cnt
        step <<= 1
    # unshift: slot k is rank (rank + k) % size
    for k in range(size):
        out[(rank + k) % size] = work[k]
    return out


def allgather_recursive_doubling(comm, sendbuf):
    """Recursive-doubling allgather (power-of-2 comms; else bruck)."""
    size, rank = comm.size, comm.rank
    if size & (size - 1):
        return allgather_bruck(comm, sendbuf)
    arr = np.ascontiguousarray(sendbuf)
    out = np.empty((size, *arr.shape), arr.dtype)
    out[rank] = arr
    tag = coll_tag(comm)
    mask = 1
    while mask < size:
        peer = rank ^ mask
        base = rank & ~(mask - 1)          # start of my filled window
        peer_base = peer & ~(mask - 1)
        recvblk = np.empty((mask, *arr.shape), arr.dtype)
        comm.sendrecv(out[base:base + mask], dest=peer, recvbuf=recvblk,
                      source=peer, sendtag=tag, recvtag=tag)
        out[peer_base:peer_base + mask] = recvblk
        mask <<= 1
    return out


def allgather_ring(comm, sendbuf):
    """Ring allgather: p-1 neighbor steps, bandwidth-optimal."""
    size, rank = comm.size, comm.rank
    arr = np.ascontiguousarray(sendbuf)
    out = np.empty((size, *arr.shape), arr.dtype)
    out[rank] = arr
    tag = coll_tag(comm)
    right, left = (rank + 1) % size, (rank - 1) % size
    for k in range(size - 1):
        sb = (rank - k) % size
        rb = (rank - k - 1) % size
        comm.sendrecv(out[sb:sb + 1], dest=right, recvbuf=out[rb:rb + 1],
                      source=left, sendtag=tag, recvtag=tag)
    return out


def allgather_neighbor_exchange(comm, sendbuf):
    """Neighbor-exchange allgather (Chen et al.; even p only, else ring):
    p/2 rounds of pairwise swaps with alternating left/right partners,
    each round forwarding the block pair learned in the previous round
    (``coll_base_allgather.c`` neighbor exchange)."""
    size, rank = comm.size, comm.rank
    if size % 2 or size <= 2:
        return allgather_ring(comm, sendbuf)
    arr = np.ascontiguousarray(sendbuf)
    out = np.empty((size, *arr.shape), arr.dtype)
    out[rank] = arr
    tag = coll_tag(comm)

    def partner(r: int, rnd: int) -> int:
        """Partner of rank r in round rnd (1-based): even ranks pair right
        on odd rounds and left on even rounds; odd ranks mirror."""
        right = (rnd % 2 == 1) if r % 2 == 0 else (rnd % 2 == 0)
        return (r + 1) % size if right else (r - 1) % size

    def pair_sent(r: int, rnd: int) -> tuple[int, int]:
        """Block pair r forwards in round rnd >= 2: its own base pair in
        round 2, afterwards the pair it received the round before."""
        if rnd == 2:
            base = r - (r % 2)
            return base, base + 1
        return pair_sent(partner(r, rnd - 1), rnd - 1)

    # round 1: single-block swap with the immediate partner
    p1 = partner(rank, 1)
    comm.sendrecv(out[rank:rank + 1], dest=p1,
                  recvbuf=out[p1:p1 + 1], source=p1,
                  sendtag=tag, recvtag=tag)
    for rnd in range(2, size // 2 + 1):
        peer = partner(rank, rnd)
        s0, s1 = pair_sent(rank, rnd)
        r0, r1 = pair_sent(peer, rnd)
        sendblk = np.stack([out[s0], out[s1]])
        recvblk = np.empty_like(sendblk)
        comm.sendrecv(sendblk, dest=peer, recvbuf=recvblk, source=peer,
                      sendtag=tag, recvtag=tag)
        out[r0] = recvblk[0]
        out[r1] = recvblk[1]
    return out


# ---------------------------------------------------------------------------
# alltoall menu (coll_base_alltoall.c)


def alltoall_pairwise(comm, sendbuf):
    """Pairwise-exchange alltoall: p-1 sendrecv steps with rotating partners
    (``coll_base_alltoall.c`` pairwise)."""
    size, rank = comm.size, comm.rank
    stack = np.ascontiguousarray(sendbuf)
    if stack.shape[0] != size:
        raise ValueError("alltoall needs a (size, ...) stack per rank")
    out = np.empty_like(stack)
    out[rank] = stack[rank]
    tag = coll_tag(comm)
    for step in range(1, size):
        dst = (rank + step) % size
        src = (rank - step) % size
        comm.sendrecv(stack[dst:dst + 1], dest=dst,
                      recvbuf=out[src:src + 1], source=src,
                      sendtag=tag, recvtag=tag)
    return out


def alltoall_bruck(comm, sendbuf):
    """Bruck alltoall: lg(p) rounds moving packed block sets — the
    small-message latency winner (``coll_base_alltoall.c`` bruck)."""
    size, rank = comm.size, comm.rank
    stack = np.ascontiguousarray(sendbuf)
    if stack.shape[0] != size:
        raise ValueError("alltoall needs a (size, ...) stack per rank")
    if size == 1:
        return np.array(stack, copy=True)
    tag = coll_tag(comm)
    # phase 1: local rotation so slot k targets rank (rank + k) % size
    work = np.array(np.roll(stack, -rank, axis=0), copy=True)
    # phase 2: for each bit, send the slots with that bit set to rank+2^k
    pof2 = 1
    while pof2 < size:
        idx = [k for k in range(size) if k & pof2]
        sendblk = np.stack([work[k] for k in idx])
        recvblk = np.empty_like(sendblk)
        comm.sendrecv(sendblk, dest=(rank + pof2) % size, recvbuf=recvblk,
                      source=(rank - pof2) % size, sendtag=tag, recvtag=tag)
        for j, k in enumerate(idx):
            work[k] = recvblk[j]
        pof2 <<= 1
    # phase 3: inverse rotation + reversal to rank order
    out = np.empty_like(work)
    for k in range(size):
        out[(rank - k) % size] = work[k]
    return out


# ---------------------------------------------------------------------------
# barrier menu (coll_base_barrier.c)


def barrier_recursive_doubling(comm):
    """Recursive-doubling barrier with non-pof2 pre/post folding."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    tag = coll_tag(comm)
    token = np.zeros(1, np.uint8)
    scratch = np.zeros(1, np.uint8)
    pof2 = _pof2_floor(size)
    rem = size - pof2
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.send(token, dest=rank + 1, tag=tag)
            newrank = -1
        else:
            comm.recv(scratch, source=rank - 1, tag=tag)
            newrank = rank // 2
    else:
        newrank = rank - rem
    if newrank >= 0:
        mask = 1
        while mask < pof2:
            peer = _pof2_real_rank(newrank ^ mask, rem)
            comm.sendrecv(token, dest=peer, recvbuf=scratch, source=peer,
                          sendtag=tag, recvtag=tag)
            mask <<= 1
    if rank < 2 * rem:
        if rank % 2 != 0:
            comm.send(token, dest=rank - 1, tag=tag)
        else:
            comm.recv(scratch, source=rank + 1, tag=tag)


def barrier_bruck(comm):
    """Bruck dissemination barrier: ceil(lg p) rounds, any p."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    tag = coll_tag(comm)
    token = np.zeros(1, np.uint8)
    scratch = np.zeros(1, np.uint8)
    step = 1
    while step < size:
        comm.sendrecv(token, dest=(rank + step) % size, recvbuf=scratch,
                      source=(rank - step) % size, sendtag=tag, recvtag=tag)
        step <<= 1


def barrier_tree(comm):
    """Binomial fan-in + fan-out barrier."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    tag = coll_tag(comm)
    token = np.zeros(1, np.uint8)
    parent, children = _binomial_tree(rank, size, 0)
    for c in children:
        comm.recv(np.zeros(1, np.uint8), source=c, tag=tag)
    if parent is not None:
        comm.send(token, dest=parent, tag=tag)
        comm.recv(np.zeros(1, np.uint8), source=parent, tag=tag)
    waitall([comm.isend(token, dest=c, tag=tag) for c in children])


# ---------------------------------------------------------------------------
# reduce_scatter menu (coll_base_reduce_scatter.c)


def reduce_scatter_recursive_halving(comm, sendbuf, recvcounts=None,
                                     op=op_mod.SUM):
    """Recursive-halving reduce_scatter (commutative, pof2 sizes; otherwise
    falls back to the reduce+scatterv composition)."""
    size, rank = comm.size, comm.rank
    flat = np.ascontiguousarray(sendbuf).reshape(-1)
    if recvcounts is None:
        recvcounts = [cnt for _, cnt in _blocks(flat.size, size)]
    if size & (size - 1) or size == 1 or min(recvcounts) == 0:
        return _basic.reduce_scatter(comm, sendbuf, recvcounts, op)
    tag = coll_tag(comm)
    acc = np.array(flat, copy=True)
    offs = np.concatenate([[0], np.cumsum(recvcounts)]).astype(int)

    lo, hi = 0, size
    mask = size // 2
    while mask > 0:
        mid = (lo + hi) // 2
        peer = rank ^ mask
        if rank < mid:
            keep_lo, keep_hi = offs[lo], offs[mid]
            send_lo, send_hi = offs[mid], offs[hi]
            new_lo, new_hi = lo, mid
        else:
            keep_lo, keep_hi = offs[mid], offs[hi]
            send_lo, send_hi = offs[lo], offs[mid]
            new_lo, new_hi = mid, hi
        recv_seg = np.empty(keep_hi - keep_lo, acc.dtype)
        comm.sendrecv(acc[send_lo:send_hi], dest=peer, recvbuf=recv_seg,
                      source=peer, sendtag=tag, recvtag=tag)
        op(recv_seg, acc[keep_lo:keep_hi])
        lo, hi = new_lo, new_hi
        mask //= 2
    return np.array(acc[offs[rank]:offs[rank + 1]], copy=True)


def reduce_scatter_ring(comm, sendbuf, recvcounts=None, op=op_mod.SUM):
    """Ring reduce_scatter: the reduce-scatter half of the ring allreduce,
    generalized to caller recvcounts.  Commutative only."""
    size, rank = comm.size, comm.rank
    flat = np.ascontiguousarray(sendbuf).reshape(-1)
    if recvcounts is None:
        recvcounts = [cnt for _, cnt in _blocks(flat.size, size)]
    if size == 1:
        return np.array(flat[:recvcounts[0]], copy=True)
    tag = coll_tag(comm)
    acc = np.array(flat, copy=True)
    offs = np.concatenate([[0], np.cumsum(recvcounts)]).astype(int)
    right, left = (rank + 1) % size, (rank - 1) % size
    # schedule shifted one block vs the allreduce ring so the fully-reduced
    # block that lands on each rank is its OWN block, not block rank+1
    for k in range(size - 1):
        sb = (rank - 1 - k) % size
        rb = (rank - 2 - k) % size
        inbuf = np.empty(int(recvcounts[rb]), acc.dtype)
        comm.sendrecv(acc[offs[sb]:offs[sb + 1]], dest=right, recvbuf=inbuf,
                      source=left, sendtag=tag, recvtag=tag)
        op(inbuf, acc[offs[rb]:offs[rb + 1]])
    return np.array(acc[offs[rank]:offs[rank + 1]], copy=True)


# ---------------------------------------------------------------------------
# gather / scatter (binomial trees, coll_base_gather.c / coll_base_scatter.c)


def gather_binomial(comm, sendbuf, root=0):
    """Binomial-tree gather: each subtree root forwards its packed subtree
    block upward; lg(p) depth instead of linear fan-in."""
    size, rank = comm.size, comm.rank
    arr = np.ascontiguousarray(sendbuf)
    tag = coll_tag(comm)
    vrank = (rank - root) % size
    # subtree span in vrank space: [vrank, vrank + span)
    if vrank == 0:
        span = size
    else:
        lowbit = vrank & -vrank
        span = min(lowbit, size - vrank)
    buf = np.empty((span, *arr.shape), arr.dtype)
    buf[0] = arr
    # receive children subtrees (mask ascending = child subtree size)
    mask = 1
    while mask < span:
        child_v = vrank + mask
        if child_v < size:
            child_span = min(mask, size - child_v)
            comm.recv(buf[mask:mask + child_span],
                      source=(child_v + root) % size, tag=tag)
        mask <<= 1
    if vrank != 0:
        parent = ((vrank - (vrank & -vrank)) + root) % size
        comm.send(buf, dest=parent, tag=tag)
        return None
    # root: unrotate from vrank order to rank order
    out = np.empty_like(buf)
    for k in range(size):
        out[(k + root) % size] = buf[k]
    return out


def scatter_binomial(comm, sendbuf, root=0):
    """Binomial-tree scatter: root sends each child its whole subtree block;
    mirror image of gather_binomial."""
    size, rank = comm.size, comm.rank
    tag = coll_tag(comm)
    vrank = (rank - root) % size
    if vrank == 0:
        span = size
    else:
        lowbit = vrank & -vrank
        span = min(lowbit, size - vrank)
    if rank == root:
        stack = np.ascontiguousarray(sendbuf)
        if stack.shape[0] != size:
            raise ValueError("scatter needs (size, ...) on root")
        buf = np.empty_like(stack)
        for k in range(size):           # rotate into vrank order
            buf[k] = stack[(k + root) % size]
    else:
        template = np.ascontiguousarray(sendbuf)
        buf = np.empty((span, *template.shape), template.dtype)
        parent = ((vrank - (vrank & -vrank)) + root) % size
        comm.recv(buf, source=parent, tag=tag)
    # forward child subtree blocks (descending mask so big subtrees go first)
    masks = []
    mask = 1
    while mask < span:
        masks.append(mask)
        mask <<= 1
    reqs = []
    for mask in reversed(masks):
        child_v = vrank + mask
        if child_v < size:
            child_span = min(mask, size - child_v)
            reqs.append(comm.isend(buf[mask:mask + child_span],
                                   dest=(child_v + root) % size, tag=tag))
    waitall(reqs)
    return np.array(buf[0], copy=True)


# registry the tuned component indexes: name -> callable
ALLREDUCE = {
    "nonoverlapping": allreduce_nonoverlapping,
    "recursive_doubling": allreduce_recursive_doubling,
    "ring": allreduce_ring,
    "ring_segmented": allreduce_ring_segmented,
    "rabenseifner": allreduce_redscat_allgather,
    "linear": lambda comm, buf, op=op_mod.SUM: _basic.allreduce(comm, buf, op),
}
BCAST = {
    "binomial": bcast_binomial,
    "chain": bcast_chain,
    "scatter_allgather": bcast_scatter_allgather,
    "linear": lambda comm, buf, root=0: _basic.bcast(comm, buf, root),
}
REDUCE = {
    "binomial": reduce_binomial,
    "pipeline": reduce_pipeline,
    "linear": lambda comm, buf, op=op_mod.SUM, root=0:
        _basic.reduce(comm, buf, op, root),
}
ALLGATHER = {
    "bruck": allgather_bruck,
    "recursive_doubling": allgather_recursive_doubling,
    "ring": allgather_ring,
    "neighbor": allgather_neighbor_exchange,
    "linear": lambda comm, buf: _basic.allgather(comm, buf),
}
ALLTOALL = {
    "bruck": alltoall_bruck,
    "pairwise": alltoall_pairwise,
    "linear": lambda comm, buf: _basic.alltoall(comm, buf),
}
BARRIER = {
    "recursive_doubling": barrier_recursive_doubling,
    "bruck": barrier_bruck,
    "tree": barrier_tree,
    "linear": lambda comm: _basic.barrier(comm),
}
REDUCE_SCATTER = {
    "recursive_halving": reduce_scatter_recursive_halving,
    "ring": reduce_scatter_ring,
    "basic": lambda comm, buf, counts=None, op=op_mod.SUM:
        _basic.reduce_scatter(comm, buf, counts, op),
}
GATHER = {
    "binomial": gather_binomial,
    "linear": lambda comm, buf, root=0: _basic.gather(comm, buf, root),
}
SCATTER = {
    "binomial": scatter_binomial,
    "linear": lambda comm, buf, root=0: _basic.scatter(comm, buf, root),
}
