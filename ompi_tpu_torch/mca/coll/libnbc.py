"""coll/libnbc — nonblocking collectives as progress-driven schedules.

Copy of ``ompi_tpu/mca/coll/libnbc.py`` (after the reference's
``ompi/mca/coll/libnbc/``): each nonblocking collective compiles into a
**schedule** — an ordered list of rounds, each holding local compute
(OP/COPY) and p2p postings (``nbc_internal.h:149-156`` round/delimiter
encoding) — attached to a request that the central progress engine
(``runtime/progress.py``) advances round by round.  A round's local actions
run when the round starts; its sends/receives are posted nonblocking; the
round completes when every posted request completes.  The request
unregisters its progress callback when it completes.

Priority 25: above coll/basic (10) so these schedules own the twelve
``i*`` slots on multi-process communicators, below coll/tuned (30) whose
blocking ladders own the blocking slots.  A tensor given to a slot is
staged to the host once, at the slot's entry, and results are numpy.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.request import Request
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.coll.basic import coll_tag, staged
from ompi_tpu_torch.runtime import progress as progress_engine


class Round:
    """One schedule round: local actions, then p2p postings."""

    __slots__ = ("local", "p2p")

    def __init__(self) -> None:
        self.local: list[Callable[[], None]] = []
        self.p2p: list[tuple] = []   # ("send"|"recv", buf, peer, tag)

    def add_local(self, fn: Callable[[], None]) -> "Round":
        self.local.append(fn)
        return self

    def add_send(self, buf, dest: int, tag: int) -> "Round":
        self.p2p.append(("send", buf, dest, tag))
        return self

    def add_recv(self, buf, source: int, tag: int) -> "Round":
        self.p2p.append(("recv", buf, source, tag))
        return self

    @property
    def empty(self) -> bool:
        return not self.local and not self.p2p


class NbcRequest(Request):
    """A collective in flight: advances its schedule from the progress loop."""

    def __init__(self, comm, rounds: list[Round],
                 finish: Optional[Callable[[], object]] = None):
        super().__init__()
        import threading

        self.comm = comm
        self.rounds = [r for r in rounds if not r.empty]
        self._finish = finish
        self.result = None
        self._round_idx = -1
        self._subreqs: list[Request] = []
        # any thread inside the progress loop may drive this schedule;
        # only one may advance it at a time (others simply skip this pass)
        self._adv_lock = threading.Lock()
        progress_engine.register(self._progress_cb)
        self._advance()   # start round 0 immediately (libnbc Sched_commit)

    def _start_round(self, rnd: Round) -> None:
        for fn in rnd.local:
            fn()
        self._subreqs = []
        for kind, buf, peer, tag in rnd.p2p:
            if kind == "send":
                self._subreqs.append(self.comm.isend(buf, dest=peer, tag=tag))
            else:
                self._subreqs.append(self.comm.irecv(buf, source=peer,
                                                     tag=tag))

    def _advance(self) -> int:
        """Move through as many rounds as are already complete."""
        if not self._adv_lock.acquire(blocking=False):
            return 0   # another thread is already advancing this schedule
        try:
            events = 0
            while True:
                if self._round_idx >= 0:
                    if not all(r.complete_flag for r in self._subreqs):
                        return events
                    for r in self._subreqs:
                        if r.error is not None:
                            self._done(error=r.error)
                            return events + 1
                self._round_idx += 1
                if self._round_idx >= len(self.rounds):
                    self._done()
                    return events + 1
                self._start_round(self.rounds[self._round_idx])
                events += 1
        finally:
            self._adv_lock.release()

    def _done(self, error=None) -> None:
        progress_engine.unregister(self._progress_cb)
        if error is None and self._finish is not None:
            self.result = self._finish()
        self.complete(error)

    def _progress_cb(self) -> int:
        if self.complete_flag:
            progress_engine.unregister(self._progress_cb)
            return 0
        return self._advance()


def _completed(result=None) -> NbcRequest:
    class _Trivial(Request):
        pass
    req = _Trivial()
    req.result = result
    req.complete()
    return req


class LibnbcModule:
    """Schedule builders for every nonblocking collective."""

    # -- ibarrier: bruck dissemination (any p) ---------------------------
    def ibarrier(self, comm) -> Request:
        size, rank = comm.size, comm.rank
        if size == 1:
            return _completed()
        tag = coll_tag(comm)
        rounds = []
        step = 1
        while step < size:
            r = Round()
            r.add_send(np.zeros(1, np.uint8), (rank + step) % size, tag)
            r.add_recv(np.zeros(1, np.uint8), (rank - step) % size, tag)
            rounds.append(r)
            step <<= 1
        return NbcRequest(comm, rounds)

    # -- ibcast: binomial tree -------------------------------------------
    def ibcast(self, comm, buf, root=0) -> Request:
        from ompi_tpu_torch.mca.coll.algorithms import _binomial_tree

        arr = np.array(np.ascontiguousarray(staged(buf)), copy=True)
        if comm.size == 1:
            return _completed(arr)
        tag = coll_tag(comm)
        parent, children = _binomial_tree(comm.rank, comm.size, root)
        rounds = []
        if parent is not None:
            rounds.append(Round().add_recv(arr, parent, tag))
        if children:
            send_round = Round()
            for c in children:
                send_round.add_send(arr, c, tag)
            rounds.append(send_round)
        return NbcRequest(comm, rounds, finish=lambda: arr)

    # -- ireduce ----------------------------------------------------------
    def ireduce(self, comm, sendbuf, op=op_mod.SUM, root=0) -> Request:
        size, rank = comm.size, comm.rank
        acc = np.array(np.ascontiguousarray(staged(sendbuf)), copy=True)
        if size == 1:
            return _completed(acc)
        tag = coll_tag(comm)
        rounds = []
        if not op.commute:
            # linear fan-in at root, folded in rank order
            if rank == root:
                bufs = {r: np.empty_like(acc) for r in range(size)
                        if r != root}
                rnd = Round()
                for r, b in bufs.items():
                    rnd.add_recv(b, r, tag)
                rounds.append(rnd)

                def fold():
                    ordered = [bufs[r] if r != root else acc
                               for r in range(size)]
                    result = ordered[-1].copy()
                    for i in range(size - 2, -1, -1):
                        op(ordered[i], result)
                    acc[...] = result
                rounds.append(Round().add_local(fold))
            else:
                rounds.append(Round().add_send(acc, root, tag))
        else:
            # binomial fan-in (tree order; commutative only)
            vrank = (rank - root) % size
            mask = 1
            while mask < size:
                if vrank & mask:
                    peer = ((vrank - mask) + root) % size
                    rounds.append(Round().add_send(acc, peer, tag))
                    break
                peer_v = vrank | mask
                if peer_v < size:
                    other = np.empty_like(acc)
                    rnd = Round().add_recv(other, (peer_v + root) % size, tag)
                    rounds.append(rnd)
                    rounds.append(Round().add_local(
                        lambda o=other: op(o, acc)))
                mask <<= 1
        return NbcRequest(
            comm, rounds,
            finish=lambda: acc if rank == root else None)

    # -- iallreduce: recursive doubling ----------------------------------
    def iallreduce(self, comm, sendbuf, op=op_mod.SUM) -> Request:
        from ompi_tpu_torch.mca.coll.algorithms import _pof2_floor, _pof2_real_rank

        size, rank = comm.size, comm.rank
        acc = np.array(np.ascontiguousarray(staged(sendbuf)), copy=True)
        if size == 1:
            return _completed(acc)
        tag = coll_tag(comm)
        pof2 = _pof2_floor(size)
        rem = size - pof2
        rounds = []

        if rank < 2 * rem:
            if rank % 2 == 0:
                rounds.append(Round().add_send(acc, rank + 1, tag))
                newrank = -1
            else:
                other0 = np.empty_like(acc)
                rounds.append(Round().add_recv(other0, rank - 1, tag))
                rounds.append(Round().add_local(
                    lambda o=other0: op(o, acc)))
                newrank = rank // 2
        else:
            newrank = rank - rem

        if newrank >= 0:
            mask = 1
            while mask < pof2:
                peer = _pof2_real_rank(newrank ^ mask, rem)
                other = np.empty_like(acc)
                rnd = Round()
                rnd.add_send(acc, peer, tag)
                rnd.add_recv(other, peer, tag)
                rounds.append(rnd)

                def combine(o=other, peer=peer):
                    if peer < rank:
                        op(o, acc)          # theirs (op) mine
                    else:
                        tmp = acc.copy()
                        o2 = o.copy()
                        op(tmp, o2)         # mine (op) theirs
                        acc[...] = o2
                rounds.append(Round().add_local(combine))
                mask <<= 1

        if rank < 2 * rem:
            if rank % 2 != 0:
                rounds.append(Round().add_send(acc, rank - 1, tag))
            else:
                rounds.append(Round().add_recv(acc, rank + 1, tag))
        return NbcRequest(comm, rounds, finish=lambda: acc)

    # -- iallgather: bruck ------------------------------------------------
    def iallgather(self, comm, sendbuf) -> Request:
        size, rank = comm.size, comm.rank
        arr = np.ascontiguousarray(staged(sendbuf))
        work = np.empty((size, *arr.shape), arr.dtype)
        work[0] = arr
        if size == 1:
            return _completed(work.copy())
        tag = coll_tag(comm)
        rounds = []
        have, step = 1, 1
        while step < size:
            cnt = min(step, size - have)
            recvblk = np.empty((cnt, *arr.shape), arr.dtype)
            rnd = Round()
            # bruck sends the FIRST cnt slots; they are final by this round
            rnd.add_send(work[:cnt], (rank - step) % size, tag)
            rnd.add_recv(recvblk, (rank + step) % size, tag)
            rounds.append(rnd)
            rounds.append(Round().add_local(
                lambda h=have, c=cnt, rb=recvblk: work.__setitem__(
                    slice(h, h + c), rb)))
            have += cnt
            step <<= 1

        def unshift():
            out = np.empty_like(work)
            for k in range(size):
                out[(rank + k) % size] = work[k]
            return out
        return NbcRequest(comm, rounds, finish=unshift)

    # -- ialltoall: linear, fully overlapped ------------------------------
    def ialltoall(self, comm, sendbuf) -> Request:
        size, rank = comm.size, comm.rank
        stack = np.ascontiguousarray(staged(sendbuf))
        if stack.shape[0] != size:
            raise ValueError("alltoall needs a (size, ...) stack per rank")
        out = np.empty_like(stack)
        out[rank] = stack[rank]
        if size == 1:
            return _completed(out)
        tag = coll_tag(comm)
        rnd = Round()
        for r in range(size):
            if r != rank:
                rnd.add_send(np.ascontiguousarray(stack[r:r + 1]), r, tag)
                rnd.add_recv(out[r:r + 1], r, tag)
        return NbcRequest(comm, [rnd], finish=lambda: out)

    # -- igather / iscatter: linear --------------------------------------
    def igather(self, comm, sendbuf, root=0) -> Request:
        size, rank = comm.size, comm.rank
        arr = np.ascontiguousarray(staged(sendbuf))
        tag = coll_tag(comm)
        if rank == root:
            out = np.empty((size, *arr.shape), arr.dtype)
            out[root] = arr
            if size == 1:
                return _completed(out)
            rnd = Round()
            for r in range(size):
                if r != root:
                    rnd.add_recv(out[r:r + 1], r, tag)
            return NbcRequest(comm, [rnd], finish=lambda: out)
        return NbcRequest(comm, [Round().add_send(arr, root, tag)],
                          finish=lambda: None)

    def iscatter(self, comm, sendbuf, root=0) -> Request:
        size, rank = comm.size, comm.rank
        sendbuf = staged(sendbuf)
        tag = coll_tag(comm)
        if rank == root:
            stack = np.ascontiguousarray(sendbuf)
            if stack.shape[0] != size:
                raise ValueError("scatter needs (size, ...) on root")
            mine = np.array(stack[root], copy=True)
            if size == 1:
                return _completed(mine)
            rnd = Round()
            for r in range(size):
                if r != root:
                    rnd.add_send(np.ascontiguousarray(stack[r]), r, tag)
            return NbcRequest(comm, [rnd], finish=lambda: mine)
        out = np.empty_like(np.ascontiguousarray(sendbuf))
        return NbcRequest(comm, [Round().add_recv(out, root, tag)],
                          finish=lambda: out)

    # -- ireduce_scatter: reduce-to-0 + scatterv --------------------------
    def ireduce_scatter(self, comm, sendbuf, recvcounts=None,
                        op=op_mod.SUM) -> Request:
        from ompi_tpu_torch.mca.coll.algorithms import _blocks

        size, rank = comm.size, comm.rank
        flat = np.ascontiguousarray(staged(sendbuf)).reshape(-1)
        if recvcounts is None:
            recvcounts = [c for _, c in _blocks(flat.size, size)]
        offs = np.concatenate([[0], np.cumsum(recvcounts)]).astype(int)
        if size == 1:
            return _completed(np.array(flat[:recvcounts[0]], copy=True))
        tag = coll_tag(comm)
        acc = np.array(flat, copy=True)
        rounds = []
        if rank == 0:
            bufs = {r: np.empty_like(acc) for r in range(1, size)}
            rnd = Round()
            for r, b in bufs.items():
                rnd.add_recv(b, r, tag)
            rounds.append(rnd)

            def fold():
                ordered = [acc] + [bufs[r] for r in range(1, size)]
                result = ordered[-1].copy()
                for i in range(size - 2, -1, -1):
                    out = result.copy()
                    op(ordered[i], out)
                    result = out
                acc[...] = result
            rounds.append(Round().add_local(fold))
            scatter_rnd = Round()
            for r in range(1, size):
                scatter_rnd.add_send(acc[offs[r]:offs[r + 1]], r, tag)
            rounds.append(scatter_rnd)
            return NbcRequest(
                comm, rounds,
                finish=lambda: np.array(acc[offs[0]:offs[1]], copy=True))
        mine = np.empty(int(recvcounts[rank]), acc.dtype)
        rounds.append(Round().add_send(acc, 0, tag))
        rounds.append(Round().add_recv(mine, 0, tag))
        return NbcRequest(comm, rounds, finish=lambda: mine)

    # -- iscan / iexscan: chain ------------------------------------------
    def iscan(self, comm, sendbuf, op=op_mod.SUM) -> Request:
        size, rank = comm.size, comm.rank
        acc = np.array(np.ascontiguousarray(staged(sendbuf)), copy=True)
        if size == 1:
            return _completed(acc)
        tag = coll_tag(comm)
        rounds = []
        if rank > 0:
            prev = np.empty_like(acc)
            rounds.append(Round().add_recv(prev, rank - 1, tag))
            rounds.append(Round().add_local(lambda: op(prev, acc)))
        if rank < size - 1:
            rounds.append(Round().add_send(acc, rank + 1, tag))
        return NbcRequest(comm, rounds, finish=lambda: acc)

    def iexscan(self, comm, sendbuf, op=op_mod.SUM) -> Request:
        size, rank = comm.size, comm.rank
        arr = np.ascontiguousarray(staged(sendbuf))
        out = np.zeros_like(arr)
        if size == 1:
            return _completed(out)
        tag = coll_tag(comm)
        rounds = []
        if rank > 0:
            rounds.append(Round().add_recv(out, rank - 1, tag))
        if rank < size - 1:
            nxt = np.empty_like(arr)

            def make_next():
                if rank == 0:
                    nxt[...] = arr
                else:
                    val = np.array(arr, copy=True)
                    op(out, val)        # val = out (op) arr, rank order
                    nxt[...] = val
            rounds.append(Round().add_local(make_next))
            rounds.append(Round().add_send(nxt, rank + 1, tag))
        return NbcRequest(comm, rounds, finish=lambda: out)


class LibnbcCollComponent(Component):
    name = "libnbc"
    priority = 25

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=25,
            help="Selection priority of coll/libnbc")

    def comm_query(self, comm):
        if comm.rte is not None and comm.rte.is_device_world:
            return None   # conductor owns the device world
        if comm.size == 1:
            return None
        return self._prio.value, LibnbcModule()


COMPONENT = LibnbcCollComponent()
