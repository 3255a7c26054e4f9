"""coll/adapt — event-driven asynchronous bcast/reduce with segmentation.

Copy of ``ompi_tpu/mca/coll/adapt.py`` (after the reference's
``ompi/mca/coll/adapt/``): where libnbc advances fixed round schedules in
lockstep, adapt is EVENT-DRIVEN — a message is split into segments and each
segment flows down (bcast) or up (reduce) a binomial tree the moment it
arrives, driven by request completion callbacks rather than round barriers.

Provides the nonblocking ``ibcast``/``ireduce`` slots (and blocking
wrappers) at priority 28 when enabled; its priority var defaults to -1,
which leaves it off, as in the reference.  A tensor given to a slot is
staged to the host once, at the slot's entry, and results are numpy.
"""
from __future__ import annotations

import threading

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.request import Request
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.coll.algorithms import _binomial_tree
from ompi_tpu_torch.mca.coll.basic import coll_tag, staged


_SEG_SLOT = 1 << 22    # segments per collective before tags could wrap


def _seg_tag(tag: int, k: int) -> int:
    """Per-segment tag in a dedicated far-negative range: segment slots
    must not collide with subsequent collectives' base tags (coll_tag
    steps by 1) or any other internal tag space.  Each collective owns a
    2^22-segment slot (a 4 MiB-segment x 16 TiB message before wrap)."""
    return -(1 << 40) + (tag + 16) * _SEG_SLOT - k


class _Latch(Request):
    """A request completing after ``count`` constituent completions.

    The first constituent error is remembered and the latch completes IN
    ERROR, so a peer death or truncation mid-pipeline surfaces from
    ``wait()`` instead of returning partial data as success."""

    def __init__(self, count: int) -> None:
        super().__init__()
        self._remaining = count
        self._first_error = None
        self._latch_lock = threading.Lock()
        if count == 0:
            self.complete()

    def arm(self, req: Request) -> None:
        req.on_complete(self._hit)

    def _hit(self, req: Request) -> None:
        with self._latch_lock:
            if getattr(req, "error", None) is not None \
                    and self._first_error is None:
                self._first_error = req.error
            self._remaining -= 1
            done = self._remaining == 0
            err = self._first_error
        if done:
            self.complete(err)


class AdaptModule:
    def __init__(self, component: "AdaptCollComponent") -> None:
        self._c = component

    def _segments(self, arr: np.ndarray, align: int = 1) -> list:
        seg = max(align, int(self._c.seg_var.value))
        seg -= seg % align     # whole elements per segment
        flat = arr.view(np.uint8).reshape(-1)
        return [flat[i:i + seg] for i in range(0, len(flat), seg)] or [flat]

    # -- event-driven pipelined broadcast --------------------------------
    def ibcast(self, comm, buf, root: int = 0) -> Request:
        tag = coll_tag(comm)
        arr = np.ascontiguousarray(staged(buf))
        parent, children = _binomial_tree(comm.rank, comm.size, root)
        segs = self._segments(arr)
        nseg = len(segs)
        # completions to wait for: my recvs (non-root) + my forwards
        latch = _Latch((0 if parent is None else nseg)
                       + nseg * len(children))
        latch.result = arr
        pml = comm.pml
        if parent is None:
            for k, seg in enumerate(segs):
                for c in children:
                    latch.arm(pml.isend(comm, seg, c, _seg_tag(tag, k)))
        else:
            for k, seg in enumerate(segs):
                rreq = pml.irecv(comm, seg, parent, _seg_tag(tag, k))

                def forward(_r, seg=seg, k=k):
                    # the segment just landed: push it onward NOW —
                    # adapt's event-driven property (no round lockstep).
                    # An errored recv (truncation, dead peer) must NOT be
                    # forwarded: the latch already records the error, and
                    # descendants recover via FT propagation rather than
                    # receiving garbage marked success.
                    if _r.error is not None:
                        return
                    for c in children:
                        latch.arm(pml.isend(comm, seg, c,
                                            _seg_tag(tag, k)))

                rreq.on_complete(forward)
                latch.arm(rreq)
        return latch

    def bcast(self, comm, buf, root: int = 0):
        req = self.ibcast(comm, buf, root)
        req.wait()
        return req.result

    # -- event-driven pipelined reduce -----------------------------------
    def ireduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM,
                root: int = 0) -> Request:
        sendbuf = staged(sendbuf)
        if not op.commute:
            # arrival-order folding needs commutativity; rank-ordered
            # algorithms serve the rest (the reference's exclusion)
            from ompi_tpu_torch.api.request import CompletedRequest
            from ompi_tpu_torch.mca.coll.basic import BasicCollModule

            r = CompletedRequest()
            r.result = BasicCollModule().reduce(comm, sendbuf, op, root)
            return r
        tag = coll_tag(comm)
        arr = np.array(sendbuf, copy=True, order="C")
        dtype, shape = arr.dtype, arr.shape
        parent, children = _binomial_tree(comm.rank, comm.size, root)
        # segments must hold whole elements: the fold views them typed
        segs = self._segments(arr, align=arr.dtype.itemsize)
        nseg = len(segs)
        pml = comm.pml
        # per-segment: wait for each child's contribution, fold it in as
        # it arrives; when all children contributed, forward up
        pending = [len(children) for _ in range(nseg)]
        plock = threading.Lock()
        latch = _Latch(nseg * len(children)
                       + (0 if parent is None else nseg))
        latch.result = None

        def seg_done(k: int) -> None:
            if parent is not None:
                latch.arm(pml.isend(comm, segs[k], parent,
                                    _seg_tag(tag, k)))

        child_bufs = {}
        for k in range(nseg):
            if not children:
                seg_done(k)
                continue
            for c in children:
                cb = np.empty_like(segs[k])
                child_bufs[(c, k)] = cb
                rreq = pml.irecv(comm, cb, c, _seg_tag(tag, k))

                def fold(_r, c=c, k=k):
                    # an errored child recv contributes nothing: folding
                    # the uninitialised buffer would corrupt the segment
                    # and seg_done would ship it upward as success.  The
                    # latch records the error; the op completes in error.
                    if _r.error is not None:
                        return
                    cb = child_bufs[(c, k)]
                    with plock:
                        # the fold itself is inside the lock: completions
                        # can fire on concurrent progress threads, and two
                        # children's read-modify-writes of the same
                        # accumulator segment must not interleave
                        mine = segs[k].view(dtype)
                        op(cb.view(dtype), mine)
                        pending[k] -= 1
                        ready = pending[k] == 0
                    if ready:
                        seg_done(k)

                rreq.on_complete(fold)
                latch.arm(rreq)
        if parent is None:
            latch.result = arr.view(dtype).reshape(shape)
        return latch

    def reduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM,
               root: int = 0):
        req = self.ireduce(comm, sendbuf, op, root)
        req.wait()
        return req.result


class AdaptCollComponent(Component):
    name = "adapt"
    priority = 28

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=-1,
            help="Selection priority of coll/adapt (event-driven "
                 "segmented bcast/reduce); <0 disables, like the "
                 "reference's default")
        self.seg_var = self.register_var(
            "segsize", vtype=VarType.SIZE, default="64k",
            help="Segment size for the pipelined trees")

    def comm_query(self, comm):
        if int(self._prio.value) < 0:
            return None
        if comm.rte is not None and comm.rte.is_device_world:
            return None
        if comm.size < 2 or comm.is_inter:
            return None
        return int(self._prio.value), AdaptModule(self)


COMPONENT = AdaptCollComponent()
