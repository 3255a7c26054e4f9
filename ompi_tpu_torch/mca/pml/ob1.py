"""pml/ob1 — the default matching & protocol engine over BTLs.

Copy of ``ompi_tpu/mca/pml/ob1.py`` (after the reference's
``ompi/mca/pml/ob1/``): MPI matching by (comm, src, tag) with sender
sequence numbers, unexpected-message and out-of-order queues
(``pml_ob1_recvfrag.c:293,831,923``; ooo held by seq, ``:106-147``), and the
eager / rendezvous (RNDV/ACK/FRAG) / RGET protocol ladder selected by the
BTL's size limits (``pml_ob1_sendreq.h:375-401``).  Above ``rget_limit``
(512 KB) on a btl with the one-sided triple (btl/sm's mapped segments) the
sender exposes the packed stream and the receiver pulls it (RGET,
``ob1.py:252-290``, ``:723-875``); with ``rget_emulate`` a btl without it
(btl/tcp) carries the same rung as a receiver-requested FRAG stream
(``meta["pull"]``).  A card tensor as the send buffer is staged to the host
by ``as_buffer`` first, as for every other rung: there is no
device-to-device path.

Matching state is keyed by (cid, receiver world rank) so one process can
host every rank of the device world — ``mpirun --oversubscribe`` over
btl/self.  Each fragment of a contiguous float32 message carries
coll/quant's wire codec stamp (``Frag.qcodec``, ``ob1.py:301``, ``:326``,
``:387``, ``:409``) while ``otpu_coll_quant_wire`` is set; btl/tcp encodes
it, the other btls ignore it.  A rendezvous stream of ``stripe_min`` (2 MB)
or more stripes across every btl that reaches the peer (sm and tcp on one
node; SPC ``striped_msgs``).

The observability hooks are the reference's, each behind its module flag:
a ``send``/``recv`` span of category ``pml`` closing at request completion
(``ob1.py:214-248``, ``:431-446``) with the message's ``pml_msg`` flow key
``(cid, src, dst, seq)`` off the match header, PERUSE events in the
reference's order (``:224-478``, ``:604-855``, deferred past the match
lock), the ``send.pack``, ``recv.deliver`` and ``recv.complete`` stage
clocks, and ``memchecker.protect_send`` on the RGET and RNDV rungs (a
numpy send buffer is read-only until the request completes; a tensor is
staged to the host at the send's entry and not guarded).

The FT hooks are the reference's (``ob1.py:137-139``, ``:161-201``,
``:485-512``): the module listens for failures (``ft_state.on_failure``),
and ``_peer_failed`` completes every request whose explicit peer died with
``ProcFailedError`` (ANY_SOURCE receives stay posted), releasing an RGET
exposure a dead puller never released first, so its segment returns to the
pool and the sender's numpy buffer is writable again; a card tensor's
host copy (``as_buffer``'s staging) goes with its request.  A blocking
probe, which is never a posted request, polls the failure state and the
revocation set every 2048 spins (``_probe_liveness``).  Unlike the
reference, a revocation completes the comm's pending requests (posted and
matched receives, ANY_SOURCE ones too, and sends awaiting their ACK) with
``RevokedError`` (``_comm_revoked``, registered with ``ft_state.on_revoke``),
as ULFM's revoke requires: a rank blocked in a receive from a peer that
has left to recover is released.  The RGET control frames
(``ob1_rget_done``, ``ob1_rget_pull``) carry ``meta["reliable"]``: they
complete a transfer that has no retransmit, so chaos never drops or
duplicates them (``btl.base.loss_ok``).
"""
from __future__ import annotations

import itertools
import threading

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.request import Request
from ompi_tpu_torch.api.status import ANY_SOURCE, ANY_TAG, Status
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.datatype import Convertor
from ompi_tpu_torch.mca.bml import Bml
from ompi_tpu_torch.mca.btl.base import ACK, CTL, FRAG, MATCH, RGET, RNDV, \
    Frag
from ompi_tpu_torch.mca.coll import quant as quant_mod
from ompi_tpu_torch.runtime import memchecker, peruse, profile, spc, trace
from ompi_tpu_torch.runtime.hotpath import hot_path


def _peers(comm):
    """The group a point-to-point peer rank indexes: an intercomm's remote
    group, else the comm's own."""
    return comm.remote_group if comm.is_inter else comm.group


class SendRequest(Request):
    def __init__(self, pml, comm, buf, dest: int, tag: int):
        super().__init__()
        from ompi_tpu_torch.api.comm import as_buffer

        self.pml = pml
        self.comm = comm
        arr, count, dt = as_buffer(buf)
        self.convertor = Convertor(dt, count, arr)
        self.nbytes = self.convertor.packed_size
        self.dest = dest
        self.tag = tag
        self.req_id = next(pml._req_counter)
        self.acked = False


class RecvRequest(Request):
    def __init__(self, pml, comm, buf, source: int, tag: int):
        super().__init__()
        from ompi_tpu_torch.api.comm import as_buffer

        self.pml = pml
        self.comm = comm
        arr, count, dt = as_buffer(buf)
        self.convertor = Convertor(dt, count, arr)
        self.capacity = self.convertor.packed_size
        self.source = source            # comm rank or ANY_SOURCE
        self.tag = tag
        self.req_id = next(pml._req_counter)
        self.received = 0
        self.total = None               # known after match
        self.matched_src = None
        self._flow = None               # (cid, src, dst, seq) at deliver

    def matches(self, frag: Frag, comm_src: int) -> bool:
        if self.source != ANY_SOURCE and self.source != comm_src:
            return False
        if self.tag == ANY_TAG:
            return frag.tag >= 0        # wildcards never match internal tags
        return self.tag == frag.tag

    def _try_cancel(self) -> bool:
        return self.pml._cancel_recv(self)


class Message:
    """``MPI_Mprobe`` matched-message handle."""

    def __init__(self, pml, comm, frag: Frag, status: Status):
        self._pml = pml
        self._comm = comm
        self._frag = frag
        self.status = status

    def recv(self, buf) -> Status:
        req = RecvRequest(self._pml, self._comm, buf,
                          self.status.source, self.status.tag)
        self._pml._deliver_to_request(req, self._frag)
        return req.wait()

    def irecv(self, buf) -> Request:
        """``MPI_Imrecv``: nonblocking receive of the matched message."""
        req = RecvRequest(self._pml, self._comm, buf,
                          self.status.source, self.status.tag)
        self._pml._deliver_to_request(req, self._frag)
        return req


class _MatchState:
    """Per-(cid, receiver) matching queues."""

    __slots__ = ("posted", "unexpected", "expected_seq", "ooo")

    def __init__(self) -> None:
        self.posted: list[RecvRequest] = []
        self.unexpected: list[Frag] = []
        self.expected_seq: dict[int, int] = {}   # src world rank -> next seq
        self.ooo: dict[int, dict[int, Frag]] = {}


class Ob1Pml:
    """The pml module (one per process)."""

    def __init__(self, component: "Ob1Component", rte) -> None:
        self.component = component
        self.rte = rte
        self._lock = threading.RLock()
        self._match: dict[tuple[int, int], _MatchState] = {}
        self._seq: dict[tuple[int, int, int], itertools.count] = {}
        self._req_counter = itertools.count(1)
        self._send_reqs: dict[int, SendRequest] = {}
        self._recv_reqs: dict[int, RecvRequest] = {}
        self.bml = Bml(rte, self._recv_frag)
        # req_ft.c: a peer's death completes its pending requests in
        # error instead of leaving their waiters blocked forever
        from ompi_tpu_torch.ft import state as ft_state

        ft_state.on_failure(self._peer_failed)
        ft_state.on_revoke(self._comm_revoked)
        register_ctl_handler("ob1_rget_done", self._on_rget_done)
        register_ctl_handler("ob1_rget_pull", self._on_rget_pull)

    # -- framework hooks -------------------------------------------------
    def add_comm(self, comm) -> None:
        with self._lock:
            for r in comm.group.world_ranks:
                self._match.setdefault((comm.cid, r), _MatchState())

    def del_comm(self, comm) -> None:
        """Drop per-comm matching state (``MPI_Comm_free`` teardown)."""
        with self._lock:
            for key in [k for k in self._match if k[0] == comm.cid]:
                del self._match[key]
            for key in [k for k in self._seq if k[0] == comm.cid]:
                del self._seq[key]

    def finalize(self) -> None:
        self.bml.finalize()

    # -- FT request completion (``ompi/request/req_ft.c``) ---------------
    def _peer_failed(self, world_rank: int) -> None:
        """Complete pending requests whose explicit peer died, in error.

        ANY_SOURCE receives are left pending (the reference raises
        ERR_PROC_FAILED_PENDING, a warning, without destroying them)."""
        from ompi_tpu_torch.api.errors import ProcFailedError

        err = ProcFailedError(f"peer world rank {world_rank} failed",
                              (world_rank,))
        victims = []
        with self._lock:
            for st in self._match.values():
                for req in list(st.posted):
                    if req.source == ANY_SOURCE:
                        continue
                    try:
                        src_w = _peers(req.comm).world_rank(req.source)
                    except Exception:
                        continue
                    if src_w == world_rank:
                        st.posted.remove(req)
                        victims.append(req)
            for rid, req in list(self._recv_reqs.items()):
                if req.matched_src == world_rank:
                    del self._recv_reqs[rid]
                    victims.append(req)
            for rid, req in list(self._send_reqs.items()):
                try:
                    if _peers(req.comm).world_rank(req.dest) == world_rank:
                        del self._send_reqs[rid]
                        victims.append(req)
                except Exception:
                    continue
        for req in victims:
            _release_rget(req)   # a dead puller must not leak the segment
            req.complete(err)

    def _comm_revoked(self, job: str, cid: int, epoch: int) -> None:
        """Complete every pending request of the revoked comm in error
        (ULFM's revoke: ``MPI_ERR_REVOKED`` for the comm's pending
        operations)."""
        from ompi_tpu_torch.api.errors import RevokedError

        def on_it(req) -> bool:
            c = getattr(req, "comm", None)
            return (c is not None and c.cid == cid and c.epoch == epoch
                    and str(c.ft_scope) == str(job))

        victims = []
        with self._lock:
            for st in self._match.values():
                for req in list(st.posted):
                    if on_it(req):
                        st.posted.remove(req)
                        victims.append(req)
            for table in (self._recv_reqs, self._send_reqs):
                for rid, req in list(table.items()):
                    if on_it(req):
                        del table[rid]
                        victims.append(req)
        if not victims:
            return
        err = RevokedError(f"communicator cid {cid} (epoch {epoch}) "
                           "revoked with the request pending")
        for req in victims:
            _release_rget(req)
            req.complete(err)

    # -- send path (pml_ob1_isend.c:233) --------------------------------
    @hot_path
    def isend(self, comm, buf, dest: int, tag: int,
              sync: bool = False) -> Request:
        """``sync=True`` gives MPI_Ssend semantics: completion only after
        the receiver has matched — implemented by forcing the rendezvous
        protocol, whose sender completion requires the receiver's ACK
        (``pml_ob1_sendreq.h:380`` RNDV; an eager send completes locally
        and cannot observe the match)."""
        spc.record("isend")
        req = SendRequest(self, comm, buf, dest, tag)
        _t0 = trace.now() if trace.enabled else 0
        dst_world = _peers(comm).world_rank(dest)
        src_world = comm.world_rank(comm.rank)
        ep = self.bml.endpoint(dst_world)
        if ep is None:
            raise MpiError(ErrorClass.ERR_INTERN,
                           f"no transport reaches world rank {dst_world}")
        # activate fires only once the request is real (endpoint resolved)
        # so activate/complete pairs always balance
        if peruse.active():
            peruse.fire(peruse.REQ_ACTIVATE, comm.cid, kind="send",
                        dest=dest, tag=tag)
        seq = next(self._seq.setdefault(
            (comm.cid, src_world, dst_world), itertools.count()))
        if trace.enabled:
            # the span closes at request completion, whichever rung
            # completes it; with the flow layer armed it carries the
            # message's flow key (the match header's cid, src, dst, seq)
            # and starts the flow arrow at its own end
            fkey = ((comm.cid, src_world, dst_world, seq)
                    if trace.flow_enabled else None)

            def _send_span(r, _t0=_t0, fkey=fkey):
                t1 = trace.now()
                eargs = {"nbytes": r.nbytes, "dest": r.dest,
                         "tag": r.tag, "cid": r.comm.cid}
                if fkey is not None:
                    eargs["fid"] = fkey
                trace.span("send", "pml", _t0, t1, args=eargs)
                if fkey is not None:
                    trace.flow_start("pml_msg", fkey, t1)

            req.on_complete(_send_span)
        spc.record("bytes_sent", req.nbytes)
        if req.nbytes <= ep.btl.eager_limit and not sync:
            # eager: single MATCH fragment, complete immediately.  The
            # payload is a borrowed view when the layout allows it — the
            # btl's wire/ring write is the only copy (send-in-place)
            _pt = profile.now() if profile.enabled else 0
            data, borrowed = req.convertor.pack_borrow()
            if profile.enabled:
                profile.stage_span("send.pack", _pt)
            frag = Frag(comm.cid, src_world, dst_world, tag, seq, MATCH,
                        data, total_len=req.nbytes, borrowed=borrowed,
                        qcodec=quant_mod.wire_codec_for(
                            req.convertor, req.nbytes)
                        if quant_mod.wire_enabled else None)
            ep.btl.send(ep, frag)
            req.complete()
            if peruse.active():
                peruse.fire(peruse.REQ_COMPLETE, comm.cid, kind="send",
                            dest=dest, tag=tag)
            return req
        # past the eager limit only: an eager send does no RGET work
        rget_limit = self.component.rget_limit()
        if (rget_limit and not sync and req.nbytes > rget_limit
                and (ep.btl.rdma or self.component.rget_emulate())):
            # RGET (pml_ob1_sendreq.h:375-401): expose the packed stream
            # and let the RECEIVER pull it, one one-sided copy into the
            # destination on an rdma btl; elsewhere (rget_emulate) the
            # receiver asks for the FRAG stream instead.  The user buffer
            # stays MPI-owned until the pull completes: memchecker freezes
            # a numpy one so a racy write fails loudly
            memchecker.protect_send(req, buf)
            try:
                self._send_reqs[req.req_id] = req
                spc.record("rget_msgs")
                meta = {"req_id": req.req_id}
                if ep.btl.rdma:
                    data, _borrowed = req.convertor.pack_borrow()
                    req._rget_key = ep.btl.prepare_src(ep, data)
                    req._rget_btl = ep.btl
                    meta["key"] = req._rget_key
                else:
                    meta["pull"] = True
                ep.btl.send(ep, Frag(comm.cid, src_world, dst_world, tag,
                                     seq, RGET, total_len=req.nbytes,
                                     meta=meta))
            except Exception:
                self._send_reqs.pop(req.req_id, None)
                key = getattr(req, "_rget_key", None)
                if key is not None:
                    ep.btl.release_src(key)
                req.complete(MpiError(ErrorClass.ERR_OTHER,
                                      "rget setup failed"))
                raise
            return req
        # rendezvous: RNDV head now, stream on ACK.  The user buffer stays
        # MPI-owned until completion (memchecker.h:25-52 analog)
        memchecker.protect_send(req, buf)
        try:
            _pt = profile.now() if profile.enabled else 0
            head, borrowed = req.convertor.pack_borrow(
                ep.btl.rndv_eager_limit)
            if profile.enabled:
                profile.stage_span("send.pack", _pt)
            self._send_reqs[req.req_id] = req
            frag = Frag(comm.cid, src_world, dst_world, tag, seq, RNDV,
                        head, total_len=req.nbytes,
                        meta={"req_id": req.req_id}, borrowed=borrowed,
                        qcodec=quant_mod.wire_codec_for(
                            req.convertor, req.nbytes)
                        if quant_mod.wire_enabled else None)
            ep.btl.send(ep, frag)
        except Exception:
            # failed setup: the request will never complete, so the guard's
            # release callback must fire here or the user's buffer stays
            # read-only forever
            self._send_reqs.pop(req.req_id, None)
            req.complete(MpiError(ErrorClass.ERR_OTHER,
                                  "rendezvous setup failed"))
            if peruse.active():
                peruse.fire(peruse.REQ_COMPLETE, comm.cid, kind="send",
                            dest=dest, tag=tag)
            raise
        return req

    def send(self, comm, buf, dest: int, tag: int) -> None:
        spc.record("send")
        self.isend(comm, buf, dest, tag).wait()

    def _stream_rest(self, req: SendRequest, ack: Frag) -> None:
        """Receiver matched our RNDV: push the remaining FRAGs (RPUT
        analog).  On the contiguous path ``pack_borrow`` is an O(1) slice,
        so the btl reads the user buffer itself.

        Multi-rail: FRAG frames are offset-addressed and reassembled by
        req-id at the receiver, so a stream of ``stripe_min`` or more
        stripes across EVERY endpoint that reaches the peer, weighted by
        btl bandwidth (``bml_r2.c``'s bandwidth-proportional scheduling).
        The RNDV head stays on the lowest-latency rail."""
        dst_world, peer_req = ack.src, ack.meta["peer_req"]
        rails = self._stripe_rails(dst_world, req.nbytes)
        conv = req.convertor
        # coll/quant wire stamp, once per stream: the btl's codec stage
        # sees only opaque packed bytes
        qc = quant_mod.wire_codec_for(conv, req.nbytes) \
            if quant_mod.wire_enabled else None
        assigned = [0] * len(rails)
        while not conv.finished:
            # finish-time greedy: the frag goes to the rail that would
            # complete its assigned bytes soonest (one rail: always it)
            j = 0 if len(rails) == 1 else min(
                range(len(rails)),
                key=lambda k: (assigned[k] + rails[k].btl.max_send_size)
                / max(1, rails[k].btl.bandwidth))
            ep = rails[j]
            off = conv.position
            _pt = profile.now() if profile.enabled else 0
            data, borrowed = conv.pack_borrow(ep.btl.max_send_size)
            if profile.enabled:
                profile.stage_span("send.pack", _pt)
            assigned[j] += len(data)
            ep.btl.send(ep, Frag(ack.cid, ack.dst, dst_world,
                                 -1, 0, FRAG, data, total_len=req.nbytes,
                                 offset=off, meta={"req_id": peer_req},
                                 borrowed=borrowed, qcodec=qc))
        self._send_reqs.pop(req.req_id, None)
        req.complete()
        if peruse.active():
            peruse.fire(peruse.REQ_COMPLETE, ack.cid, kind="send",
                        dest=req.dest, tag=req.tag)

    def _stripe_rails(self, dst_world: int, nbytes: int) -> list:
        """Endpoints eligible to carry one large transfer's FRAG stream."""
        eps = self.bml.endpoints(dst_world)
        if (len(eps) < 2 or not self.component.stripe_enabled()
                or nbytes < self.component.stripe_min()):
            return eps[:1] or [self.bml.endpoint(dst_world)]
        spc.record("striped_msgs")
        return list(eps)

    # -- recv path -------------------------------------------------------
    def irecv(self, comm, buf, source: int, tag: int) -> Request:
        spc.record("irecv")
        req = RecvRequest(self, comm, buf, source, tag)
        if trace.enabled:
            _t0 = trace.now()

            def _recv_span(r, _t0=_t0):
                t1 = trace.now()
                eargs = {"nbytes": r.received, "source": r.status.source,
                         "tag": r.tag, "cid": r.comm.cid}
                fl = r._flow
                if fl is not None and trace.flow_enabled:
                    # the sender's stamp rode the match header; closing
                    # the same key here draws the send -> recv arrow
                    eargs["fid"] = fl
                trace.span("recv", "pml", _t0, t1, args=eargs)
                if fl is not None and trace.flow_enabled:
                    trace.flow_finish("pml_msg", fl, t1)

            req.on_complete(_recv_span)
        dst_world = comm.world_rank(comm.rank)
        key = (comm.cid, dst_world)
        if peruse.active():
            peruse.fire(peruse.REQ_ACTIVATE, comm.cid, kind="recv",
                        source=source, tag=tag)
        # PERUSE events observed under self._lock are deferred and fired
        # after release so a callback can never deadlock against the pml
        events: list = []
        with self._lock:
            st = self._match.setdefault(key, _MatchState())
            # check the unexpected queue first (arrival order)
            for i, frag in enumerate(st.unexpected):
                comm_src = _peers(comm).rank_of(frag.src)
                if req.matches(frag, comm_src):
                    st.unexpected.pop(i)
                    if peruse.active():
                        events.append((peruse.REQ_MATCH_UNEX, comm.cid,
                                       dict(source=comm_src, tag=frag.tag,
                                            unex_qlen=len(st.unexpected))))
                    self._deliver_to_request(req, frag, events)
                    break
            else:
                st.posted.append(req)
                if peruse.active():
                    events.append((peruse.REQ_INSERT_IN_POSTED_Q, comm.cid,
                                   dict(source=source, tag=tag,
                                        posted_qlen=len(st.posted))))
        for ev, cid, info in events:
            peruse.fire(ev, cid, **info)
        return req

    def recv(self, comm, buf, source: int, tag: int) -> Status:
        spc.record("recv")
        return self.irecv(comm, buf, source, tag).wait()

    def _find_unexpected(self, comm, probe_req, take: bool):
        """(frag, status) of the first unexpected frag matching
        ``probe_req`` on comm's receiving rank, popped when ``take``; or
        None."""
        key = (comm.cid, comm.world_rank(comm.rank))
        with self._lock:
            st = self._match.setdefault(key, _MatchState())
            for i, frag in enumerate(st.unexpected):
                comm_src = _peers(comm).rank_of(frag.src)
                if probe_req.matches(frag, comm_src):
                    if take:
                        st.unexpected.pop(i)
                    return frag, Status(
                        source=comm_src, tag=frag.tag,
                        _nbytes=frag.total_len or len(frag.data))
        return None

    def _probe_liveness(self, comm, source: int, spins: int) -> None:
        """Keep a blocking probe out of the one FT hole request completion
        cannot cover: a probe is never a posted request, so
        ``_peer_failed`` cannot complete it in error.  ULFM probe
        semantics: a named failed source raises ERR_PROC_FAILED, a revoked
        comm ERR_REVOKED; ANY_SOURCE is left pending."""
        if spins % 2048:
            return
        if comm.is_revoked():
            from ompi_tpu_torch.api.errors import RevokedError

            raise RevokedError(f"{comm.name} revoked during a "
                               "blocking probe")
        if source == ANY_SOURCE:
            return
        from ompi_tpu_torch.ft import state as ft_state

        src_world = _peers(comm).world_rank(source)
        if ft_state.is_failed(src_world):
            from ompi_tpu_torch.api.errors import ProcFailedError

            raise ProcFailedError(
                f"peer world rank {src_world} failed during a "
                "blocking probe", (src_world,))

    def probe(self, comm, source: int, tag: int, blocking: bool):
        spc.record("probe" if blocking else "iprobe")
        from ompi_tpu_torch.runtime.progress import progress

        probe_req = RecvRequest(self, comm, np.empty(0, np.uint8), source, tag)
        spins = 0
        while True:
            hit = self._find_unexpected(comm, probe_req, take=False)
            if hit is not None:
                return hit[1] if blocking else (True, hit[1])
            progress()
            if not blocking:
                hit = self._find_unexpected(comm, probe_req, take=False)
                return (True, hit[1]) if hit is not None else (False, None)
            spins += 1
            self._probe_liveness(comm, source, spins)

    def mprobe(self, comm, source: int, tag: int, blocking: bool):
        from ompi_tpu_torch.runtime.progress import progress

        probe_req = RecvRequest(self, comm, np.empty(0, np.uint8), source, tag)
        spins = 0
        while True:
            hit = self._find_unexpected(comm, probe_req, take=True)
            if hit is not None:
                msg = Message(self, comm, *hit)
                return msg if blocking else (True, msg)
            if not blocking:
                return False, None
            progress()
            spins += 1
            self._probe_liveness(comm, source, spins)

    def _cancel_recv(self, req: RecvRequest) -> bool:
        with self._lock:
            for st in self._match.values():
                if req in st.posted:
                    st.posted.remove(req)
                    return True
        return False

    # -- fragment delivery (pml_ob1_recvfrag.c:450) ----------------------
    @hot_path
    def _recv_frag(self, frag: Frag) -> None:
        if frag.kind == ACK:
            req = self._send_reqs.get(frag.meta["req_id"])
            if req is not None:
                self._stream_rest(req, frag)
            return
        if frag.kind == FRAG:
            self._recv_data_frag(frag)
            return
        if frag.kind == CTL:
            handler = _ctl_handlers.get(frag.meta.get("proto"))
            if handler is not None:
                frag.own_data()   # handlers may stash the payload
                handler(frag)
            return
        key = (frag.cid, frag.dst)
        events: list = []
        try:
            self._recv_frag_locked(key, frag, events)
        finally:
            for ev, cid, info in events:
                peruse.fire(ev, cid, **info)

    def _recv_frag_locked(self, key, frag: Frag, events: list) -> None:
        with self._lock:
            st = self._match.setdefault(key, _MatchState())
            expected = st.expected_seq.get(frag.src, 0)
            if frag.seq != expected:
                # out-of-order arrival: hold by seq (recvfrag.c:106-147);
                # held data must outlive the sender's btl.send call
                frag.own_data()
                spc.record("out_of_sequence_msgs")
                st.ooo.setdefault(frag.src, {})[frag.seq] = frag
                return
            self._match_one(st, frag, events)
            st.expected_seq[frag.src] = expected + 1
            # drain any now-in-order held frags
            held = st.ooo.get(frag.src, {})
            nxt = st.expected_seq[frag.src]
            while nxt in held:
                self._match_one(st, held.pop(nxt), events)
                nxt += 1
                st.expected_seq[frag.src] = nxt

    def _match_one(self, st: _MatchState, frag: Frag, events: list) -> None:
        """Match one in-sequence frag against posted recvs (recvfrag.c:831);
        runs under self._lock, PERUSE events append to ``events`` for the
        caller to fire after release."""
        if peruse.active():
            events.append((peruse.MSG_ARRIVED, frag.cid,
                           dict(source=frag.src, tag=frag.tag)))
        for i, req in enumerate(st.posted):
            comm_src = _peers(req.comm).rank_of(frag.src)
            if req.matches(frag, comm_src):
                st.posted.pop(i)
                spc.record("matched_msgs")
                if peruse.active():
                    events.append((peruse.MSG_MATCH_POSTED_REQ, frag.cid,
                                   dict(source=frag.src, tag=frag.tag,
                                        posted_qlen=len(st.posted))))
                self._deliver_to_request(req, frag, events)
                return
        spc.record("unexpected_msgs")
        frag.own_data()   # queued past the sender's btl.send call
        st.unexpected.append(frag)
        if peruse.active():
            events.append((peruse.MSG_INSERT_IN_UNEX_Q, frag.cid,
                           dict(source=frag.src, tag=frag.tag,
                                unex_qlen=len(st.unexpected))))

    def _deliver_to_request(self, req: RecvRequest, frag: Frag,
                            events: list = None) -> None:
        fire_now = events is None
        if events is None:
            events = []
        _pt = profile.now() if profile.enabled else 0
        comm_src = _peers(req.comm).rank_of(frag.src)
        req.matched_src = frag.src
        if trace.flow_enabled:
            # the flow key off the match header (MATCH/RNDV/RGET all carry
            # the pml sequence); the recv span closes it
            req._flow = (frag.cid, frag.src, frag.dst, frag.seq)
        req.total = frag.total_len or len(frag.data)
        req.status.source = comm_src
        req.status.tag = frag.tag
        error = None
        if req.total > req.capacity:
            error = MpiError(ErrorClass.ERR_TRUNCATE,
                             f"message of {req.total} bytes into "
                             f"{req.capacity}-byte buffer")
            req.total = req.capacity  # deliver what fits, like the reference
        if frag.kind == RGET:
            self._deliver_rget(req, frag, error, events)
            if fire_now:
                for ev, cid, info in events:
                    peruse.fire(ev, cid, **info)
            return
        n = req.convertor.unpack(frag.data[:max(0, req.capacity)])
        req.received += n
        req.status._nbytes = min(req.total, req.received) if error else req.total
        spc.record("bytes_received", n)
        if profile.enabled:
            profile.stage_span("recv.deliver", _pt)
        done = False
        if frag.kind == RNDV and error is None:
            # register for FRAG continuation and ACK the sender
            self._recv_reqs[req.req_id] = req
            ep = self.bml.endpoint(frag.src)
            ep.btl.send(ep, Frag(frag.cid, frag.dst, frag.src, -1, 0, ACK,
                                 meta={"req_id": frag.meta["req_id"],
                                       "peer_req": req.req_id}))
            if req.received >= req.total:
                self._recv_reqs.pop(req.req_id, None)
                req.status._nbytes = req.received
                done = True
        elif error is not None or req.received >= req.total:
            req.status._nbytes = req.received
            done = True
        if done:
            if peruse.active():
                events.append((peruse.REQ_XFER_END, frag.cid,
                               dict(source=frag.src, tag=req.status.tag,
                                    nbytes=req.received)))
                events.append((peruse.REQ_COMPLETE, frag.cid,
                               dict(kind="recv", source=req.status.source,
                                    tag=req.status.tag)))
            _pt = profile.now() if profile.enabled else 0
            req.complete(error)
            if profile.enabled:
                profile.stage_span("recv.complete", _pt)
        if fire_now:
            for ev, cid, info in events:
                peruse.fire(ev, cid, **info)

    def _deliver_rget(self, req: RecvRequest, frag: Frag, error,
                      events: list) -> None:
        """Receiver side of the RGET rung (pml_ob1_recvreq.c's RGET
        scheduling): pull the exposed region one-sidedly (rdma btl) or ask
        for a sender-driven stream (the pull emulation)."""
        ep = self.bml.endpoint(frag.src)
        if ep is None:
            # the sender's endpoint is gone: complete in error rather than
            # raise out of the progress engine
            self._rget_fail(req, frag, events)
            return
        done = Frag(frag.cid, frag.dst, frag.src, -1, 0, CTL,
                    meta={"proto": "ob1_rget_done", "reliable": True,
                          "req_id": frag.meta["req_id"]})
        key = frag.meta.get("key")
        if error is not None and key is None:
            # truncation on the pull path: tell the sender we are done (it
            # has nothing exposed to release) and fail locally
            ep.btl.send(ep, done)
            req.status._nbytes = 0
            if peruse.active():
                events.append((peruse.REQ_COMPLETE, frag.cid,
                               dict(kind="recv", source=req.status.source,
                                    tag=req.status.tag)))
            req.complete(error)
            return
        if key is not None:
            want = req.total
            view = req.convertor.unpack_view(want)
            try:
                if view is not None:
                    # one-sided landing: peer bytes -> user buffer direct
                    ep.btl.get(ep, view, key)
                else:
                    tmp = np.empty(max(0, want), np.uint8)
                    ep.btl.get(ep, tmp, key)
            except Exception:
                # the exposed segment is gone or the btl has no get: fail
                # the recv and tell a still-alive sender, so its request
                # completes and releases the exposure.  Only the get is
                # guarded: a local convertor fault is no peer failure
                try:
                    ep.btl.send(ep, done)
                except Exception:
                    pass
                self._rget_fail(req, frag, events)
                return
            if view is not None:
                req.convertor.advance(len(view))
                n = len(view)
            else:
                n = req.convertor.unpack(tmp)
            req.received = n
            req.status._nbytes = n
            spc.record("bytes_received", n)
            ep.btl.send(ep, done)
            if peruse.active():
                events.append((peruse.REQ_XFER_END, frag.cid,
                               dict(source=frag.src, tag=req.status.tag,
                                    nbytes=n)))
                events.append((peruse.REQ_COMPLETE, frag.cid,
                               dict(kind="recv", source=req.status.source,
                                    tag=req.status.tag)))
            req.complete(error)
            return
        # pull emulation: the sender streams FRAGs through the normal
        # continuation machinery (completion in _recv_data_frag)
        self._recv_reqs[req.req_id] = req
        ep.btl.send(ep, Frag(frag.cid, frag.dst, frag.src, -1, 0, CTL,
                             meta={"proto": "ob1_rget_pull", "reliable": True,
                                   "req_id": frag.meta["req_id"],
                                   "peer_req": req.req_id}))

    def _rget_fail(self, req: RecvRequest, frag: Frag,
                   events: list) -> None:
        """Complete an RGET recv in error (the sender is gone or the pull
        failed), keeping the PERUSE activate/complete pairing balanced."""
        from ompi_tpu_torch.api.errors import ProcFailedError

        req.status._nbytes = 0
        if peruse.active():
            events.append((peruse.REQ_COMPLETE, frag.cid,
                           dict(kind="recv", source=req.status.source,
                                tag=req.status.tag)))
        req.complete(ProcFailedError(
            f"RGET sender world rank {frag.src} unreachable", (frag.src,)))

    def _on_rget_done(self, frag: Frag) -> None:
        """Sender side: the receiver finished its pull: release and
        complete."""
        req = self._send_reqs.pop(frag.meta["req_id"], None)
        if req is None:
            return
        _release_rget(req)
        req.complete()
        if peruse.active():
            peruse.fire(peruse.REQ_COMPLETE, frag.cid, kind="send",
                        dest=req.dest, tag=req.tag)

    def _on_rget_pull(self, frag: Frag) -> None:
        """Sender side of the pull emulation: stream the payload."""
        req = self._send_reqs.get(frag.meta["req_id"])
        if req is not None:
            self._stream_rest(req, frag)

    @hot_path
    def _recv_data_frag(self, frag: Frag) -> None:
        req = self._recv_reqs.get(frag.meta["req_id"])
        if req is None:
            return
        _pt = profile.now() if profile.enabled else 0
        req.convertor.set_position(min(frag.offset, req.capacity))
        n = req.convertor.unpack(frag.data)
        req.received += n
        spc.record("bytes_received", n)
        if profile.enabled:
            profile.stage_span("recv.deliver", _pt)
        if req.received >= min(req.total, req.capacity):
            self._recv_reqs.pop(frag.meta["req_id"], None)
            req.status._nbytes = req.received
            if peruse.active():
                peruse.fire(peruse.REQ_XFER_END, frag.cid,
                            source=req.status.source, tag=req.status.tag,
                            nbytes=req.received)
                peruse.fire(peruse.REQ_COMPLETE, frag.cid, kind="recv",
                            source=req.status.source, tag=req.status.tag)
            _pt = profile.now() if profile.enabled else 0
            req.complete()
            if profile.enabled:
                profile.stage_span("recv.complete", _pt)


def _release_rget(req) -> None:
    """Release an RGET exposure if this send request holds one."""
    key = getattr(req, "_rget_key", None)
    btl = getattr(req, "_rget_btl", None)
    if key is not None and btl is not None:
        try:
            btl.release_src(key)
        except Exception:
            pass
        req._rget_key = None


# control-message protocol handlers (osc / ft register here)
_ctl_handlers: dict[str, callable] = {}


def register_ctl_handler(proto: str, handler) -> None:
    _ctl_handlers[proto] = handler


class Ob1Component(Component):
    name = "ob1"
    priority = 20

    def register_vars(self, fw) -> None:
        self.register_var("priority", vtype=VarType.INT, default=20,
                          help="Selection priority of pml/ob1")
        self._rget_var = self.register_var(
            "rget_limit", vtype=VarType.SIZE, default="512k",
            help="Messages above this (and above the btl eager limit) use "
                 "the receiver-pull RGET protocol "
                 "(pml_ob1_sendreq.h:375-401) on rdma-capable btls; 0 "
                 "disables RGET")
        self._rget_emu_var = self.register_var(
            "rget_emulate", vtype=VarType.BOOL, default=False,
            help="Allow RGET's request/stream pull emulation on btls "
                 "without one-sided get (btl/tcp): an extra round trip "
                 "and no zero-copy win, so off by default; the crossover "
                 "is the btl rdma flag")
        self._stripe_var = self.register_var(
            "stripe", vtype=VarType.BOOL, default=True,
            help="Stripe large RNDV/pull streams across every btl that "
                 "reaches the peer, bandwidth-weighted (bml/r2 multi-rail)")
        self._stripe_min_var = self.register_var(
            "stripe_min", vtype=VarType.SIZE, default="2m",
            help="Smallest message that stripes across rails")

    def rget_limit(self) -> int:
        var = getattr(self, "_rget_var", None)
        return int(var.value) if var is not None else 512 << 10

    def rget_emulate(self) -> bool:
        var = getattr(self, "_rget_emu_var", None)
        return bool(var.value) if var is not None else False

    def stripe_enabled(self) -> bool:
        var = getattr(self, "_stripe_var", None)
        return bool(var.value) if var is not None else True

    def stripe_min(self) -> int:
        var = getattr(self, "_stripe_min_var", None)
        return int(var.value) if var is not None else 2 << 20

    def get_module(self, rte) -> Ob1Pml:
        self._module = Ob1Pml(self, rte)
        return self._module


COMPONENT = Ob1Component()
