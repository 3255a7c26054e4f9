"""btl/tcp — socket transport between machines (and between fake nodes).

Copy of ``ompi_tpu/mca/btl/tcp.py`` (after the reference's
``opal/mca/btl/tcp/``): a listening socket per process whose address is
published through the modex (``btl_tcp_addr``), lazy connects on first send
with a rank handshake, ``links`` connections a peer with frames striped
round-robin, length-prefixed fragments, and nonblocking IO drained from the
central progress engine.  Eager/rendezvous thresholds are MCA vars like the
reference's ``btl_tcp_eager_limit`` family (``btl.h:1162-1165``): 64 KB
eager, 128 KB fragments.

Wire format (one byte of header-type negotiation per fragment, so fast and
pickle headers coexist on one connection)::

    frame    := [u32 frame_len][u8 htype][crc?][quant?][header][payload]
    htype 0  := [u32 hlen][pickle header]          (exotic meta, handshake)
    htype 1  := [_FAST struct: cid,src,dst,tag,seq,kind,total,off,req_id]
    | 2      := a crc32 of everything after it follows the htype byte
    | 4      := the payload is coll/quant-encoded; a [u8 codec][u32 raw_len]
                [u16 block] sub-header follows the crc

The fast header covers eager MATCH (empty meta) and the RNDV continuation
FRAG (``{"req_id": int}``); anything else falls back to pickle.  The crc
variants are armed on the send side under chaos (``otpu_chaos_spec``) or
``OTPU_SANITIZE``; the receiver verifies whatever arrives checksummed.  The
quant variant is stamped per fragment by pml/ob1 (``Frag.qcodec``, only it
still knows the bytes are float32) when ``otpu_coll_quant_wire`` is set, and
the receive parse decodes back to the ORIGINAL bytes.

Send path: the out-queue is a deque of memoryviews drained by
``socket.sendmsg`` scatter-gather; a borrowed payload (``Frag.borrowed``)
that the first ``sendmsg`` cannot hand to the kernel is copied once, so the
queue never aliases user memory.  Backpressured connections register for
writability and are drained by progress.  Receive path: either the pure
``selectors`` lane (``_on_bytes`` parses complete frames zero-copy out of
the recv scratch, ``_drain`` reassembles split frames) or, when the native
reactor is engaged, its records (FAST frames arrive pre-parsed, every other
frame RAW into the same ``_parse_frame``).

Observability (``tcp.py:233-235``, ``:492-773``, ``:956-998``,
``:1104-1118``): the frame build and enqueue is the ``send.queue`` stage,
each ``sendmsg`` a ``btl_sendmsg`` span of category ``btl`` with its log2
histogram and the ``send.wire`` stage, and every frame parse the
``recv.parse`` stage on both receive lanes (the selector's scratch and
reassembly parses, the reactor's FAST and RAW records); a wire fault is a
trace instant under its counter's name.  While set up the btl publishes
its out-queue depth as the ``tcp`` telemetry source
(:meth:`TcpBtl._telemetry_stats`); ``close`` withdraws it.

The FT side (``tcp.py:336-391``, ``:415-459``, ``:574-590``, ``:816``,
``:891``): a connection that dies mid-traffic (reset, unexpected EOF, a
hard write error) records its peer as a suspect under ``_conns_lock``;
``_drain_suspects`` hands the suspects to ``ft/propagator.wire_suspicion``
with no lock held, after every send and at the top of every progress
call, so both receive lanes (the selector and the native reactor) drain
them.  FT control frames (``proto`` ``ft_*``) are best-effort: a failed
connect puts the peer in a 10 s backoff that only they honour, and a frame
flagged ``est_only`` (the detector's tombstone flood) rides an established
connection or none.  A wire-integrity trip posts an ``abort`` event, so
the launcher tears the job down with the diagnostic on record.

Chaos (``tcp.py:421-565``, ``:709-715``, ``:761-765``, ``:937-946``): each
send consults ``chaos.wire_send`` (drop and dup on best-effort CTL frames
only, ``btl.base.loss_ok``; delay; a connection reset; corruption flipped
into a header byte AFTER the crc is computed), and each received frame
``chaos.wire_recv`` on every lane where frames reach Python: the selector's
scratch parse, the reactor's FAST records (delay only: a crc-armed frame
never takes the FAST lane) and its RAW records (delay and corruption before
the crc check).  Every hook sits behind ``if chaos.enabled``.  btl/tcp has
no one-sided triple (``rdma`` False): ob1's RGET rung reaches it only as
the receiver-requested FRAG stream of ``pml_ob1_rget_emulate``.
"""
from __future__ import annotations

import pickle
import selectors
import socket
import struct
import threading
import time
import zlib
from collections import deque
from functools import partial
from typing import Optional

import numpy as np

from ompi_tpu_torch.base.output import register_help, show_help
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.ft import chaos
from ompi_tpu_torch.mca.btl.base import ACK, CTL, FRAG, MATCH, RGET, \
    RNDV, Btl, Endpoint, Frag, loss_ok
from ompi_tpu_torch.mca.coll import quant as quant_mod
from ompi_tpu_torch.runtime import profile, reactor as reactor_mod, \
    sanitizer, spc, trace
from ompi_tpu_torch.runtime.hotpath import hot_path

# reactor record types, bound to locals for the dispatch hot path
_R_RAW = reactor_mod.REC_RAW
_R_FAST = reactor_mod.REC_FAST
_R_EOF = reactor_mod.REC_EOF
_R_ACCEPT = reactor_mod.REC_ACCEPT
_R_WRITABLE = reactor_mod.REC_WRITABLE
_R_OVERSIZE = reactor_mod.REC_OVERSIZE
_R_DESYNC = reactor_mod.REC_DESYNC

_LEN = struct.Struct("!I")
_MAX_FRAME = (1 << 32) - 1          # the !I length prefix's ceiling

# header-type byte (per-fragment negotiation; the bits compose)
_H_PICKLE = 0
_H_FAST = 1
# checksummed variants (htype | _H_CK_BASE): the frame carries a crc32 of
# everything after the crc field
_H_CK_BASE = 2
_CKSUM = struct.Struct("!I")
# quantized variants (htype | _H_QUANT): the payload travels through the
# coll/quant block-scale codec, with a [u8 codec][u32 raw_len][u16 block]
# sub-header between the crc (which covers it) and the message header
_H_QUANT = 4
_QHDR = struct.Struct("!BIH")


def _cksum_armed() -> bool:
    """Frame checksumming is opt-in: chaos (corruption is being
    *injected*) or the sanitizer hard-assertion mode arms it; the default
    fast path never pays the crc."""
    return chaos.enabled or sanitizer.enabled


# fast header: cid, src, dst (u32), tag (i32), seq (i64), kind (u8),
# total_len, offset, req_id (i64; req_id -1 = no meta)
_FAST = struct.Struct("!IIIiqBqqq")
_KIND_TO_CODE = {MATCH: 0, RNDV: 1, ACK: 2, FRAG: 3, RGET: 4, CTL: 5}
_CODE_TO_KIND = {v: k for k, v in _KIND_TO_CODE.items()}

#: sendmsg scatter-gather width per syscall (Linux IOV_MAX is 1024; 64
#: buffers ~ 16 frames per call, plenty to amortize the syscall)
_IOV_BATCH = 64


def _fast_header(frag: Frag) -> Optional[bytes]:
    """The fixed struct header when ``frag`` fits it, else None.

    Eligible: empty meta or exactly ``{"req_id": int}`` (the FRAG
    continuation case), known kind, and every field within the struct's
    integer ranges — anything else takes the pickle fallback."""
    meta = frag.meta
    if meta:
        if len(meta) != 1 or "req_id" not in meta:
            return None
        req_id = meta["req_id"]
        if not isinstance(req_id, int) or not 0 <= req_id < (1 << 63):
            return None
    else:
        req_id = -1
    code = _KIND_TO_CODE.get(frag.kind)
    if code is None:
        return None
    try:
        return _FAST.pack(frag.cid, frag.src, frag.dst, frag.tag,
                          frag.seq, code, frag.total_len, frag.offset,
                          req_id)
    except (struct.error, TypeError):
        return None   # out-of-range field (huge tag, negative rank...)


class _Conn:
    #: per-recv scratch size (recv_into target; frames parse straight out
    #: of it, so bigger = more frames per syscall)
    SCRATCH = 1 << 18

    def __init__(self, sock: socket.socket, rank: Optional[int] = None):
        self.sock = sock
        self.rank = rank
        # fd registered with the native reactor (None on the selector
        # lane); cleared on EOF teardown
        self.fd: Optional[int] = None
        # holds only the partial TAIL frame split across recv calls;
        # complete frames are parsed zero-copy from the recv scratch
        self.inbuf = bytearray()
        self.scratch = bytearray(self.SCRATCH)
        # out-queue: memoryviews handed to sendmsg in order; it and
        # out_bytes mutate only under send_lock
        self.outq: deque = deque()
        self.out_bytes = 0
        # whether this conn is registered for writability (set while outq
        # is non-empty, under send_lock)
        self.want_write = False
        # serialises outq append+flush: app threads and the progress
        # engine send on the same conn, and two concurrent sendmsg calls
        # over one queue would interleave frames
        self.send_lock = threading.Lock()


def _conn_peer(conn: "Optional[_Conn]") -> int:
    """Attributed rank of a connection (-1: before the handshake)."""
    return conn.rank if conn is not None and conn.rank is not None else -1


class TcpBtl(Btl):
    name = "tcp"
    priority = 10
    eager_limit = 64 * 1024
    rndv_eager_limit = 64 * 1024
    max_send_size = 128 * 1024
    latency = 100
    bandwidth = 100

    def __init__(self) -> None:
        super().__init__()
        self._rte = None
        self._listener: Optional[socket.socket] = None
        self._sel = selectors.DefaultSelector()
        # native-reactor lane: when True the epoll loop in the native core
        # owns every socket and records arrive through reactor_mod.drain()
        # -> _reactor_event.  _rconns mirrors its fd registrations.
        self._reactor = False
        self._rconns: dict[int, _Conn] = {}
        # several connections a peer (links), frames round-robined across
        # them; _by_rank mutates only under _conns_lock (reads are
        # lock-free snapshots)
        self._by_rank: dict[int, list[_Conn]] = {}
        self._conns_lock = threading.Lock()
        self._rr: dict[int, int] = {}
        self._links = 1
        self._addr_cache: dict[int, tuple] = {}
        self._locks_guard = threading.Lock()
        self._connect_locks: dict[int, threading.Lock] = {}  # per peer
        self._connect_backoff: dict[int, float] = {}   # rank -> retry-after
        # peers whose connection died mid-traffic, pending hand-off to the
        # FT detector as suspicions: filled under _conns_lock in
        # _drop_conn, drained lock-free by send and progress
        self._suspects: list[int] = []

    def register_vars(self, fw) -> None:
        self.register_var(
            "eager_limit", vtype=VarType.SIZE, default="64k",
            help="Max eager message size over tcp",
            on_set=lambda v: setattr(self, "eager_limit", v))
        self.register_var(
            "max_send_size", vtype=VarType.SIZE, default="128k",
            help="Max fragment size for rendezvous streaming over tcp",
            on_set=lambda v: setattr(self, "max_send_size", v))
        self.register_var(
            "links", vtype=VarType.INT, default=1,
            help="TCP connections per peer; frames stripe round-robin "
                 "across them (btl_tcp_links)",
            on_set=lambda v: setattr(self, "_links", max(1, int(v))))

    # -- lifecycle -------------------------------------------------------
    def setup(self, rte) -> bool:
        """Listen and publish our address (before the init fence)."""
        if rte.is_device_world:
            return False
        if not hasattr(rte, "modex_put"):
            return False
        if getattr(rte, "client", None) is None:
            return False   # no coordination service: nobody can dial in
        # a boot after a teardown in one process is another job: its peers'
        # addresses and the round-robin cursors start anew (close keeps
        # them, as the reference's does)
        self._addr_cache.clear()
        self._rr.clear()
        self._rte = rte
        self._listener = socket.create_server(("127.0.0.1", 0), backlog=64)
        self._listener.setblocking(False)
        # native-reactor lane: the listener is a NOTIFY (oneshot) fd of the
        # epoll thread; inbound connects surface as ACCEPT records
        self._reactor = reactor_mod.engage() and reactor_mod.add(
            self._listener.fileno(), reactor_mod.MODE_NOTIFY,
            self._on_accept_record)
        if not self._reactor:
            self._sel.register(self._listener, selectors.EVENT_READ,
                               "listener")
            # idle waiters block on the listener too: an inbound connect
            # (the peer's first message) must wake a sleeping receiver
            from ompi_tpu_torch.runtime import progress as progress_mod

            progress_mod.register_waiter(self._listener)
        rte.modex_put("btl_tcp_addr", self._listener.getsockname())
        # live out-queue depth for otpu_top (one dict insert here; the
        # provider runs only on the sampler thread, never on a hot path)
        from ompi_tpu_torch.runtime import telemetry

        telemetry.register_source("tcp", self._telemetry_stats)
        return True

    def _telemetry_stats(self) -> dict:
        """Sampler-thread source: aggregate out-queue depth/bytes and
        connection count.  Racy unlocked reads of per-conn counters:
        telemetry is an approximation, and the lock contract only covers
        mutation."""
        frags = qbytes = nconns = 0
        for conns in list(self._by_rank.values()):
            for conn in list(conns):
                nconns += 1
                frags += len(conn.outq)
                qbytes += conn.out_bytes
        return {"outq_frags": frags, "outq_bytes": qbytes,
                "conns": nconns}

    def _register_conn(self, conn: _Conn) -> None:
        """Register a fresh connection for receive progress: a reactor
        STREAM fd, or the selector + idle-waiter pair."""
        if self._reactor:
            fd = conn.sock.fileno()
            if reactor_mod.add(fd, reactor_mod.MODE_STREAM,
                               partial(self._reactor_event, conn)):
                conn.fd = fd
                self._rconns[fd] = conn
                return
        self._sel.register(conn.sock, selectors.EVENT_READ, conn)
        from ompi_tpu_torch.runtime import progress as progress_mod

        progress_mod.register_waiter(conn.sock)

    def reachable(self, world_rank: int, rte) -> Optional[Endpoint]:
        if self._rte is None or world_rank == rte.my_world_rank:
            return None
        # cache the peer's address NOW, while the modex is reachable
        if world_rank not in self._addr_cache:
            try:
                addr = rte.modex_get(world_rank, "btl_tcp_addr", wait=False)
                if addr is not None:
                    self._addr_cache[world_rank] = tuple(addr)
            except Exception:
                pass
        return Endpoint(self, world_rank)

    # -- send path -------------------------------------------------------
    def _connect(self, rank: int, best_effort: bool = False) -> _Conn:
        conns = self._by_rank.get(rank)
        if conns:
            return self._pick(rank, conns)
        with self._locks_guard:
            lock = self._connect_locks.setdefault(rank, threading.Lock())
        with lock:   # one connect round per PEER; peers connect in parallel
            conns = self._by_rank.get(rank)
            if conns:
                return self._pick(rank, conns)
            # a failed connect's backoff gates only BEST-EFFORT traffic (FT
            # heartbeats and floods): a dead host blackholes SYNs, and a
            # blocking retry a tick would stall the sender for the connect
            # timeout.  Application sends always attempt the connect
            until = self._connect_backoff.get(rank, 0.0)
            if best_effort and time.monotonic() < until:
                raise ConnectionError(
                    f"rank {rank} connect in backoff until {until:.1f}")
            addr = self._addr_cache.get(rank)
            if addr is None:
                addr = self._rte.modex_get(rank, "btl_tcp_addr")
                if addr is not None:
                    self._addr_cache[rank] = tuple(addr)
            if addr is None:
                raise ConnectionError(f"no tcp address for rank {rank}")
            conns = []
            for _link in range(self._links):
                sock = None
                try:
                    sock = socket.create_connection(tuple(addr), timeout=5)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    # handshake: tell the peer who we are (framed like any
                    # pickle-header fragment with an empty payload)
                    hello = pickle.dumps({"rank": self._rte.my_world_rank})
                    sock.sendall(_LEN.pack(1 + _LEN.size + len(hello))
                                 + bytes((_H_PICKLE,))
                                 + _LEN.pack(len(hello)) + hello)
                except OSError:
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                    if not conns:
                        self._connect_backoff[rank] = \
                            time.monotonic() + 10.0
                        raise
                    break   # some links up: run with what connected
                conn = _Conn(sock, rank)
                sock.setblocking(False)
                self._register_conn(conn)
                conns.append(conn)
            self._connect_backoff.pop(rank, None)
            # MERGE, never assign: the handshake path may have appended
            # accepted reply rails for this rank concurrently
            with self._conns_lock:
                merged = self._by_rank.setdefault(rank, [])
                merged.extend(conns)
            return self._pick(rank, merged)

    def _pick(self, rank: int, conns: list) -> _Conn:
        """Round-robin link selection (frames are self-contained; pml
        sequence numbers reorder across links at the receiver)."""
        i = self._rr.get(rank, 0)
        self._rr[rank] = i + 1
        try:
            return conns[i % len(conns)]
        except (ZeroDivisionError, IndexError):
            # the progress thread dropped the last link concurrently
            raise ConnectionError(f"no live tcp links to rank {rank}")

    @hot_path
    def send(self, ep: Endpoint, frag: Frag) -> None:
        chaos_rule = None
        if chaos.enabled:
            chaos_rule = chaos.wire_send("tcp", loss_ok(frag))
            if chaos_rule is not None:
                fault = chaos_rule["fault"]
                if fault == "drop":
                    return          # best-effort CTL frame lost
                if fault == "delay":
                    chaos.sleep_ms(chaos_rule)
                    chaos_rule = None
        nbytes = getattr(frag.data, "nbytes", None)
        if nbytes is None:
            nbytes = len(frag.data)
        if nbytes + (1 + _FAST.size + _LEN.size + _CKSUM.size) > _MAX_FRAME:
            # early check on the payload alone, before any connect; a
            # pickle header can outgrow the fast header, so the built
            # frame is re-checked below
            raise self._frame_too_large(nbytes)
        # FT control traffic is best-effort: it honours the connect backoff
        # and, when flagged, rides only an ALREADY-established connection
        # (a shutdown tombstone flood must not block connecting to a
        # possibly-dead peer)
        meta = frag.meta or {}
        if meta.get("est_only"):
            conns = self._by_rank.get(ep.world_rank)
            if not conns:
                raise ConnectionError(
                    f"no established connection to rank {ep.world_rank}")
            conn = self._pick(ep.world_rank, conns)
        else:
            conn = self._connect(
                ep.world_rank,
                best_effort=str(meta.get("proto", "")).startswith("ft_"))
        if chaos_rule is not None and chaos_rule["fault"] == "reset":
            # injected connection reset: shutdown (the receive lane sees
            # an EOF and runs the normal teardown, which also routes the
            # reset into the detector as a suspicion).  A best-effort CTL
            # frame is silently lost, exactly like a real reset;
            # application traffic fails loudly.
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._drop_conn(conn)
            self._drain_suspects()
            if frag.kind == CTL:
                return
            raise ConnectionError(
                f"chaos: injected connection reset to rank "
                f"{ep.world_rank}")
        # payload as a flat byte view
        payload = frag.data
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            payload = memoryview(payload)
        if isinstance(payload, memoryview) and (
                payload.ndim != 1 or payload.itemsize != 1):
            payload = payload.cast("B")
        # coll/quant codec stage, between the convertor's pack and the
        # out-queue: the payload becomes an OWNED encoded array, so the
        # borrowed-remainder machinery below never runs for it
        qhdr = b""
        borrowed = frag.borrowed
        qbit = 0
        if quant_mod.wire_enabled and frag.qcodec is not None:
            enc = quant_mod.encode_wire(payload, frag.qcodec)
            if enc is not None:
                qhdr = _QHDR.pack(quant_mod.codec_id(frag.qcodec),
                                  len(payload), quant_mod.block_elems())
                payload = memoryview(enc)
                borrowed = False
                qbit = _H_QUANT
        # stage clock: frame build + enqueue, the wire syscall excluded
        # (that is send.wire, recorded inside _flush_locked)
        _pt = profile.now() if profile.enabled else 0
        hdr = _fast_header(frag)
        if hdr is not None:
            spc.record("fastpath_hdr_fast")
            htype = _H_FAST | qbit
        else:
            spc.record("fastpath_hdr_pickle")
            hdr = pickle.dumps(
                (frag.cid, frag.src, frag.dst, frag.tag, frag.seq,
                 frag.kind, frag.total_len, frag.offset, frag.meta),
                protocol=pickle.HIGHEST_PROTOCOL)
            hdr = _LEN.pack(len(hdr)) + hdr
            htype = _H_PICKLE | qbit
        if _cksum_armed():
            # [len][htype|2][crc32][qhdr][hdr][payload], the crc over
            # everything after the crc field (the quant sub-header too)
            crc = zlib.crc32(payload, zlib.crc32(hdr, zlib.crc32(qhdr)))
            frame_len = 1 + _CKSUM.size + len(qhdr) + len(hdr) + len(payload)
            if frame_len > _MAX_FRAME:
                raise self._frame_too_large(frame_len)
            head = (_LEN.pack(frame_len) + bytes((htype | _H_CK_BASE,))
                    + _CKSUM.pack(crc) + qhdr + hdr)
        else:
            frame_len = 1 + len(qhdr) + len(hdr) + len(payload)
            # re-checked here: a pickle header can outgrow the fast
            # header the early check assumed, and the check must precede
            # _LEN.pack, which would die on a bare struct.error
            if frame_len > _MAX_FRAME:
                raise self._frame_too_large(frame_len)
            head = _LEN.pack(frame_len) + bytes((htype,)) + qhdr + hdr
        if chaos_rule is not None and chaos_rule["fault"] == "corrupt":
            # on-the-wire bit rot, injected AFTER the checksum was computed
            # (the armed receiver catches it loudly); flips a header byte
            # so the caller's payload memory stays pristine
            mangled = bytearray(head)
            mangled[-1] ^= 0x01
            head = bytes(mangled)
        with conn.send_lock:
            conn.outq.append(memoryview(head))
            conn.out_bytes += len(head)
            queued = 1
            if len(payload):
                conn.outq.append(payload if isinstance(payload, memoryview)
                                 else memoryview(payload))
                conn.out_bytes += len(payload)
                queued = 2
            if profile.enabled:
                profile.stage_span("send.queue", _pt)
            self._flush_locked(conn)
            if conn.outq and borrowed and queued == 2:
                # whatever the kernel did not take must stop aliasing the
                # caller's buffer before we return (borrowed views die
                # with this call); only the queued REMAINDER is copied
                self._own_queued_locked(conn, queued)
            if sanitizer.enabled and borrowed:
                # ownership tag: after a borrowed send returns, no queue
                # entry may still alias the caller's memory
                owner = payload.obj if isinstance(payload, memoryview) \
                    else payload
                for mv in conn.outq:
                    if getattr(mv, "obj", None) is owner:
                        sanitizer.fail(
                            "btl/tcp out-queue still aliases a borrowed "
                            "payload after send() returned")
        if chaos_rule is not None and chaos_rule["fault"] == "dup":
            # duplicate delivery of a best-effort CTL frame (a framing-level
            # retransmit): the FT protocols riding CTL are idempotent
            with conn.send_lock:
                conn.outq.append(memoryview(head))
                conn.out_bytes += len(head)
                if len(payload):
                    conn.outq.append(memoryview(bytes(payload)))
                    conn.out_bytes += len(payload)
                self._flush_locked(conn)
        self._drain_suspects()

    def _drain_suspects(self) -> None:
        """Fire deferred wire-reset suspicions (recorded by ``_drop_conn``
        under ``_conns_lock``, delivered here with no lock held: the report
        floods CTL frames over other connections and must not nest under
        transport locks)."""
        if not self._suspects:
            return
        with self._conns_lock:
            pending, self._suspects = self._suspects, []
        from ompi_tpu_torch.ft import propagator

        for rank in pending:
            propagator.wire_suspicion(rank)

    @staticmethod
    def _frame_too_large(nbytes: int) -> ValueError:
        # the !I length prefix caps one frame at 4GB-1; the pml fragments
        # far below this (max_send_size), so hitting it means a caller
        # bypassed fragmentation: fail loudly, never truncate the length
        show_help("help-btl-tcp", "frame-too-large",
                  nbytes=nbytes, limit=_MAX_FRAME)
        return ValueError(
            f"tcp frame of {nbytes} bytes exceeds the u32 length-prefix "
            f"limit ({_MAX_FRAME}); fragment the payload below "
            "btl.max_send_size")

    def _own_queued_locked(self, conn: _Conn, tail: int) -> None:
        """Own the newest ``tail`` queue entries (send_lock held): only
        the current send's fragment can alias its caller's buffer, and the
        FIFO drain keeps its remainder at the queue's tail."""
        q = conn.outq
        n = min(len(q), tail)
        if not n:
            return
        spc.record("fastpath_payload_copies")
        owned = [memoryview(bytes(q.pop())) for _ in range(n)]
        q.extend(reversed(owned))

    def _flush(self, conn: _Conn) -> None:
        with conn.send_lock:
            self._flush_locked(conn)

    @hot_path
    def _flush_locked(self, conn: _Conn) -> None:
        """Drain the out-queue with sendmsg scatter-gather; on EAGAIN with
        bytes left, register for writability instead of retrying."""
        q = conn.outq
        while q:
            bufs = []
            for mv in q:
                bufs.append(mv)
                if len(bufs) >= _IOV_BATCH:
                    break
            t0 = time.perf_counter_ns() \
                if (trace.enabled or profile.enabled) else 0
            try:
                n = conn.sock.sendmsg(bufs)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                # hard error (EPIPE/ECONNRESET): the bytes can never be
                # delivered; drop them so close()'s flush loop terminates
                q.clear()
                conn.out_bytes = 0
                self._mark_writable(conn, False)
                self._drop_conn(conn)
                return
            if trace.enabled or profile.enabled:
                t1 = time.perf_counter_ns()
                if trace.enabled:
                    # the peer rides along so the critical path's wire
                    # bucket can attribute syscall time to the rank the
                    # bytes went to (-1: a connection before its handshake)
                    trace.span("btl_sendmsg", "btl", t0, t1,
                               args={"nbytes": n, "iov": len(bufs),
                                     "peer": conn.rank
                                     if conn.rank is not None else -1})
                    trace.hist_record("btl_sendmsg", n, t1 - t0)
                if profile.enabled:
                    profile.stage_span("send.wire", t0, t1)
            spc.record("fastpath_sendmsg")
            if n == 0:
                break
            conn.out_bytes -= n
            while n and q:
                mv = q[0]
                if n >= len(mv):
                    n -= len(mv)
                    q.popleft()
                else:
                    q[0] = mv[n:]
                    n = 0
        self._mark_writable(conn, bool(q))

    def _mark_writable(self, conn: _Conn, want: bool) -> None:
        """(De)register writability interest for a backpressured conn."""
        if conn.want_write == want:
            return
        if conn.fd is not None:
            # reactor-owned stream: EPOLLOUT interest lives on the epoll
            # thread; its WRITABLE record routes back through
            # _reactor_event -> _flush (interest auto-clears on fire)
            if reactor_mod.want_write(conn.fd, want):
                conn.want_write = want
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if want
                                         else 0)
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            return   # conn already torn down / never registered
        conn.want_write = want

    # -- native-reactor record dispatch ----------------------------------
    @hot_path
    def _reactor_event(self, conn: _Conn, etype: int, payload) -> int:
        """Handler for one reactor record on this conn's stream.  FAST
        records carry a ready-to-unpack header + payload; the payload
        memoryview is borrowed drain-buffer scratch, valid until the next
        drain."""
        if etype == _R_FAST:
            if chaos.enabled:
                # recv-side chaos on the fast lane: delay only — corrupt
                # targets checksummed frames, and those never arrive here
                # (htype & _H_CK_BASE diverts to the RAW lane)
                rule = chaos.wire_recv("tcp", False)
                if rule is not None and rule["fault"] == "delay":
                    chaos.sleep_ms(rule)
            _pt = profile.now() if profile.enabled else 0
            (cid, src, dst, tag, seq, code, total_len, offset,
             req_id) = _FAST.unpack_from(payload, 0)
            data = np.frombuffer(payload, np.uint8, offset=_FAST.size)
            frag = Frag(cid, src, dst, tag, seq, _CODE_TO_KIND[code],
                        data, total_len, offset,
                        {} if req_id < 0 else {"req_id": req_id},
                        borrowed=True)
            if profile.enabled:
                profile.stage_span("recv.parse", _pt)
            spc.record("fastpath_native_frags")
            if self._recv_cb is not None:
                self._recv_cb(frag)
                return 1
            return 0
        if etype == _R_RAW:
            return self._reactor_raw(conn, payload)
        if etype == _R_WRITABLE:
            # the epoll thread cleared its EPOLLOUT interest before this
            # record: mirror that so the flush re-arms if still queued
            conn.want_write = False
            self._flush(conn)
            return 1
        if etype == _R_EOF:
            self._reactor_eof(conn)
            return 1
        if etype == _R_OVERSIZE:
            return self._reactor_raw(
                conn, memoryview(reactor_mod.take_oversize(conn.fd)))
        if etype == _R_DESYNC:
            self._wire_fault(
                "wire_desync", "btl/tcp framing desync: zero-length frame "
                "on the wire (native reactor)", _conn_peer(conn))
        return 0

    @hot_path
    def _reactor_raw(self, conn: _Conn, frame) -> int:
        """Slow-lane record: the native side forwards any frame that is
        not a plain fast header (crc-armed, quantized, pickle, handshake,
        unknown kind byte) VERBATIM, into the same ``_parse_frame`` the
        selector lane uses, after the same recv-side chaos hook."""
        if chaos.enabled:
            rule = chaos.wire_recv("tcp", False)
            if rule is not None:
                if rule["fault"] == "delay":
                    chaos.sleep_ms(rule)
                elif rule["fault"] == "corrupt" \
                        and len(frame) > 1 + _CKSUM.size + 1 \
                        and frame[0] & _H_CK_BASE:
                    frame[1 + _CKSUM.size] ^= 0x01
        _pt = profile.now() if profile.enabled else 0
        frag = self._parse_frame(conn, frame, borrowed=True)
        if profile.enabled:
            profile.stage_span("recv.parse", _pt)
        spc.record("fastpath_native_raw")
        if frag is not None and self._recv_cb is not None:
            self._recv_cb(frag)
            return 1
        return 0

    def _on_accept_record(self, etype: int, payload) -> int:
        """NOTIFY record for the listener: accept everything pending,
        register each conn as a reactor stream, then re-arm."""
        if etype != _R_ACCEPT or self._listener is None:
            return 0
        events = 0
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._register_conn(_Conn(sock))
            events += 1
        reactor_mod.rearm(self._listener.fileno())
        return events

    def _reactor_eof(self, conn: _Conn) -> None:
        """Peer closed (or hard error) on a reactor stream: the selector
        lane's zero-byte recv teardown."""
        fd, conn.fd = conn.fd, None
        if fd is not None:
            reactor_mod.remove(fd)
            self._rconns.pop(fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        self._drop_conn(conn)

    # -- progress --------------------------------------------------------
    @hot_path
    def progress(self) -> int:
        events = 0
        self._drain_suspects()
        if self._reactor and not self._sel.get_map():
            # native-reactor lane: every socket lives on the epoll thread
            # and records arrive via reactor_mod.drain (a sibling progress
            # callback); nothing to select here
            return 0
        try:
            ready = self._sel.select(timeout=0)
        except OSError:
            return 0
        for key, mask in ready:
            if key.data == "listener":
                try:
                    sock, _ = self._listener.accept()
                except OSError:
                    continue
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn = _Conn(sock)
                self._sel.register(sock, selectors.EVENT_READ, conn)
                from ompi_tpu_torch.runtime import progress as progress_mod

                progress_mod.register_waiter(sock)
                continue
            conn: _Conn = key.data
            if mask & selectors.EVENT_WRITE:
                # backpressured conn turned writable: drain the queue
                self._flush(conn)
                events += 1
            if not mask & selectors.EVENT_READ:
                continue
            try:
                n = conn.sock.recv_into(conn.scratch)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                n = 0
            if not n:
                from ompi_tpu_torch.runtime import progress as progress_mod

                progress_mod.unregister_waiter(conn.sock)
                try:
                    self._sel.unregister(conn.sock)
                    conn.sock.close()
                except (OSError, KeyError):
                    pass
                self._drop_conn(conn)
                continue
            events += self._on_bytes(conn, memoryview(conn.scratch)[:n])
        return events

    def _all_conns(self) -> list:
        return [c for conns in self._by_rank.values() for c in conns]

    def _drop_conn(self, conn: "_Conn") -> None:
        # under _conns_lock: the app thread (flush hard error) and the
        # progress thread (EOF) can race this remove against _connect's
        # extend and the handshake append
        if conn.rank is None:
            return
        with self._conns_lock:
            conns = self._by_rank.get(conn.rank)
            if conns and conn in conns:
                conns.remove(conn)
                if not conns:
                    self._by_rank.pop(conn.rank, None)
            # a peer reset or unexpected EOF mid-traffic: a suspicion for
            # the FT detector (drained outside the lock; a no-op in jobs
            # without one).  A teardown-time close never reaches here:
            # close() clears _by_rank wholesale
            self._suspects.append(conn.rank)

    @staticmethod
    def _need(inbuf) -> int:
        """Bytes still missing before the parked frame is complete."""
        if len(inbuf) < _LEN.size:
            return _LEN.size - len(inbuf)
        (fl,) = _LEN.unpack_from(inbuf, 0)
        return max(0, _LEN.size + fl - len(inbuf))

    @hot_path
    def _on_bytes(self, conn: _Conn, view: memoryview) -> int:
        """Parse one recv's worth of stream bytes.

        Complete frames are parsed ZERO-COPY straight out of the recv
        scratch (the delivered Frag is ``borrowed``: valid until the next
        recv on this conn); only a frame split across recv boundaries takes
        the buffered path through ``inbuf``."""
        events = 0
        pos, n = 0, len(view)
        try:
            # finish a frame parked split across recvs (the length prefix
            # itself may be split, so _need grows once it is complete)
            while conn.inbuf:
                take = min(self._need(conn.inbuf), n - pos)
                if take:
                    conn.inbuf += view[pos:pos + take]
                    pos += take
                if self._need(conn.inbuf) == 0:
                    events += self._drain(conn)
                elif pos >= n:
                    return events   # chunk exhausted mid-frame
            # fast path: complete frames straight from the scratch view
            while n - pos >= _LEN.size:
                (fl,) = _LEN.unpack_from(view, pos)
                if sanitizer.enabled and fl < 1:
                    sanitizer.fail("btl/tcp framing desync: zero-length "
                                   "frame on the wire")
                if n - pos < _LEN.size + fl:
                    break
                frame = view[pos + _LEN.size:pos + _LEN.size + fl]
                pos += _LEN.size + fl
                if chaos.enabled:
                    # recv-side faults on tcp are delay + corrupt only
                    # (loss_ok=False): the frag class is unknown before
                    # parse, and loss faults are the SEND side's job
                    rule = chaos.wire_recv("tcp", False)
                    if rule is not None:
                        if rule["fault"] == "delay":
                            chaos.sleep_ms(rule)
                        elif rule["fault"] == "corrupt" \
                                and fl > 1 + _CKSUM.size + 1 \
                                and frame[0] & _H_CK_BASE:
                            # pre-verify bit rot in the recv scratch, only
                            # on checksummed frames (an unarmed sender's
                            # frame would corrupt silently)
                            frame[1 + _CKSUM.size] ^= 0x01
                _pt = profile.now() if profile.enabled else 0
                frag = self._parse_frame(conn, frame, borrowed=True)
                if profile.enabled:
                    profile.stage_span("recv.parse", _pt)
                if frag is not None and self._recv_cb is not None:
                    self._recv_cb(frag)
                    events += 1
        finally:
            # park the partial tail and, if a delivery callback raised
            # mid-chunk, the whole unparsed remainder: the scratch is
            # overwritten by the next recv
            if pos < n:
                conn.inbuf += view[pos:]
        return events

    @hot_path
    def _drain(self, conn: _Conn) -> int:
        """Parse complete frames off the in-buffer (split-frame
        reassembly); the consumed prefix is deleted ONCE after the loop."""
        events = 0
        pos = 0
        buf = conn.inbuf
        try:
            while True:
                if len(buf) - pos < _LEN.size:
                    return events
                (n,) = _LEN.unpack_from(buf, pos)
                if sanitizer.enabled and n < 1:
                    sanitizer.fail("btl/tcp framing desync: zero-length "
                                   "frame in the reassembly buffer")
                if len(buf) - pos < _LEN.size + n:
                    return events
                frame = bytes(memoryview(buf)[pos + _LEN.size:
                                              pos + _LEN.size + n])
                pos += _LEN.size + n
                _pt = profile.now() if profile.enabled else 0
                frag = self._parse_frame(conn, frame)
                if profile.enabled:
                    profile.stage_span("recv.parse", _pt)
                if frag is not None and self._recv_cb is not None:
                    self._recv_cb(frag)
                    events += 1
        finally:
            if pos:
                del conn.inbuf[:pos]

    def _parse_frame(self, conn: Optional[_Conn], frame,
                     borrowed: bool = False) -> Optional[Frag]:
        """Decode one frame (bytes or memoryview).  ``borrowed`` marks the
        payload as a view of transient recv scratch.  Checksummed frames
        are verified before any parse (a mismatch is a loud, attributed
        error), and quantized frames decode straight out of the recv view
        into an OWNED array of the original bytes."""
        htype = frame[0]
        off = 1
        if htype & _H_CK_BASE:
            (want,) = _CKSUM.unpack_from(frame, 1)
            off = 1 + _CKSUM.size
            got = zlib.crc32(memoryview(frame)[off:])
            if got != want:
                self._corrupt_frame(conn, len(frame), want, got)
        qmeta = None
        if htype & _H_QUANT:
            qmeta = _QHDR.unpack_from(frame, off)
            off += _QHDR.size
        if htype & _H_FAST:
            (cid, src, dst, tag, seq, code, total_len, offset,
             req_id) = _FAST.unpack_from(frame, off)
            data = np.frombuffer(frame, np.uint8, offset=off + _FAST.size)
            if qmeta is not None:
                data = self._dequant_payload(conn, data, qmeta)
                borrowed = False
            return Frag(cid, src, dst, tag, seq, _CODE_TO_KIND[code],
                        data, total_len, offset,
                        {} if req_id < 0 else {"req_id": req_id},
                        borrowed=borrowed)
        (hlen,) = _LEN.unpack_from(frame, off)
        obj = pickle.loads(
            memoryview(frame)[off + _LEN.size:off + _LEN.size + hlen])
        if isinstance(obj, dict) and "rank" in obj and conn.rank is None:
            conn.rank = obj["rank"]
            # accepted links become reply rails for this rank too
            with self._conns_lock:
                self._by_rank.setdefault(conn.rank, []).append(conn)
            return None
        cid, src, dst, tag, seq, kind, total_len, offset, meta = obj
        data = np.frombuffer(frame, np.uint8, offset=off + _LEN.size + hlen)
        if qmeta is not None:
            data = self._dequant_payload(conn, data, qmeta)
            borrowed = False
        return Frag(cid, src, dst, tag, seq, kind, data,
                    total_len, offset, meta, borrowed=borrowed)

    def _dequant_payload(self, conn: Optional[_Conn], data, qmeta):
        """Receive side of the codec stage: the decode MUST be exact; any
        inconsistency is wire corruption and fails as loudly as a crc32
        mismatch (show_help, SanitizeError)."""
        try:
            return quant_mod.decode_wire(data, qmeta[0], qmeta[1], qmeta[2])
        except (ValueError, KeyError) as exc:
            peer = _conn_peer(conn)
            show_help("help-coll-quant", "wire-frame-bad",
                      peer=peer, error=str(exc))
            self._wire_fault(
                "quant_wire_decode_fail",
                f"btl/tcp quantized frame from rank {peer} does not "
                f"decode ({exc}): wire corruption detected", peer, len(data))

    def _corrupt_frame(self, conn: Optional[_Conn], nbytes: int,
                       want: int, got: int) -> None:
        """A checksummed frame failed verification: silent wire corruption
        made loud and attributed."""
        peer = _conn_peer(conn)
        show_help("help-btl-tcp", "frame-corrupt", peer=peer,
                  nbytes=nbytes, want=want, got=got)
        self._wire_fault(
            "wire_cksum_fail", f"btl/tcp frame from rank {peer} failed its crc32 "
            f"({nbytes} bytes, want {want:#x} got {got:#x}): wire "
            "corruption detected", peer, nbytes)

    def _wire_fault(self, counter: str, message: str, peer: int = -1,
                    nbytes: int = 0) -> None:
        """Shared tail of a wire-integrity trip (crc mismatch, a quant
        frame that does not decode, a framing desync), each under its own
        counter: counted, trace-instant'ed, abort event posted, then
        SanitizeError raised.  Raising from the progress thread alone
        could leave the job hanging; the abort event (and the progress
        loop re-raising SanitizeError) lets the launcher tear the job down
        with the diagnostic on record."""
        spc.record(counter)
        if trace.enabled:
            trace.instant(counter, "btl",
                          args={"peer": peer, "nbytes": nbytes})
        if self._rte is not None:
            try:
                self._rte.event_notify("abort",
                                       {"code": 1, "why": counter})
            except Exception:
                pass
        raise sanitizer.SanitizeError(message)

    def flush(self, timeout: float = 30.0) -> None:
        """Hand every queued outbound byte to the kernel (bounded window):
        the same delivered-but-unsent exit hazard as btl/sm's."""
        deadline = time.monotonic() + timeout
        while (any(c.outq for c in self._all_conns())
               and time.monotonic() < deadline):
            for conn in self._all_conns():
                if conn.outq:
                    self._flush(conn)
            if any(c.outq for c in self._all_conns()):
                time.sleep(0.0005)

    def close(self) -> None:
        # a closed btl must stop publishing telemetry: the sampler would
        # report frozen queue depths as live data
        from ompi_tpu_torch.runtime import telemetry

        telemetry.unregister_source("tcp")
        # queued outbound bytes go to the kernel first, within 30 s (the
        # same delivered-but-unsent exit hazard as btl/sm's close; the
        # reference's inline drain, which bml's pre-fence flush shares)
        self.flush(30.0)
        from ompi_tpu_torch.runtime import progress as progress_mod

        # reactor-owned fds leave the epoll set before their sockets close
        # (an fd closed while registered could recycle into a new stream)
        if self._reactor:
            for fd, conn in list(self._rconns.items()):
                reactor_mod.remove(fd)
                self._rconns.pop(fd, None)
                conn.fd = None
                try:
                    conn.sock.close()
                except OSError:
                    pass
            if self._listener is not None:
                reactor_mod.remove(self._listener.fileno())
            self._reactor = False
        # every registered socket (accepted-but-unhandshaked conns too)
        # must leave the global waiter selector, or their EOF-readable fds
        # make idle_wait() busy-spin after this btl is gone
        for key in list(self._sel.get_map().values()):
            if key.data == "listener":
                continue
            progress_mod.unregister_waiter(key.fileobj)
            try:
                self._sel.unregister(key.fileobj)
                key.fileobj.close()
            except (OSError, KeyError):
                pass
        with self._conns_lock:
            self._by_rank.clear()
        if self._listener is not None:
            progress_mod.unregister_waiter(self._listener)
            try:
                self._sel.unregister(self._listener)
            except (KeyError, ValueError):
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None


COMPONENT = TcpBtl()

register_help(
    "help-btl-tcp", "frame-too-large",
    "btl/tcp was asked to send a {nbytes}-byte frame, above the u32 "
    "length-prefix limit of {limit} bytes.  Fragment the payload below "
    "btl_tcp_max_send_size instead of sending it whole.")
register_help(
    "help-btl-tcp", "frame-corrupt",
    "btl/tcp received a {nbytes}-byte frame from rank {peer} whose crc32 "
    "does not verify (expected {want}, computed {got}): the bytes were "
    "corrupted on the wire.  The job is being aborted — silent corruption "
    "must never reach the application.  (Checksums are armed under "
    "chaos injection and OTPU_SANITIZE.)")
