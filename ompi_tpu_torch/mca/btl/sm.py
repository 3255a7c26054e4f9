"""btl/sm — shared-memory transport for the ranks of one machine.

Copy of ``ompi_tpu/mca/btl/sm.py`` (after the reference's
``opal/mca/btl/sm/``: per-peer lock-free FIFOs over a mapped segment,
``btl_sm_component.c:71-77``): each receiver owns one SPSC byte ring per
sender in a ``multiprocessing.shared_memory`` segment (layout: head u64 |
tail u64 | data[cap]), published through the modex.  Writers append
length-prefixed fragments when space allows and queue the rest for retry
from the progress loop; readers drain from progress.  8-byte aligned
head/tail updates order the SPSC handoff (x86/ARM64 single-writer
semantics).  After a push the writer pings the reader's doorbell (an
abstract unix datagram socket) so an idle reader blocked in
``progress.idle_wait`` wakes at once.

Push and pop run through the native core's ring ops (``native.ring_push2``,
``ring_peek_len``, ``ring_pop``: the ``opal_fifo`` analog, fenced) when it
is built, else through numpy slice copies between the caller's arrays and
the mapped segment; the layout is the same either way, so processes of
either lane interoperate (``sm.py:65-160``).  With the native reactor
engaged the doorbell is a MODE_DRAIN fd of its epoll set (``sm.py:221``):
the reactor thread consumes the pings and its wait fd wakes idle waiters.
Reachability keys on the node identity, ``OTPU_NODE_ID`` first and then the
host name (``sm.py:215-219``): across ``tpurun --fake-nodes`` nodes the
traffic goes over btl/tcp.  Segment and doorbell names carry the port's
own prefix (``otpt_``), the coordination address and the pid, so they never
meet the reference's (``otpu_``) or another job's.

The one-sided triple (``rdma = True``; ``prepare_src``, ``release_src``,
``get``, ``put``, ``sm.py:443-520``), which ob1's RGET rung pulls from: a
mapped-segment copy.  ``prepare_src`` stages the packed bytes into a
shared-memory segment (one copy), the peer's ``get`` copies them straight
into its destination (one copy): two copies and one ring handoff, where
the rendezvous stream costs three copies and a frame per
``max_send_size``.  Segments are pooled by pow2 size class (64 KB floor,
:data:`_RMA_POOL_CAP` a class) and peers cache their attachments
(``4 * _RMA_POOL_CAP``), the registration cache's role.  Exposed segments
are named ``otpt_rg_<rank>_<pid>_<seq>`` (the reference's
``otpu_rg_...`` with the port's prefix); ``close`` unlinks every pooled
and exposed one.

Observability (``sm.py:347-411``): the header build is the ``send.queue``
stage, the ring write (sm's wire) a ``btl_ringpush`` span of category
``btl`` with its log2 histogram and the ``send.wire`` stage, and the
frame's unpickle the ``recv.parse`` stage, each behind its module flag.
Under ULFM, ``flush`` drops the frames queued to a rank the FT state holds
failed (``sm.py:530-540``), so a survivor's finalize never waits on the
dead; a live peer that stops draining still fails the rank.

Chaos (``sm.py:335-349``, ``:412-417``): a send consults
``chaos.wire_send("sm", ...)`` (drop and dup on best-effort CTL frames
only, ``btl.base.loss_ok``; delay on any), and each frame popped from a
ring ``chaos.wire_recv`` with the frame's real class (drop withholds a CTL
delivery, dup delivers it twice, delay sleeps).  sm rides host memory, not a
wire: no corruption and no reset.  Both ring lanes (the native core's and
numpy's) deliver through the same Python drain, so the hooks cover both;
each sits behind ``if chaos.enabled``.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.containers import Fifo
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.ft import chaos
from ompi_tpu_torch.mca.btl.base import Btl, Endpoint, Frag, loss_ok, \
    owned_bytes
from ompi_tpu_torch.runtime import profile, trace
from ompi_tpu_torch.runtime.hotpath import hot_path

_HDR = struct.Struct("<QQ")  # head, tail
_LEN = struct.Struct("<I")
_DATA_OFF = _HDR.size

#: prefix of every shared-memory segment and doorbell this btl creates
NAME_PREFIX = "otpt"
#: seconds ``flush`` waits for receivers to make ring space at finalize
FLUSH_TIMEOUT_S = 30.0


def _frame_hdr(frag: Frag) -> bytes:
    """Pickle the fragment's metadata WITHOUT the payload: the payload
    rides raw after the header so large messages never pay the pickle
    round trip."""
    return pickle.dumps(
        (frag.cid, frag.src, frag.dst, frag.tag, frag.seq, frag.kind,
         frag.total_len, frag.offset, frag.meta),
        protocol=pickle.HIGHEST_PROTOCOL)


def _unframe(buf: np.ndarray) -> Frag:
    """Rebuild a Frag from one popped frame; ``data`` is a zero-copy view
    of the ring's REUSED scratch buffer, so the frag is ``borrowed``:
    valid until the next pop — queue points must call ``own_data()``."""
    (hlen,) = _LEN.unpack_from(buf, 0)
    cid, src, dst, tag, seq, kind, total_len, offset, meta = \
        pickle.loads(memoryview(buf)[_LEN.size:_LEN.size + hlen])
    return Frag(cid, src, dst, tag, seq, kind,
                buf[_LEN.size + hlen:], total_len, offset, meta,
                borrowed=True)


def _as_u8(payload) -> np.ndarray:
    """Zero-copy uint8 view of any contiguous bytes-like payload."""
    if isinstance(payload, np.ndarray):
        return payload.reshape(-1).view(np.uint8)
    return np.frombuffer(payload, np.uint8)


class _Ring:
    """SPSC byte ring over a shared memory buffer.

    Frames move straight between the caller's arrays and the mapped segment
    (one copy each way, the payload never concatenated into ``bytes``): the
    native core's ring ops when it is built, numpy slice copies otherwise;
    the layout is the reference's either way."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self.shm = shm
        self.owner = owner
        self.cap = len(shm.buf) - _DATA_OFF
        if owner:
            _HDR.pack_into(shm.buf, 0, 0, 0)
        self._data = np.frombuffer(shm.buf, np.uint8, offset=_DATA_OFF)
        self._framebuf: Optional[np.ndarray] = None
        # the segment's base address for the native ring ops (None: the
        # numpy lane)
        self._addr: Optional[int] = None
        from ompi_tpu_torch import native

        if native.available():
            self._native = native
            self._addr = self._data.ctypes.data - _DATA_OFF

    def _load(self) -> tuple[int, int]:
        return _HDR.unpack_from(self.shm.buf, 0)

    def _put(self, pos: int, src: np.ndarray) -> int:
        """Copy ``src`` into the ring at ``pos`` (wrapping); the next
        position."""
        n = len(src)
        first = min(n, self.cap - pos)
        self._data[pos:pos + first] = src[:first]
        if first < n:
            self._data[:n - first] = src[first:]
        return (pos + n) % self.cap

    def _get(self, pos: int, dst: np.ndarray) -> None:
        """Copy ``len(dst)`` ring bytes at ``pos`` (wrapping) into dst."""
        n = len(dst)
        first = min(n, self.cap - pos)
        dst[:first] = self._data[pos:pos + first]
        if first < n:
            dst[first:] = self._data[:n - first]

    def push_frame(self, hdr: bytes, payload) -> bool:
        """Push one [u32 n][u32 hlen][hdr][payload] frame, or return False
        when the ring lacks the room."""
        body = _as_u8(payload)
        if self._addr is not None:
            pre = _LEN.pack(len(hdr)) + hdr
            return self._native.ring_push2(
                self._addr, self.cap, np.frombuffer(pre, np.uint8), body)
        n = _LEN.size + len(hdr) + len(body)
        head, tail = self._load()
        if _LEN.size + n > self.cap - (tail - head):
            return False
        pre = _LEN.pack(n) + _LEN.pack(len(hdr)) + hdr
        pos = self._put(tail % self.cap, np.frombuffer(pre, np.uint8))
        self._put(pos, body)
        struct.pack_into("<Q", self.shm.buf, 8, tail + _LEN.size + n)
        return True

    def pop_frame(self) -> Optional[np.ndarray]:
        """Pop one frame into a REUSED scratch buffer; returns a view of it,
        valid until the next pop on this ring (the popped Frag is marked
        ``borrowed`` accordingly), or None."""
        if self._addr is not None:
            n = self._native.ring_peek_len(self._addr, self.cap)
            if n < 0:
                return None
            buf = self._framebuf
            if buf is None or len(buf) < n:
                buf = self._framebuf = np.empty(max(n, 64 * 1024), np.uint8)
            if self._native.ring_pop(self._addr, self.cap, buf) < 0:
                return None
            return buf[:n]
        head, tail = self._load()
        if tail - head < _LEN.size:
            return None
        pos = head % self.cap
        word = np.empty(_LEN.size, np.uint8)
        self._get(pos, word)
        (n,) = _LEN.unpack(word.tobytes())
        if tail - head < _LEN.size + n:
            return None  # writer mid-frame
        buf = self._framebuf
        if buf is None or len(buf) < n:
            buf = self._framebuf = np.empty(max(n, 64 * 1024), np.uint8)
        self._get((pos + _LEN.size) % self.cap, buf[:n])
        struct.pack_into("<Q", self.shm.buf, 0, head + _LEN.size + n)
        return buf[:n]

    def close(self, unlink: bool) -> None:
        self._data = None    # release the export before the mapping closes
        self.shm.close()
        if unlink:
            self.shm.unlink()


def _attach(name: str) -> shared_memory.SharedMemory:
    shm = shared_memory.SharedMemory(name=name)
    # CPython's resource tracker would unlink segments we merely attached
    # to; the owner is responsible for cleanup (well-known workaround).
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    return shm


class SmBtl(Btl):
    name = "sm"
    priority = 50
    # shared memory pays per-handoff (scheduling + matching) cost, not
    # per-byte: a single big eager frame is one ring write, while RNDV
    # costs 3 handoffs.  The 4MB ring holds two in-flight 512KB frames.
    eager_limit = 512 * 1024
    rndv_eager_limit = 512 * 1024
    max_send_size = 1024 * 1024
    latency = 10          # below tcp (100), above self (0)
    bandwidth = 10000

    def __init__(self) -> None:
        super().__init__()
        self._rte = None
        self._rings_in: dict[int, _Ring] = {}    # per-sender, I own these
        self._rings_out: dict[int, _Ring] = {}   # per-receiver, attached
        self._pending: dict[int, Fifo] = {}
        self._db_rx: Optional[socket.socket] = None   # my doorbell
        self._db_tx: Optional[socket.socket] = None   # ring peers' bells
        self._db_addr: dict[int, str] = {}            # rank -> bell address
        # node identity, not the raw host name: OTPU_NODE_ID partitions
        # ranks into emulated nodes (tpurun --fake-nodes), and shared
        # memory must not be offered across that boundary, so traffic
        # between nodes goes over btl/tcp
        self._hostname = os.environ.get("OTPU_NODE_ID", socket.gethostname())
        # doorbell registered with the native reactor (MODE_DRAIN): the
        # epoll thread consumes the pings and its wait fd wakes idle_wait
        self._db_reactor = False
        self._ring_size = 4 << 20
        # a ring has one producer and one consumer, but the progress engine
        # and the sends may run on several threads (osc/pt2pt's agent):
        # pushes, the pending retries and the drain are serialized here
        self._tx_lock = threading.Lock()
        self._rx_lock = threading.Lock()
        # one-sided segments: mine by size class (free) and by name
        # (exposed), and the peers' I attached (insertion order: LRU); the
        # sending threads expose and the drain releases, so the pool, the
        # names and both maps change only under _rma_lock
        self._rma_lock = threading.Lock()
        self._rma_pool: dict[int, list] = {}
        self._exposed: dict[str, shared_memory.SharedMemory] = {}
        self._attached: dict[str, shared_memory.SharedMemory] = {}
        self._expose_seq = 0

    def _clamped(self, limit: int) -> int:
        """A frame larger than the ring can NEVER be pushed (push would
        retry forever): bound protocol limits to half the capacity minus
        framing slack, so two in-flight max frags always fit."""
        return min(int(limit), max(1024, self._ring_size // 2 - 4096))

    def register_vars(self, fw) -> None:
        self.register_var(
            "ring_size", vtype=VarType.SIZE, default="4m",
            help="Per-peer shared-memory FIFO capacity (takes effect at "
                 "setup; rings are not resized after init)",
            on_set=lambda v: setattr(self, "_ring_size", int(v)))
        self.register_var(
            "eager_limit", vtype=VarType.SIZE, default="512k",
            help="Max eager message size over sm",
            on_set=lambda v: setattr(self, "eager_limit", self._clamped(v)))

    def setup(self, rte) -> bool:
        if rte.is_device_world or rte.world_size <= 1:
            return False
        if not hasattr(rte, "modex_put"):
            return False
        self._rte = rte
        self.max_send_size = self._clamped(self.max_send_size)
        self.eager_limit = self._clamped(self.eager_limit)
        self.rndv_eager_limit = self._clamped(self.rndv_eager_limit)
        me = rte.my_world_rank
        job = os.environ.get("OTPU_COORD", "local").replace(":", "_") \
            .replace(".", "_")
        pid = os.getpid() & 0xffff
        names = {}
        # inbound rings for my job's peers (global ranks under dpm); a
        # cross-job peer has no ring and `reachable` declines it, so btl/tcp
        # carries the bridge
        for src in getattr(rte, "job_ranks", range(rte.world_size)):
            if src == me:
                continue
            name = f"{NAME_PREFIX}_{job}_{src}_{me}_{pid}"
            shm = shared_memory.SharedMemory(
                name=name, create=True, size=self._ring_size + _DATA_OFF)
            self._rings_in[src] = _Ring(shm, owner=True)
            names[src] = name
        # doorbell: an abstract unix dgram socket peers ping after pushing
        # a frame, so an idle receiver blocked in progress.idle_wait wakes
        # immediately instead of sleeping out its backoff
        db_name = None
        try:
            from ompi_tpu_torch.runtime import progress as progress_mod

            db = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            db.setblocking(False)
            db_name = f"\0{NAME_PREFIX}_db_{job}_{me}_{pid}"
            db.bind(db_name)
            self._db_rx = db
            self._db_tx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            self._db_tx.setblocking(False)
            from ompi_tpu_torch.runtime import reactor as reactor_mod

            self._db_reactor = reactor_mod.engage() and reactor_mod.add(
                db.fileno(), reactor_mod.MODE_DRAIN, self._on_doorbell_record)
            if not self._db_reactor:
                progress_mod.register_waiter(db)
        except OSError:
            self._db_rx = self._db_tx = None
            db_name = None
        rte.modex_put("btl_sm_rings", {"host": self._hostname,
                                       "names": names, "db": db_name})
        return True

    def _ring_doorbell(self, rank: int, info: Optional[dict] = None) -> None:
        if self._db_tx is None:
            return
        db = info.get("db") if info is not None else self._db_addr.get(rank)
        if db is None:
            return
        try:
            self._db_tx.sendto(b"x", db)
        except OSError:
            pass  # full/absent: receiver still polls on its own cadence

    def reachable(self, world_rank: int, rte) -> Optional[Endpoint]:
        if self._rte is None or world_rank == rte.my_world_rank:
            return None
        # non-blocking probe: peers are guaranteed published by the init
        # fence (runtime/init.py fences after pml selection)
        info = rte.modex_get(world_rank, "btl_sm_rings", wait=False)
        if info is None or info["host"] != self._hostname:
            return None
        if rte.my_world_rank not in info["names"]:
            return None   # peer has no inbound ring for me
        return Endpoint(self, world_rank, addr=info)

    def _ring_to(self, rank: int, info: dict) -> _Ring:
        ring = self._rings_out.get(rank)
        if ring is None:
            name = info["names"][self._rte.my_world_rank]
            ring = _Ring(_attach(name), owner=False)
            self._rings_out[rank] = ring
            if info.get("db") is not None:
                self._db_addr[rank] = info["db"]
        return ring

    @hot_path
    def send(self, ep: Endpoint, frag: Frag) -> None:
        chaos_dup = False
        if chaos.enabled:
            rule = chaos.wire_send("sm", loss_ok(frag))
            if rule is not None:
                fault = rule["fault"]
                if fault == "drop":
                    return          # best-effort CTL frame lost
                if fault == "delay":
                    chaos.sleep_ms(rule)
                chaos_dup = fault == "dup"
        # stage clock: the header build is send.queue; the ring write
        # itself (the sm "wire") is send.wire
        _pt = profile.now() if profile.enabled else 0
        hdr = _frame_hdr(frag)
        if profile.enabled:
            profile.stage_span("send.queue", _pt)
        with self._tx_lock:
            ring = self._ring_to(ep.world_rank, ep.addr)
            if chaos_dup:
                # framing-level duplicate of an idempotent CTL frame
                if not ring.push_frame(hdr, frag.data):
                    self._pending.setdefault(ep.world_rank, Fifo()).push(
                        (hdr, owned_bytes(frag.data)))
            # the ring write is sm's "wire": traced like tcp's btl_sendmsg
            _t0 = trace.now() if (trace.enabled or profile.enabled) else 0
            if not ring.push_frame(hdr, frag.data):
                # defer with an OWNED payload copy: the caller's request
                # may complete (eager) and the user reuse the buffer before
                # the retry fires from the progress loop
                self._pending.setdefault(ep.world_rank, Fifo()).push(
                    (hdr, owned_bytes(frag.data)))
            t1 = trace.now() if _t0 else 0
        if _t0:
            if trace.enabled:
                nb = getattr(frag.data, "nbytes", None)
                if nb is None:
                    nb = len(frag.data)
                trace.span("btl_ringpush", "btl", _t0, t1,
                           args={"nbytes": int(nb),
                                 "peer": ep.world_rank})
                trace.hist_record("btl_ringpush", int(nb), t1 - _t0)
            if profile.enabled:
                profile.stage_span("send.wire", _t0, t1)
        self._ring_doorbell(ep.world_rank, ep.addr)

    def _on_doorbell_record(self, etype: int, payload) -> int:
        """Reactor DOORBELL record: the epoll thread consumed the pings and
        woke any idle waiter; the ring drain runs on this same progress
        tick, so the record IS the wakeup."""
        return 0

    @hot_path
    def progress(self) -> int:
        events = 0
        # drain doorbell pings (edge signal only; frames carry the data);
        # with the reactor engaged its epoll thread consumed them
        if self._db_rx is not None and not self._db_reactor:
            while True:
                try:
                    self._db_rx.recv(512)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    break
        # drain incoming rings: one consumer at a time (a ring is SPSC and
        # a popped frame borrows the ring's scratch buffer); a thread that
        # finds another draining skips the drain
        if self._rx_lock.acquire(blocking=False):
            try:
                for ring in self._rings_in.values():
                    while True:
                        buf = ring.pop_frame()
                        if buf is None:
                            break
                        if self._recv_cb is not None:
                            _pt = profile.now() if profile.enabled else 0
                            frag = _unframe(buf)
                            if profile.enabled:
                                profile.stage_span("recv.parse", _pt)
                            if chaos.enabled:
                                rule = chaos.wire_recv("sm", loss_ok(frag))
                                if rule is not None:
                                    fault = rule["fault"]
                                    if fault == "delay":
                                        chaos.sleep_ms(rule)
                                    elif fault == "drop":
                                        continue   # delivery withheld
                                    elif fault == "dup":
                                        self._recv_cb(_unframe(buf))
                            self._recv_cb(frag)
                            events += 1
            finally:
                self._rx_lock.release()
        with self._tx_lock:
            events += self._retry_pending()
        return events

    def _retry_pending(self) -> int:
        """Push queued frames into their rings (caller holds the tx lock)."""
        events = 0
        for rank, fifo in self._pending.items():
            ring = self._rings_out.get(rank)
            if ring is None:
                continue
            while len(fifo):
                hdr, payload = fifo.pop()
                if not ring.push_frame(hdr, payload):
                    # put it back at the front by re-queueing a new fifo
                    newf = Fifo()
                    newf.push((hdr, payload))
                    while len(fifo):
                        newf.push(fifo.pop())
                    self._pending[rank] = newf
                    break
                self._ring_doorbell(rank)
                events += 1
        return events

    def flush(self, timeout: Optional[float] = None) -> None:
        """Push every queued frame into its ring: a send completes once its
        frags are packed, so a frame can still wait here for ring space
        that only its receiver's progress frees (bounded window).  Frames
        still queued after ``timeout`` (default :data:`FLUSH_TIMEOUT_S`)
        would never reach their peer: that is an error, not a quiet exit.
        Frames to a rank the FT state holds failed are undeliverable and
        dropped, as the reference's ``close`` skips them (``sm.py:530-540``);
        a live but stuck peer still fails the rank."""
        import time as _time

        from ompi_tpu_torch.ft import state as ft_state

        deadline = _time.monotonic() + (
            FLUSH_TIMEOUT_S if timeout is None else timeout)
        while True:
            with self._tx_lock:
                for r in [r for r in self._pending if ft_state.is_failed(r)]:
                    del self._pending[r]
            if not any(len(f) for f in self._pending.values()):
                return
            if _time.monotonic() >= deadline:
                stuck = {r: len(f) for r, f in self._pending.items() if len(f)}
                raise MpiError(ErrorClass.ERR_OTHER,
                               f"btl/sm: frames still queued for world ranks "
                               f"{stuck} after the flush timeout; their "
                               f"receivers stopped draining")
            if self.progress() == 0:
                _time.sleep(0.0005)

    # -- one-sided RMA (btl.h:949 put / :987 get) ------------------------
    rdma = True
    _RMA_POOL_CAP = 8

    def prepare_src(self, ep: Endpoint, arr) -> dict:
        """Expose ``arr``'s bytes in a pooled segment; the key a peer's
        ``get``/``put`` names it by."""
        src = _as_u8(arr)
        # pow2 size class with a 64KB floor
        size = 1 << max(16, (int(len(src)) - 1).bit_length())
        with self._rma_lock:
            free = self._rma_pool.get(size)
            if free:
                shm = free.pop()
            else:
                self._expose_seq += 1
                name = (f"{NAME_PREFIX}_rg_{self._rte.my_world_rank}_"
                        f"{os.getpid() & 0xffff}_{self._expose_seq}")
                shm = shared_memory.SharedMemory(name=name, create=True,
                                                 size=size)
            self._exposed[shm.name] = shm
        # the segment is this send's alone until release_src: no peer
        # reads it before the key goes out
        np.copyto(np.frombuffer(shm.buf, np.uint8, count=len(src)), src)
        return {"btl": "sm", "seg": shm.name, "size": size,
                "nbytes": int(len(src))}

    def release_src(self, key: dict) -> None:
        with self._rma_lock:
            shm = self._exposed.pop(key["seg"], None)
            if shm is None:
                return
            pool = self._rma_pool.setdefault(key["size"], [])
            if len(pool) < self._RMA_POOL_CAP:
                pool.append(shm)   # keep warm: the name is stable, peers
                return             # stay attached across reuses
        try:
            shm.close()
            shm.unlink()
        except (OSError, BufferError):
            pass

    def _rma_attach(self, name: str) -> shared_memory.SharedMemory:
        cache = self._attached
        with self._rma_lock:
            shm = cache.get(name)
            if shm is not None:
                return shm
            shm = cache[name] = _attach(name)
            evicted = []
            while len(cache) > 4 * self._RMA_POOL_CAP:
                oldest = next(iter(cache))   # insertion order: never the
                if oldest == name:           # entry just added
                    break
                evicted.append(cache.pop(oldest))
        for old in evicted:
            try:
                old.close()
            except (OSError, BufferError):
                pass
        return shm

    def get(self, ep: Endpoint, local, remote_key: dict) -> None:
        dst = _as_u8(local)
        n = min(len(dst), remote_key["nbytes"])
        shm = self._rma_attach(remote_key["seg"])
        np.copyto(dst[:n], np.frombuffer(shm.buf, np.uint8, count=n))

    def put(self, ep: Endpoint, local, remote_key: dict) -> None:
        src = _as_u8(local)
        n = min(len(src), remote_key["nbytes"])
        shm = self._rma_attach(remote_key["seg"])
        np.copyto(np.frombuffer(shm.buf, np.uint8, count=n), src[:n])

    def close(self) -> None:
        if self._db_rx is not None:
            if self._db_reactor:
                from ompi_tpu_torch.runtime import reactor as reactor_mod

                reactor_mod.remove(self._db_rx.fileno())
                self._db_reactor = False
            else:
                from ompi_tpu_torch.runtime import progress as progress_mod

                progress_mod.unregister_waiter(self._db_rx)
            try:
                self._db_rx.close()
            except OSError:
                pass
            self._db_rx = None
        if self._db_tx is not None:
            try:
                self._db_tx.close()
            except OSError:
                pass
            self._db_tx = None
        for ring in self._rings_out.values():
            try:
                ring.close(unlink=False)
            except Exception:
                pass
        for ring in self._rings_in.values():
            try:
                ring.close(unlink=True)
            except Exception:
                pass
        self._rings_in.clear()
        self._rings_out.clear()
        self._pending.clear()
        with self._rma_lock:
            attached = list(self._attached.values())
            segs = list(self._exposed.values()) + [
                s for pool in self._rma_pool.values() for s in pool]
            self._attached.clear()
            self._exposed.clear()
            self._rma_pool.clear()
        for shm in attached:
            try:
                shm.close()
            except (OSError, BufferError):
                pass
        for shm in segs:
            try:
                shm.close()
                shm.unlink()
            except (OSError, BufferError):
                pass
        self._rte = None


COMPONENT = SmBtl()
