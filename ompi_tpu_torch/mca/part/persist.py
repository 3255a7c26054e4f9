"""part/persist — partitioned requests over the pml (the default and, as
in the reference, only part component).

Copy of ``ompi_tpu/mca/part/persist.py`` (after the reference's
``ompi/mca/part/persist``): a partitioned send request owns a contiguous
user buffer split into P equal partitions; each ``Pready`` marks its
partition transferable and the component maps maximal contiguous ready runs
onto ordinary pml messages — one wire message may carry several app
partitions (aggregation var ``otpu_part_persist_min_partitions``, the
``part_persist_min_message_count`` analog), so N partitions travel as <= N
fragments.  Every wire message is byte-framed (epoch, byte offset, byte
length header), which is what lets a receiver partitioned differently from
the sender track ``Parrived`` exactly: arrival is counted in bytes against
the RECEIVER's partition boundaries, so mismatched send/recv partition
counts pair correctly as MPI-4 requires.

Partitioned buffers are C-contiguous numpy arrays, as in the reference: the
request keeps a live view, so data written between ``start()`` and
``Pready`` is what travels.  A tensor, on the card or not, has no such view
and fails the check with ``ERR_BUFFER``, as a ``jax.Array`` does there.

The receive side is driven by the progress engine: while a partitioned
recv is active it registers a progress callback that improbes the pml's
unexpected queue for wire-tagged messages and lands payloads straight into
the user buffer — no posted-receive window to size, no truncation.  Unlike
the reference's, the callback receives each message with ``irecv`` and
applies it at the receive's completion: the reference waits for the
message inside the callback, where progress does not recurse, so a
partition above the eager limit (a rendezvous) never arrives over btl/tcp
and the job hangs.  Epoch
numbers (one per start, both sides count starts) keep a restarted sender's
messages from being folded into the previous epoch; pml per-channel FIFO
ordering guarantees an epoch is drained in full before the next one's
messages are reachable, and anything probed early is stashed for the
matching start.

Revocation (ULFM), where the port goes further than the reference, as ob1
does (its pending requests complete with ``RevokedError``): an active
receive's drain completes the epoch with ``RevokedError`` at its next poll
and leaves the progress engine, and a ``Pready`` on a revoked comm
completes the send epoch with ``RevokedError`` and raises it, so neither
side's ``wait`` spins on a comm that will carry nothing more.  The
reference leaves both pending.

Wire tags live in the reserved internal space ``-(1 << 21) - tag`` (user
tags are capped below 2^20, keeping the space disjoint from the CID
agreement's ``-(1 << 20) - tag``, the intercomm bridge's ``-(1 << 22) -
tag``, the fault-tolerant agreement's ``-(1 << 23) - h`` and coll/basic's
``-16 - seq``).
"""
from __future__ import annotations

import bisect
import threading

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.request import Request, RequestState
from ompi_tpu_torch.api.status import ANY_SOURCE, PROC_NULL, Status
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.runtime import spc, trace

_WIRE_TAG_BASE = -(1 << 21)
_MAX_USER_TAG = 1 << 20
_HDR_BYTES = 24          # int64[3]: epoch, byte offset, byte length


def _wire_tag(tag: int) -> int:
    return _WIRE_TAG_BASE - tag


def _check_buffer(buf, partitions: int, writable: bool) -> np.ndarray:
    """Partitioned buffers must be contiguous ndarrays whose element
    count divides evenly into partitions (loud errors, no silent
    copies — the request keeps a live VIEW so data written between
    start() and Pready is what travels)."""
    if not isinstance(buf, np.ndarray) or not buf.flags.c_contiguous:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       "partitioned communication needs a C-contiguous "
                       "ndarray buffer")
    if writable and not buf.flags.writeable:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       "partitioned receive buffer must be writable")
    if not isinstance(partitions, (int, np.integer)) or partitions <= 0:
        raise MpiError(ErrorClass.ERR_ARG,
                       f"invalid partition count {partitions!r}")
    if buf.size % partitions:
        raise MpiError(
            ErrorClass.ERR_COUNT,
            f"buffer of {buf.size} elements does not divide into "
            f"{partitions} equal partitions")
    return buf


def _check_tag(tag: int) -> int:
    # wildcards are not supported in partitioned communication (MPI-4
    # §4.2) and negative tags would collide with internal tag spaces
    if not 0 <= int(tag) < _MAX_USER_TAG:
        raise MpiError(ErrorClass.ERR_TAG,
                       f"partitioned tag must be in [0, 2^20), got {tag}")
    return int(tag)


class PartRequest(Request):
    """Common partitioned-request state (one side of one pairing)."""

    side = "?"

    def __init__(self, module, comm, buf, partitions: int, peer: int,
                 tag: int, writable: bool) -> None:
        super().__init__(persistent=True)
        self._module = module
        self._comm = comm
        self._null = peer == PROC_NULL
        if not self._null:
            _check_buffer(buf, partitions, writable)
        elif not isinstance(partitions, (int, np.integer)) or \
                partitions <= 0:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"invalid partition count {partitions!r}")
        self._buf = buf
        self._bytes = (buf.reshape(-1).view(np.uint8)
                       if not self._null else np.empty(0, np.uint8))
        self.partitions = int(partitions)
        self.nbytes = 0 if self._null else buf.nbytes
        self._psize = self.nbytes // self.partitions
        self.peer = peer
        self.tag = _check_tag(tag)
        self._plock = threading.Lock()
        self._epoch = -1

    def _check_partition(self, p) -> int:
        if not isinstance(p, (int, np.integer)) or not \
                0 <= p < self.partitions:
            raise MpiError(
                ErrorClass.ERR_ARG,
                f"partition {p!r} out of range [0, {self.partitions})")
        return int(p)


class PsendRequest(PartRequest):
    """``MPI_Psend_init`` product: Pready marks partitions transferable;
    contiguous ready runs >= min_partitions flush as one pml message
    each (everything flushes once the last partition is readied)."""

    side = "send"

    def __init__(self, module, comm, buf, partitions, dest, tag):
        super().__init__(module, comm, buf, partitions, dest, tag,
                         writable=False)
        self._ready = np.zeros(self.partitions, bool)

    def _start(self) -> None:
        with self._plock:
            self._epoch += 1
            self._ready[:] = False
            self._nready = 0
            self._runs: list[list[int]] = []   # pending [lo, hi) ready runs
            self._inflight = 0
            self._flushed_all = False
            self._send_error = None
            # min_partitions is latched per epoch so a mid-epoch var
            # change cannot strand an already-deferred run
            self._minp = max(1, self._module.min_partitions())

    def pready(self, partition) -> None:
        # THE hot call of partitioned communication (one per gradient
        # bucket per step in the overlap pattern): flag checks, one
        # bitmap bit, a run merge — tracing costs one flag check when off
        spc.record("part_pready")
        t0 = trace.now() if trace.enabled else None
        if self.state is not RequestState.ACTIVE:
            raise MpiError(ErrorClass.ERR_REQUEST,
                           "Pready on an inactive partitioned request "
                           "(call start() first)")
        p = self._check_partition(partition)
        if self._comm.is_revoked():
            self._revoked()
        with self._plock:
            if self._ready[p]:
                raise MpiError(ErrorClass.ERR_ARG,
                               f"partition {p} was already marked ready "
                               "in this epoch")
            self._ready[p] = True
            self._nready += 1
            self._merge_run(p)
            force = self._nready == self.partitions
            out = self._pop_runs(force)
            if force:
                self._flushed_all = True
            self._inflight += len(out)
        for lo, hi in out:
            self._send_run(lo, hi)
        if force and not out:
            # everything already flushed by earlier preadys
            self._maybe_complete()
        if t0 is not None:
            trace.span("pready", "part", t0,
                       args={"partition": p, "nbytes": self._psize,
                             "cid": self._comm.cid})
            trace.hist_record("pready", self._psize, trace.now() - t0)

    def parrived(self, partition):
        raise MpiError(ErrorClass.ERR_REQUEST,
                       "Parrived on a partitioned SEND request (the "
                       "standard defines it for the receive side only)")

    def _revoked(self) -> None:
        """Complete the epoch with ``RevokedError`` and raise it."""
        from ompi_tpu_torch.api.errors import RevokedError

        err = RevokedError(f"{self._comm.name} revoked with a partitioned "
                           "send active")
        self.complete(err)
        raise err

    # -- run bookkeeping (under _plock) ----------------------------------
    def _merge_run(self, p: int) -> None:
        runs = self._runs
        i = bisect.bisect_left(runs, [p, p])
        # merge with predecessor ending at p and/or successor starting
        # at p+1 (runs are disjoint and sorted by lo)
        if i > 0 and runs[i - 1][1] == p:
            runs[i - 1][1] = p + 1
            if i < len(runs) and runs[i][0] == p + 1:
                runs[i - 1][1] = runs[i][1]
                runs.pop(i)
        elif i < len(runs) and runs[i][0] == p + 1:
            runs[i][0] = p
        else:
            runs.insert(i, [p, p + 1])

    def _pop_runs(self, force: bool) -> list:
        if force:
            out, self._runs = self._runs, []
            return out
        out = [r for r in self._runs if r[1] - r[0] >= self._minp]
        if out:
            self._runs = [r for r in self._runs if r[1] - r[0] < self._minp]
        return out

    # -- wire -------------------------------------------------------------
    def _send_run(self, lo: int, hi: int) -> None:
        if self._null:
            # nothing travels to PROC_NULL — and nothing may be counted:
            # the docs tell users to read part_msgs to verify aggregation
            with self._plock:
                self._inflight -= 1
            self._maybe_complete()
            return
        off = lo * self._psize
        ln = (hi - lo) * self._psize
        spc.record("part_msgs")
        spc.record("part_bytes", ln)
        msg = np.empty(_HDR_BYTES + ln, np.uint8)
        msg[:_HDR_BYTES] = np.array([self._epoch, off, ln],
                                    np.int64).view(np.uint8)
        msg[_HDR_BYTES:] = self._bytes[off:off + ln]
        try:
            inner = self._comm.pml.isend(self._comm, msg, self.peer,
                                         _wire_tag(self.tag))
        except MpiError as exc:
            with self._plock:
                self._inflight -= 1
                self._send_error = exc
            self._maybe_complete()
            raise
        inner.on_complete(self._inner_done)

    def _inner_done(self, inner) -> None:
        with self._plock:
            self._inflight -= 1
            if inner.error is not None:
                self._send_error = inner.error
        self._maybe_complete()

    def _maybe_complete(self) -> None:
        with self._plock:
            done = self._flushed_all and self._inflight == 0
            err = self._send_error
        if done:
            self.status._nbytes = self.nbytes
            self.complete(err)


class PrecvRequest(PartRequest):
    """``MPI_Precv_init`` product: a progress-engine callback drains
    wire-tagged messages from the pml and lands payload bytes straight
    into the user buffer; Parrived reads per-partition byte counts."""

    side = "recv"

    def __init__(self, module, comm, buf, partitions, source, tag):
        if source == ANY_SOURCE:
            raise MpiError(ErrorClass.ERR_ARG,
                           "partitioned communication does not support "
                           "MPI_ANY_SOURCE")
        super().__init__(module, comm, buf, partitions, source, tag,
                         writable=True)
        self._arrived = np.zeros(self.partitions, np.int64)
        self._registered = False
        if not self._null:
            grp = comm.remote_group if comm.is_inter else comm.group
            src_world = grp.world_rank(source)
            self._key = (comm.cid, comm.world_rank(comm.rank), src_world,
                         self.tag)
            # one outstanding partitioned pairing per (comm, peer, tag)
            # channel: a predecessor abandoned without free() must not
            # bleed its stashed future-epoch payloads into this request
            # (epoch counters restart per request)
            module.stash_clear(self._key)

    def _start(self) -> None:
        from ompi_tpu_torch.runtime import progress

        with self._plock:
            self._epoch += 1
            self._arrived[:] = 0
            self._total_arrived = 0
        if self._null:
            self.status = Status(source=PROC_NULL, tag=self.tag, _nbytes=0)
            self.complete()
            return
        if not self._registered:
            progress.register(self._poll)
            self._registered = True
        # messages probed ahead of this start (a fast sender's next
        # epoch) were stashed under our epoch number — land them now
        for off, payload in self._module.stash_pop(self._key, self._epoch):
            self._apply(off, payload)
        self._poll()

    def pready(self, partition) -> None:
        raise MpiError(ErrorClass.ERR_REQUEST,
                       "Pready on a partitioned RECEIVE request (the "
                       "standard defines it for the send side only)")

    def parrived(self, partition) -> bool:
        """``MPI_Parrived``: has partition ``partition`` fully arrived
        in the current epoch?  Polls the progress engine once on a miss
        (like test())."""
        spc.record("part_parrived")
        p = self._check_partition(partition)
        if self.persistent and self.state is RequestState.INACTIVE \
                and self._epoch < 0:
            raise MpiError(ErrorClass.ERR_REQUEST,
                           "Parrived on a never-started partitioned "
                           "request")
        if self._null or self.complete_flag:
            self._raise_if_error()
            return True
        if self._arrived[p] >= self._psize and self._psize > 0:
            return True
        from ompi_tpu_torch.runtime.progress import progress

        progress()
        self._raise_if_error()
        return bool(self._arrived[p] >= self._psize and self._psize > 0)

    # -- progress-engine drain -------------------------------------------
    def _poll(self) -> int:
        """Progress callback: drain wire messages for this request."""
        if self.complete_flag:
            return 0
        if self._comm.is_revoked():
            from ompi_tpu_torch.api.errors import RevokedError

            self._finish(RevokedError(f"{self._comm.name} revoked with a "
                                      "partitioned receive active"))
            return 1
        events = 0
        wtag = _wire_tag(self.tag)
        while not self.complete_flag:
            found, msg = self._comm.pml.mprobe(
                self._comm, self.peer, wtag, blocking=False)
            if not found:
                break
            buf = np.empty(msg.status._nbytes, np.uint8)
            events += 1
            # a rendezvous-sized message's payload arrives through the
            # pml's own progress: the receive must not wait here, inside
            # a progress callback (progress does not recurse)
            msg.irecv(buf).on_complete(
                lambda req, buf=buf: self._land(req, buf))
        return events

    def _land(self, req, buf: np.ndarray) -> None:
        """A wire message's receive completed: apply it to the current
        epoch, or stash it for the start it belongs to."""
        if req.error is not None:
            if not self.complete_flag:
                self._finish(req.error)
            return
        if len(buf) < _HDR_BYTES:
            self._finish(MpiError(ErrorClass.ERR_INTERN,
                                  "short partitioned wire message"))
            return
        epoch, off, ln = (int(v) for v in buf[:_HDR_BYTES].view(np.int64))
        payload = buf[_HDR_BYTES:_HDR_BYTES + ln]
        if epoch != self._epoch:
            # pml FIFO means only a FUTURE epoch can show up here (the
            # sender restarted); hold it for the matching start
            self._module.stash_put(self._key, epoch, (off, payload))
            return
        self._apply(off, payload)

    def _apply(self, off: int, payload: np.ndarray) -> None:
        ln = len(payload)
        if off + ln > self.nbytes:
            self._finish(MpiError(
                ErrorClass.ERR_TRUNCATE,
                f"partitioned message [{off}, {off + ln}) overruns the "
                f"{self.nbytes}-byte receive buffer (mismatched total "
                "counts)"))
            return
        t0 = trace.now() if trace.enabled else None
        with self._plock:
            self._bytes[off:off + ln] = payload
            if self._psize > 0 and ln > 0:
                p0 = off // self._psize
                p1 = (off + ln - 1) // self._psize
                for p in range(p0, p1 + 1):
                    seg = (min(off + ln, (p + 1) * self._psize)
                           - max(off, p * self._psize))
                    self._arrived[p] += seg
            self._total_arrived += ln
            done = self._total_arrived >= self.nbytes
        spc.record("part_bytes", ln)
        if t0 is not None:
            trace.span("part_arrive", "part", t0,
                       args={"nbytes": ln, "offset": off,
                             "cid": self._comm.cid})
        if done:
            self._finish(None)

    def _finish(self, error) -> None:
        self.status = Status(source=self.peer, tag=self.tag,
                             _nbytes=self._total_arrived)
        self._unregister()
        self.complete(error)

    def _unregister(self) -> None:
        # the drain callback lives only while an epoch is in flight —
        # a comm full of idle partitioned requests must not tax the
        # progress loop
        if self._registered:
            from ompi_tpu_torch.runtime import progress

            progress.unregister(self._poll)
            self._registered = False

    def free(self) -> None:
        self._unregister()
        if not self._null:
            # stale future-epoch payloads must not leak (nor surface in
            # a later request that reuses this (cid, peer, tag) channel)
            self._module.stash_clear(self._key)
        super().free()


class PartPersistModule:
    """One per process (like the pml module): builds partitioned
    requests and holds the cross-epoch message stash."""

    def __init__(self, component: "PartPersistComponent") -> None:
        self.component = component
        self._stash: dict = {}
        self._lock = threading.Lock()

    def min_partitions(self) -> int:
        var = getattr(self.component, "_minp_var", None)
        return int(var.value) if var is not None else 1

    def psend_init(self, comm, buf, partitions, dest, tag) -> PsendRequest:
        return PsendRequest(self, comm, buf, partitions, dest, tag)

    def precv_init(self, comm, buf, partitions, source,
                   tag) -> PrecvRequest:
        return PrecvRequest(self, comm, buf, partitions, source, tag)

    def stash_put(self, key, epoch: int, item) -> None:
        with self._lock:
            self._stash.setdefault(key, {}).setdefault(epoch, []).append(
                item)

    def stash_pop(self, key, epoch: int) -> list:
        with self._lock:
            per_key = self._stash.get(key)
            if not per_key:
                return []
            out = per_key.pop(epoch, [])
            if not per_key:
                self._stash.pop(key, None)
            return out

    def stash_clear(self, key) -> None:
        with self._lock:
            self._stash.pop(key, None)


class PartPersistComponent(Component):
    name = "persist"
    priority = 20

    def register_vars(self, fw) -> None:
        self.register_var("priority", vtype=VarType.INT, default=20,
                          help="Selection priority of part/persist")
        self._minp_var = self.register_var(
            "min_partitions", vtype=VarType.INT, default=1,
            help="Aggregation threshold: a contiguous run of ready "
                 "partitions is held until it spans at least this many "
                 "before travelling as one pml message (the final "
                 "Pready always flushes everything), so N app "
                 "partitions may ride fewer wire messages")

    def get_module(self) -> PartPersistModule:
        mod = getattr(self, "_module", None)
        if mod is None:
            mod = self._module = PartPersistModule(self)
        return mod

    def close(self) -> None:
        # the stash is keyed by (cid, ranks, tag): a re-init reuses CIDs,
        # so stale entries must not leak across runtime lifetimes
        self._module = None


COMPONENT = PartPersistComponent()
