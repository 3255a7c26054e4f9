"""Coordination service — the PMIx/PRRTE-equivalent wire-up server.

Copy of ``ompi_tpu/rte/coord.py`` (the role OpenPMIx plays for the
reference: ``PMIx_Init`` at ``ompi/runtime/ompi_rte.c:568``, the
``PMIx_Fence`` modex at ``ompi_mpi_init.c:682-701``): a small TCP server
owned by the launcher (``tpurun``) with the job's KV space (modex), fences
and pub/sub events.  Protocol: length-prefixed pickle frames (trusted
within one job, like PMIx's unix-socket wire protocol).

The client reconnects and retries: every request carries an idempotent id
(client uuid + monotonic rid); on a connection error the client redials
with exponential backoff and jitter and retries the SAME request, and the
server keeps a small per-client replay cache — a request whose processing
completed before the reset is answered from the cache, one still in
flight is adopted — so a fence interrupted mid-RPC is applied exactly
once.  Timeouts are MCA vars (``otpu_coord_*``).  The ``ping`` op answers
with the server's wall clock (``CoordClient.server_time``, the exchange
the trace exporter's clock offset reads) and ``CoordServer.collect``
gathers one key's per-rank values for the launcher's merges.  Not copied:
spawn and process sets (with dpm, ROADMAP A 4), the recovery scope of
ULFM, the chaos hooks and the flight-recorder views.
"""
from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Optional

from ompi_tpu_torch.base.var import VarType, registry

_LEN = struct.Struct("!I")

_connect_timeout_var = registry.register(
    "coord", None, "connect_timeout", vtype=VarType.FLOAT, default=120.0,
    help="Seconds a rank waits dialing (or re-dialing) the coordination "
         "service before the attempt counts as failed")
_rpc_timeout_var = registry.register(
    "coord", None, "rpc_timeout", vtype=VarType.FLOAT, default=120.0,
    help="Socket-level ceiling on one coordination RPC (fences block "
         "server-side, so this bounds how long a rank may sit inside "
         "one); expiry is a loud show_help error naming rank and op")
_get_timeout_var = registry.register(
    "coord", None, "get_timeout", vtype=VarType.FLOAT, default=60.0,
    help="Default server-side wait for a blocking KV get (modex key "
         "not yet published)")
_final_timeout_var = registry.register(
    "coord", None, "final_timeout", vtype=VarType.FLOAT, default=10.0,
    help="Timeout of the one-shot finalize fence's dedicated "
         "connection — a peer that exited without fencing costs at "
         "most this long")
_retry_max_var = registry.register(
    "coord", None, "retry_max", vtype=VarType.INT, default=8,
    help="Reconnect-and-retry attempts after a connection error before "
         "the RPC fails loudly (0 disables the retry)")
_backoff_var = registry.register(
    "coord", None, "retry_backoff", vtype=VarType.FLOAT, default=0.05,
    help="Base of the reconnect exponential backoff in seconds "
         "(doubled per attempt, jittered, capped at 2s)")


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Any:
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("coordination peer closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            raise ConnectionError("coordination peer closed")
        buf += chunk
    return pickle.loads(bytes(buf))


class CoordServer:
    """Job-wide KV + fence + event service (runs inside the launcher).

    Replies are sent by the serving thread, never while a service
    condition is held: one slow-reading client must not stall every
    fence, KV or event operation job-wide."""

    #: replay-cache depth per client: the client serializes requests, so
    #: only the newest rid can be retried — a couple of spares absorb
    #: the abandoned-timeout-then-reset corner without unbounded growth
    _REPLAY_DEPTH = 4

    def __init__(self, nprocs: int, host: str = "127.0.0.1", port: int = 0):
        self.nprocs = nprocs
        self._kv: dict[tuple, Any] = {}
        self._kv_cond = threading.Condition()
        self._fence_ranks: dict[str, set] = {}
        self._fence_gen: dict[str, int] = {}
        self._fence_expect: dict[str, tuple] = {}
        self._fence_done: set[str] = set()
        self._fence_cond = threading.Condition()
        self._events: list[tuple[int, str, Any]] = []
        self._event_seq = 0
        self._event_cond = threading.Condition()
        self._aborted: Optional[int] = None
        # idempotent-retry replay cache: client uuid -> {rid: response}.
        # A retried rid already processed is answered from here; one
        # still being processed is adopted (the retry thread waits for
        # the original's stored result instead of re-applying the op).
        self._rpc_cache: "OrderedDict[str, OrderedDict]" = OrderedDict()
        self._inflight: dict[str, int] = {}
        self._rpc_cond = threading.Condition()
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._accepting = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    # -- server internals ------------------------------------------------
    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._conns_lock:
                if not self._accepting:
                    # raced shutdown: a connection accepted while close()
                    # ran must not be left alive past it
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            self._serve_loop(conn)
        finally:
            with self._conns_lock:
                try:
                    self._conns.remove(conn)   # prune on disconnect
                except ValueError:
                    pass

    def _serve_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                req = _recv_frame(conn)
                cid = req.get("_cid")
                rid = req.get("_rid")
                if cid is not None and rid is not None:
                    resp = self._replay_or_claim(cid, rid)
                    if resp is None:
                        try:
                            resp = self._handle(req)
                        except Exception as exc:
                            # a malformed request must not strand its
                            # in-flight claim (a retry would spin on it
                            # forever): store a loud error response
                            resp = {"ok": False,
                                    "error": f"server error: {exc!r}"}
                        self._store_reply(cid, rid, resp)
                else:
                    # anonymous request: process directly
                    resp = self._handle(req)
                _send_frame(conn, resp)
        except (ConnectionError, OSError):
            return

    def _replay_or_claim(self, cid: str, rid: int) -> Optional[dict]:
        """Duplicate-safe entry: a cached rid replays its stored
        response; an in-flight rid is adopted (wait for the original
        thread's result); a fresh rid is claimed for processing
        (returns None)."""
        with self._rpc_cond:
            while True:
                cached = self._rpc_cache.get(cid)
                if cached is not None and rid in cached:
                    return cached[rid]
                if self._inflight.get(cid) != rid:
                    self._inflight[cid] = rid
                    return None
                self._rpc_cond.wait(0.5)

    def _store_reply(self, cid: str, rid: int, resp: dict) -> None:
        with self._rpc_cond:
            cache = self._rpc_cache.get(cid)
            if cache is None:
                cache = self._rpc_cache[cid] = OrderedDict()
            cache[rid] = resp
            while len(cache) > self._REPLAY_DEPTH:
                cache.popitem(last=False)
            if self._inflight.get(cid) == rid:
                del self._inflight[cid]
            # bound the per-client table count too (dead clients)
            self._rpc_cache.move_to_end(cid)
            while len(self._rpc_cache) > 4096:
                self._rpc_cache.popitem(last=False)
            self._rpc_cond.notify_all()

    def _handle(self, req: dict) -> dict:
        """Process one request; returns the response frame."""
        op = req["op"]
        if op == "put":
            with self._kv_cond:
                self._kv[(req["rank"], req["key"])] = req["value"]
                self._kv_cond.notify_all()
            return {"ok": True}
        if op == "put_new":
            # atomic put-if-absent: first writer wins, everyone gets
            # the winning value back
            with self._kv_cond:
                k = (req["rank"], req["key"])
                if k not in self._kv:
                    self._kv[k] = req["value"]
                    self._kv_cond.notify_all()
                val = self._kv[k]
            return {"ok": True, "value": val}
        if op == "fetch_add":
            # atomic counter: returns the PRE-add value, like
            # MPI_Fetch_and_op SUM
            with self._kv_cond:
                k = (req["rank"], req["key"])
                old = self._kv.get(k, 0)
                self._kv[k] = old + req["delta"]
                self._kv_cond.notify_all()
            return {"ok": True, "value": old}
        if op == "get":
            deadline = time.monotonic() + req.get("timeout", 60.0)
            with self._kv_cond:
                while (req["rank"], req["key"]) not in self._kv:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not req.get("wait", True):
                        break
                    self._kv_cond.wait(min(remaining, 1.0))
                val = self._kv.get((req["rank"], req["key"]))
            return {"ok": True, "value": val}
        if op == "fence":
            fid = req["id"]
            with self._fence_cond:
                if req.get("expect") is not None:
                    self._fence_expect.setdefault(fid, tuple(req["expect"]))
                oneshot = bool(req.get("oneshot"))
                # a late arrival to a completed one-shot round passes
                if not (oneshot and fid in self._fence_done):
                    arrived = self._fence_ranks.setdefault(fid, set())
                    arrived.add(req.get("rank", -1))
                    if self._fence_satisfied(fid):
                        self._complete_fence_locked(fid, oneshot)
                    else:
                        gen = self._fence_gen.get(fid, 0)
                        while self._fence_gen.get(fid, 0) == gen:
                            self._fence_cond.wait(1.0)
                            if self._aborted is not None:
                                break
            return {"ok": True}
        if op == "event_pub":
            self.publish(req["name"], req["payload"])
            return {"ok": True}
        if op == "event_poll":
            since = req["since"]
            with self._event_cond:
                out = [e for e in self._events if e[0] > since]
            return {"ok": True, "events": out}
        if op == "abort":
            self._aborted = req.get("code", 1)
            with self._fence_cond:
                self._fence_cond.notify_all()
            return {"ok": True}
        if op == "ping":
            # "time" is the server's wall clock: ranks estimate their
            # offset to it (min-RTT, the mpisync estimator) so per-rank
            # trace timelines share one timebase
            return {"ok": True, "nprocs": self.nprocs,
                    "aborted": self._aborted, "time": time.time()}
        return {"ok": False, "error": f"bad op {op}"}

    def _fence_satisfied(self, fid: str) -> bool:
        # caller holds _fence_cond
        arrived = self._fence_ranks.get(fid, set())
        expected = self._fence_expect.get(fid, range(self.nprocs))
        return all(r in arrived for r in expected)

    def _complete_fence_locked(self, fid: str, oneshot: bool = False) -> None:
        # caller holds _fence_cond.  One-shot fences (finalize) record
        # completion permanently; normal fences keep per-round generations
        # so re-used ids (runtime re-init) still synchronise.
        if oneshot:
            self._fence_done.add(fid)
        self._fence_ranks[fid] = set()
        self._fence_gen[fid] = self._fence_gen.get(fid, 0) + 1
        self._fence_cond.notify_all()

    def kv_put(self, rank: int, key: str, value: Any) -> None:
        """Launcher-side KV injection."""
        with self._kv_cond:
            self._kv[(rank, key)] = value
            self._kv_cond.notify_all()

    def publish(self, name: str, payload: Any) -> None:
        """Server-side event injection."""
        with self._event_cond:
            self._event_seq += 1
            self._events.append((self._event_seq, name, payload))
            self._event_cond.notify_all()

    def collect(self, key: str) -> dict:
        """{rank: value} of every KV entry published under ``key``: the
        launcher-side gather of per-rank payloads (trace timelines, the
        monitoring matrices)."""
        with self._kv_cond:
            return {r: v for (r, k), v in self._kv.items() if k == key}

    @property
    def aborted(self) -> Optional[int]:
        return self._aborted

    def close(self) -> None:
        """Full stop: the listener AND every live client connection."""
        with self._conns_lock:
            self._accepting = False       # no new conns past this point
            conns = list(self._conns)
            self._conns.clear()
        try:
            self._srv.close()
        except OSError:
            pass
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


class CoordClient:
    """Per-process client (the PMIx client analog) with idempotent
    reconnect-retry (see module docstring).

    ``retries``: reconnect attempts after a connection error; None takes
    ``otpu_coord_retry_max``.  The finalize fence's throwaway connection
    passes 0.
    """

    def __init__(self, addr: Optional[tuple] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None):
        if addr is None:
            spec = os.environ["OTPU_COORD"]
            host, port = spec.rsplit(":", 1)
            addr = (host, int(port))
        self._addr = (addr[0], int(addr[1]))
        # an explicit timeout overrides BOTH the connect and RPC vars
        # (fence_final's throwaway short-timeout connection)
        self._connect_timeout = (float(timeout) if timeout is not None
                                 else float(_connect_timeout_var.value))
        self._rpc_timeout = (float(timeout) if timeout is not None
                             else float(_rpc_timeout_var.value))
        self._retry_max = (int(retries) if retries is not None
                           else int(_retry_max_var.value or 0))
        self._backoff = float(_backoff_var.value or 0.05)
        self._rank_label = os.environ.get("OTPU_RANK", "?")
        self._jitter = random.Random(f"coord-jitter:{self._rank_label}")
        self._cid = uuid.uuid4().hex      # idempotent-retry identity
        self._rid = 0
        self._closed = False
        self._sock: Optional[socket.socket] = self._dial()
        self._lock = threading.Lock()
        self._event_since = 0

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout)
        sock.settimeout(self._rpc_timeout)
        return sock

    def _rpc(self, **req) -> dict:
        with self._lock:
            self._rid += 1
            req["_cid"] = self._cid
            req["_rid"] = self._rid
            resp = self._rpc_locked(req)
        if not resp.get("ok"):
            raise RuntimeError(f"coordination error: {resp.get('error')}")
        return resp

    def _rpc_locked(self, req: dict) -> dict:
        """One idempotent RPC round: send, then receive; connection errors
        reconnect with exponential backoff + jitter and retry the SAME
        request (the server's replay cache makes the retry
        duplicate-safe)."""
        from ompi_tpu_torch.base.output import show_help
        from ompi_tpu_torch.runtime import spc

        op = str(req.get("op"))
        attempts = 0
        while True:
            dialing = self._sock is None
            try:
                if dialing:
                    # reconnect: dial failures (refused, connect timeout)
                    # take the backoff ladder below, never the rpc-timeout
                    # path — the server may be restarting
                    self._sock = self._dial()
                    spc.record("coord_reconnects")
                    dialing = False
                _send_frame(self._sock, req)
                return _recv_frame(self._sock)
            except TimeoutError:
                if not dialing:
                    # close first: the server's handler may still be inside
                    # the op, and a later RPC must not read its stale reply
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                    # a fence that never finished is a PEER problem (a
                    # rank it waits on hung): loud, never retried.  Any
                    # other op is instantaneous server-side, so expiry
                    # means an overloaded coord: retry within the ladder
                    if op == "fence" or attempts >= self._retry_max:
                        show_help("help-coord", "rpc-timeout",
                                  rank=self._rank_label, op=op,
                                  seconds=self._rpc_timeout)
                        raise RuntimeError(
                            f"coordination RPC {op!r} timed out after "
                            f"{self._rpc_timeout:g}s at rank "
                            f"{self._rank_label} (otpu_coord_rpc_timeout)")
                self._retry_or_raise(op, attempts)
                attempts += 1
            except (ConnectionError, OSError):
                self._retry_or_raise(op, attempts)
                attempts += 1

    def _retry_or_raise(self, op: str, attempts: int) -> None:
        """Connection-error path: close, back off (exponential +
        deterministic jitter), let the caller retry — or fail loudly once
        ``otpu_coord_retry_max`` attempts are spent."""
        from ompi_tpu_torch.base.output import show_help
        from ompi_tpu_torch.runtime import spc

        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        if self._closed or attempts >= self._retry_max:
            if self._retry_max > 0 and not self._closed:
                show_help("help-coord", "reconnect-failed",
                          rank=self._rank_label, op=op,
                          attempts=attempts)
            raise
        spc.record("coord_rpc_retries")
        delay = min(self._backoff * (1 << attempts), 2.0)
        time.sleep(delay * (0.5 + self._jitter.random()))

    def put(self, rank: int, key: str, value: Any) -> None:
        self._rpc(op="put", rank=rank, key=key, value=value)

    def put_new(self, rank: int, key: str, value: Any) -> Any:
        """Atomic put-if-absent; returns the winning (stored) value."""
        return self._rpc(op="put_new", rank=rank, key=key,
                         value=value)["value"]

    def fetch_add(self, rank: int, key: str, delta: int) -> int:
        """Atomic fetch-and-add on a coord counter; returns the old value."""
        return self._rpc(op="fetch_add", rank=rank, key=key,
                         delta=delta)["value"]

    def get(self, rank: int, key: str, wait: bool = True,
            timeout: Optional[float] = None) -> Any:
        if timeout is None:
            timeout = float(_get_timeout_var.value)
        return self._rpc(op="get", rank=rank, key=key, wait=wait,
                         timeout=timeout)["value"]

    def fence(self, fence_id: str, *, rank: int, expect=None) -> None:
        """Enter a named fence as ``rank`` (mandatory: the server's
        completion rule is per-rank arrival)."""
        if rank < 0:
            raise ValueError("fence requires the caller's world rank")
        self._rpc(op="fence", id=fence_id, rank=rank, expect=expect)

    def fence_oneshot(self, fence_id: str, *, rank: int,
                      expect=None) -> None:
        """A fence whose completion is remembered: a rank arriving after
        the round completed passes instead of waiting for ranks that
        already left (the finalize fence)."""
        if rank < 0:
            raise ValueError("fence requires the caller's world rank")
        self._rpc(op="fence", id=fence_id, rank=rank, expect=expect,
                  oneshot=True)

    def event_publish(self, name: str, payload: Any) -> None:
        self._rpc(op="event_pub", name=name, payload=payload)

    def event_poll(self) -> list[tuple[int, str, Any]]:
        resp = self._rpc(op="event_poll", since=self._event_since)
        events = resp["events"]
        if events:
            self._event_since = events[-1][0]
        return events

    def server_time(self) -> float:
        """The coord server's wall clock (one ping round trip): the
        exchange ``mpisync.estimate_offset`` aligns trace clocks with."""
        return float(self._rpc(op="ping")["time"])

    def abort(self, code: int = 1) -> None:
        self._rpc(op="abort", code=code)

    def close(self) -> None:
        self._closed = True      # no reconnect ladder during teardown
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass


from ompi_tpu_torch.base.output import register_help as _rh

_rh("help-coord", "rpc-timeout",
    "Coordination RPC {op!r} at rank {rank} expired after {seconds}s "
    "(otpu_coord_rpc_timeout).  The coordination service is alive but "
    "the operation never completed — a peer this fence/get waits on is "
    "probably hung.")
_rh("help-coord", "reconnect-failed",
    "Rank {rank} lost its coordination-service connection during "
    "{op!r} and could not re-establish it after {attempts} "
    "reconnect attempt(s) (otpu_coord_retry_max).  The launcher (and "
    "its coordination service) is gone; out-of-band operations cannot "
    "continue.")
