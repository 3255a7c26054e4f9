"""osc/pt2pt — active-message RMA over the p2p engine.

Copy of ``ompi_tpu/mca/osc/pt2pt.py`` (a redesign of the reference's
``ompi/mca/osc/rdma/`` active-message fallback, ``osc_rdma_accumulate.c:26-71``):
every process runs one *exposure agent* thread per window, serving
PUT/GET/ACC/GACC/CAS requests and the passive-target lock protocol on the
window's private communicator over pml/ob1.  The agent gives true
passive-target progress, where the reference's target progresses only
inside the library.  Completion leans on ob1's per-(source, tag) ordering:
the requests of one origin are applied in issue order, so a FLUSH round
trip implies that every earlier op of that origin is target-complete.

Protocol (all on the window's dup'd comm; the reference's tags):
  REQ_TAG:    pickled request dicts origin -> target (fire-and-forget for
              PUT/ACC; round trip for GET/GACC/CAS/LOCK/FLUSH via a
              per-request reply tag)
  reply tags: REPLY_BASE - seq, unique per outstanding request per origin

It serves windows whose ranks are not all on one node (osc/rdma serves
those) or when osc/rdma is excluded (``--mca osc ^rdma``).
"""
from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.status import ANY_SOURCE
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType

REQ_TAG = -(1 << 22)
REPLY_BASE = -(1 << 22) - 16
_REPLY_SPACE = 1 << 20


# Request wire format: ONE self-sized message (pickle bytes), so the
# agent never blocks on a second recv from an origin that died between
# sends — the exact failure window ULFM recovery mode opens.  The matched
# size comes from the improbe status.  Replies keep the
# send_obj/recv_obj two-part format (origin-side, actively waited).
def _send_req(comm, dest: int, req: dict) -> None:
    comm.send(np.frombuffer(pickle.dumps(req), np.uint8), dest, REQ_TAG)


def _send_reply(comm, dest: int, tag: int, obj) -> None:
    comm.send_obj(obj, dest, tag)


def _recv_reply(comm, source: int, tag: int):
    return comm.recv_obj(source, tag)


class _LockState:
    """Per-window target-side reader/writer lock with FIFO fairness."""

    def __init__(self) -> None:
        self.mode: Optional[str] = None  # None | "exclusive" | "shared"
        self.holders: set[int] = set()
        self.queue: deque = deque()      # (origin, reply_tag, lock_type)

    def try_grant(self, origin: int, reply_tag: int, lock_type: str) -> bool:
        if self.mode is None:
            self.mode = lock_type
            self.holders.add(origin)
            return True
        if self.mode == "shared" and lock_type == "shared" and not self.queue:
            # no writer waiting: shared locks pile in (FIFO fairness:
            # a queued exclusive blocks later shared acquisitions)
            self.holders.add(origin)
            return True
        self.queue.append((origin, reply_tag, lock_type))
        return False

    def release(self, origin: int) -> list[tuple[int, int]]:
        """Drop ``origin``'s hold; return [(origin, reply_tag)] to grant."""
        self.holders.discard(origin)
        granted = []
        if self.holders:
            return granted
        self.mode = None
        while self.queue:
            o, rt, lt = self.queue[0]
            if self.mode is None:
                self.mode = lt
                self.holders.add(o)
                granted.append((o, rt))
                self.queue.popleft()
            elif self.mode == "shared" and lt == "shared":
                self.holders.add(o)
                granted.append((o, rt))
                self.queue.popleft()
            else:
                break
        return granted


class Pt2ptModule:
    """One module instance per window (state is per-window)."""

    def __init__(self) -> None:
        self._seq = 0
        self._lock = threading.Lock()
        self._agent: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # target-side state
        self._locks = _LockState()
        self._posts: set[int] = set()          # PSCW: who posted to me
        self._completes: set[int] = set()      # PSCW: who completed to me
        self._pscw_cond = threading.Condition()
        self._start_group: Optional[list] = None

    # -- lifecycle -------------------------------------------------------
    def attach(self, win) -> None:
        self._win = win
        self._agent = threading.Thread(
            target=self._serve, args=(win,),
            name=f"otpu-osc-{win.name}", daemon=True)
        self._agent.start()

    def detach(self, win) -> None:
        self._stop.set()
        if self._agent is not None:
            self._agent.join(timeout=10)

    def _next_reply_tag(self) -> int:
        with self._lock:
            self._seq += 1
            return REPLY_BASE - (self._seq % _REPLY_SPACE)

    # -- origin side -----------------------------------------------------
    def put(self, win, arr, target: int, offset: int) -> None:
        _send_req(win.comm, target,
                  {"kind": "put", "off": offset, "data": arr})

    # -- dynamic-window region RMA (MPI_Win_create_dynamic + attach) -----
    def put_region(self, win, arr, target: int, offset: int,
                   region: int) -> None:
        _send_req(win.comm, target,
                  {"kind": "put", "off": offset, "data": arr,
                   "region": region})

    def get_region(self, win, count: int, target: int, offset: int,
                   region: int) -> np.ndarray:
        rt = self._next_reply_tag()
        _send_req(win.comm, target,
                  {"kind": "get", "off": offset, "count": count, "rt": rt,
                   "region": region})
        out = _recv_reply(win.comm, target, rt)
        if isinstance(out, dict) and out.get("err"):
            raise MpiError(ErrorClass.ERR_RMA_CONFLICT,
                           f"region {region} on rank {target}: {out['err']}")
        return out

    def get(self, win, count: int, target: int, offset: int) -> np.ndarray:
        rt = self._next_reply_tag()
        _send_req(win.comm, target,
                  {"kind": "get", "off": offset, "count": count, "rt": rt})
        return _recv_reply(win.comm, target, rt)

    def accumulate(self, win, arr, target: int, offset: int, op) -> None:
        _send_req(win.comm, target,
                  {"kind": "acc", "off": offset, "data": arr, "op": op.name})

    def get_accumulate(self, win, arr, target: int, offset: int,
                       op) -> np.ndarray:
        rt = self._next_reply_tag()
        _send_req(win.comm, target,
                  {"kind": "gacc", "off": offset, "data": arr,
                   "op": op.name, "rt": rt})
        return _recv_reply(win.comm, target, rt)

    def compare_and_swap(self, win, value, compare, target: int, offset: int):
        rt = self._next_reply_tag()
        _send_req(win.comm, target,
                  {"kind": "cas", "off": offset, "value": value,
                   "compare": compare, "rt": rt})
        return _recv_reply(win.comm, target, rt)

    def flush(self, win, target: int) -> None:
        rt = self._next_reply_tag()
        _send_req(win.comm, target, {"kind": "flush", "rt": rt})
        _recv_reply(win.comm, target, rt)

    def fence(self, win) -> None:
        # close epoch: everything I issued is target-complete, then sync
        for t in range(win.size):
            self.flush(win, t)
        win.comm.barrier()

    def lock(self, win, target: int, lock_type: str) -> None:
        rt = self._next_reply_tag()
        _send_req(win.comm, target,
                  {"kind": "lock", "type": lock_type, "rt": rt})
        _recv_reply(win.comm, target, rt)  # blocks until granted

    def unlock(self, win, target: int) -> None:
        # flush-then-release in one round trip: the UNLOCK ack arrives
        # after all prior ops from this origin were applied (FIFO order)
        rt = self._next_reply_tag()
        _send_req(win.comm, target, {"kind": "unlock", "rt": rt})
        _recv_reply(win.comm, target, rt)

    # PSCW --------------------------------------------------------------
    def post(self, win, group) -> None:
        """Expose my window to the access group (MPI_Win_post)."""
        self._post_group = [win.comm.group.rank_of(r)
                            for r in group.world_ranks]
        for t in self._post_group:
            _send_req(win.comm, t, {"kind": "post"})

    def start(self, win, group) -> None:
        """Open an access epoch: wait for every target's post."""
        targets = [win.comm.group.rank_of(r) for r in group.world_ranks]
        self._start_group = targets
        with self._pscw_cond:
            while not all(t in self._posts for t in targets):
                self._pscw_cond.wait(0.05)
                if self._stop.is_set():
                    return
            for t in targets:
                self._posts.discard(t)

    def complete(self, win) -> None:
        """Close the access epoch (MPI_Win_complete)."""
        targets = self._start_group or []
        for t in targets:
            self.flush(win, t)
            _send_req(win.comm, t, {"kind": "complete"})
        self._start_group = None

    def wait(self, win) -> None:
        """Close the exposure epoch: wait for every access-group member's
        complete (MPI_Win_wait) — expressed over the one-copy
        ``pscw_test`` accounting."""
        while not self.pscw_test(win):
            with self._pscw_cond:
                self._pscw_cond.wait(0.05)
            if self._stop.is_set():
                return

    def pscw_test(self, win) -> bool:
        """Nonblocking ``wait`` (MPI_Win_test)."""
        starters = getattr(self, "_post_group", [])
        with self._pscw_cond:
            if not all(s in self._completes for s in starters):
                return False
            for s in starters:
                self._completes.discard(s)
        self._post_group = []
        return True

    # -- target side (the exposure agent) --------------------------------
    def _serve(self, win) -> None:
        from ompi_tpu_torch.runtime.progress import progress

        comm = win.comm
        while not self._stop.is_set():
            try:
                # the agent IS the passive-target progress thread: pump the
                # progress engine so transport frags reach the matching
                # engine even while the app thread is outside the library
                progress()
                ok, msg = comm.improbe(ANY_SOURCE, REQ_TAG)
            except Exception:
                return  # runtime finalizing under us
            if not ok:
                time.sleep(0.0005)
                continue
            try:
                # single self-sized message: recv of a matched frag cannot
                # block on further traffic from the (possibly dead) origin
                payload = np.zeros(msg.status._nbytes, dtype=np.uint8)
                st = msg.recv(payload)
                self._handle(win, st.source, pickle.loads(payload.tobytes()))
            except Exception:
                if self._stop.is_set():
                    return
                from ompi_tpu_torch.base import output as _o

                import traceback

                _o.output(0, 0, "osc agent error: %s",
                          traceback.format_exc(limit=3))

    def _handle(self, win, source: int, req: dict) -> None:
        kind = req["kind"]
        base = win.local
        if req.get("region") is not None:
            # dynamic window: resolve the attached region by handle.  A
            # detached/unknown handle is erroneous per MPI — gets reply
            # an error marker (origin raises ERR_RMA_RANGE); puts are
            # dropped rather than corrupting win.local
            base = win.regions.get(req["region"])
            if base is None:
                if kind == "get":
                    _send_reply(win.comm, source, req["rt"],
                                {"err": "region detached"})
                return
        if kind == "put":
            data = req["data"]
            base[req["off"]:req["off"] + data.size] = data
        elif kind == "get":
            out = np.array(
                base[req["off"]:req["off"] + req["count"]], copy=True)
            _send_reply(win.comm, source, req["rt"], out)
        elif kind == "acc":
            self._apply(base, req["off"], req["data"], req["op"],
                        win.byte_addressed)
        elif kind == "gacc":
            data = req["data"]
            if win.byte_addressed and data.dtype != base.dtype:
                old = np.array(base[req["off"]:req["off"] + data.nbytes]
                               .view(data.dtype), copy=True)
            else:
                old = np.array(
                    base[req["off"]:req["off"] + data.size], copy=True)
            self._apply(base, req["off"], data, req["op"],
                        win.byte_addressed)
            _send_reply(win.comm, source, req["rt"], old)
        elif kind == "cas":
            value = np.asarray(req["value"])
            if win.byte_addressed and value.dtype != base.dtype:
                # typed CAS on a byte-addressed heap window
                view = base[req["off"]:req["off"] + value.dtype.itemsize] \
                    .view(value.dtype)
                old = view[0]
                if old == req["compare"]:
                    view[0] = value
            else:
                old = base[req["off"]]
                if old == req["compare"]:
                    base[req["off"]] = req["value"]
            _send_reply(win.comm, source, req["rt"], old)
        elif kind == "flush":
            _send_reply(win.comm, source, req["rt"], True)
        elif kind == "lock":
            if self._locks.try_grant(source, req["rt"], req["type"]):
                _send_reply(win.comm, source, req["rt"], True)
        elif kind == "unlock":
            granted = self._locks.release(source)
            _send_reply(win.comm, source, req["rt"], True)
            for origin, rtag in granted:
                _send_reply(win.comm, origin, rtag, True)
        elif kind == "post":
            with self._pscw_cond:
                self._posts.add(source)
                self._pscw_cond.notify_all()
        elif kind == "complete":
            with self._pscw_cond:
                self._completes.add(source)
                self._pscw_cond.notify_all()
        else:
            raise MpiError(ErrorClass.ERR_RMA_SYNC,
                           f"unknown RMA request {kind!r}")

    @staticmethod
    def _apply(base: np.ndarray, off: int, data: np.ndarray,
               op_name: str, byte_addressed: bool = False) -> None:
        op = getattr(op_mod, op_name)
        if byte_addressed and data.dtype != base.dtype:
            # typed accumulate into a byte-addressed heap window: ``off``
            # is a byte offset and the view carries the origin type
            view = base[off:off + data.nbytes].view(data.dtype)
            op(data, view)
        else:
            view = base[off:off + data.size]
            op(data.astype(base.dtype, copy=False), view)


class Pt2ptComponent(Component):
    name = "pt2pt"
    priority = 50

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=50,
            help="Selection priority of osc/pt2pt")

    def win_query(self, win):
        if win.comm.rte is None or win.comm.rte.is_device_world:
            return None
        return self._prio.value, Pt2ptModule()


COMPONENT = Pt2ptComponent()
