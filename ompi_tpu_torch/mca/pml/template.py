"""pml/template — the teaching skeleton for new messaging engines.

The port's copy of the JAX package's pml/template, itself a re-design
of Open MPI's ``ompi/mca/pml/example/`` (the commented stub pml that documents the pml contract without ever being selected):
a minimal but RUNNABLE pml showing exactly what a messaging layer must
provide — the five-method surface ``ompi_mpi_init`` drives
(``add_comm``/``del_comm``/``isend``/``irecv``/``finalize``) plus the
matching rule (communicator, source, tag, arrival order) — so a new
engine (e.g. a matching-offload path or a device-initiated pml) starts
from a working example instead of ob1's full protocol machinery.

What ob1 adds beyond this skeleton, in the order a real engine usually
grows them: eager vs rendezvous protocol selection from btl limits,
unexpected + out-of-order queues keyed by (cid, src) sequence numbers,
RGET receiver-pull for large transfers, probe/mprobe, cancel, multi-
rail striping, PERUSE events.  See ``ob1.py`` for each.

Disabled by default (priority -1, like the reference's example which
is never built into selection); ``--mca pml_template_enable 1`` turns
it into a working single-process loopback pml so framework-level tests
can drive the selection path end-to-end.
"""
from __future__ import annotations

import threading
from collections import deque

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType


class _Status:
    __slots__ = ("source", "tag", "count", "cancelled")

    def __init__(self, source: int, tag: int, count: int) -> None:
        self.source = source
        self.tag = tag
        self.count = count
        self.cancelled = False

    MPI_SOURCE = property(lambda s: s.source)
    MPI_TAG = property(lambda s: s.tag)


class _ImmediateRequest:
    """The smallest request object the api layer accepts: test/wait.

    A real pml returns requests that complete from the progress engine;
    the loopback completes everything eagerly, which is exactly the
    simplification a skeleton may make (the reference example pml stubs
    its requests the same way)."""

    def __init__(self, status=None):
        self.status = status
        self.complete = True

    def test(self):
        return True, self.status

    def wait(self):
        return self.status

    def cancel(self) -> bool:
        return False

    def free(self) -> None:
        pass


class TemplatePml:
    """1. lifecycle: the runtime calls ``add_comm`` for every new
    communicator and ``finalize`` at teardown.  State here is one
    matching queue per cid — the minimum that honors MPI ordering."""

    def __init__(self, component: "TemplateComponent", rte) -> None:
        self.component = component
        self.rte = rte
        self._lock = threading.Lock()
        self._queues: dict[int, deque] = {}   # cid -> pending frags

    def add_comm(self, comm) -> None:
        with self._lock:
            self._queues.setdefault(comm.cid, deque())

    def del_comm(self, comm) -> None:
        with self._lock:
            self._queues.pop(comm.cid, None)

    def finalize(self) -> None:
        with self._lock:
            self._queues.clear()

    # 2. sending: a real pml resolves the peer through bml/btl and
    #    picks eager/rndv/RGET from the size; the loopback only ever
    #    reaches self-rank, so "the wire" is the local queue.
    def isend(self, comm, buf, dest: int, tag: int, mode: str = "standard"):
        if dest != comm.rank:
            raise RuntimeError(
                "pml/template is a loopback skeleton: it reaches only "
                "the local rank (enable pml/ob1 for real transport)")
        import numpy as np

        payload = np.array(buf, copy=True)
        with self._lock:
            self._queues[comm.cid].append((comm.rank, tag, payload))
        return _ImmediateRequest()

    def send(self, comm, buf, dest: int, tag: int) -> None:
        # MPI_Send IS isend + wait — the skeleton must model the
        # completion contract too, or a pml grown from it returns
        # before the data is safe and drops the request's error
        self.isend(comm, buf, dest, tag).wait()

    # 3. receiving + THE MATCHING RULE: first queued frag whose
    #    (source, tag) matches, wildcards allowed, arrival order
    #    breaking ties — the invariant every pml must keep
    #    (``pml.h:498`` recv semantics; ob1 spreads it over three
    #    queues, the skeleton over one).
    def irecv(self, comm, buf, source: int, tag: int):
        status = self.recv(comm, buf, source, tag)
        return _ImmediateRequest(status)

    def recv(self, comm, buf, source: int, tag: int):
        import numpy as np

        with self._lock:
            q = self._queues[comm.cid]
            for i, (src, t, payload) in enumerate(q):
                if source not in (-1, src):   # -1 = ANY_SOURCE
                    continue
                if tag not in (-1, t):        # -1 = ANY_TAG
                    continue
                del q[i]
                out = np.asarray(buf)
                flat = out.reshape(-1)
                flat[:payload.size] = payload.reshape(-1)[:flat.size]
                return _Status(src, t, payload.size)
        raise RuntimeError(
            "pml/template loopback has no matching frag queued "
            "(eager completion means sends must precede receives)")


class TemplateComponent(Component):
    name = "template"
    priority = -1      # never beats ob1; selection requires opt-in

    def register_vars(self, fw) -> None:
        self.register_var("priority", vtype=VarType.INT, default=-1,
                          help="Selection priority of pml/template "
                               "(negative: never auto-selected)")
        self._enable = self.register_var(
            "enable", vtype=VarType.BOOL, default=False,
            help="Enable the template pml (loopback; teaching/testing)")

    def open(self) -> bool:
        return bool(self._enable.value)

    def get_module(self, rte) -> TemplatePml:
        return TemplatePml(self, rte)


COMPONENT = TemplateComponent()
