"""pcoll — partitioned persistent collectives (MPI-4's partitioned model
applied to collectives; the ``Pallreduce_init`` analog).

Copy of ``ompi_tpu/mca/part/pcoll.py``.  A partitioned collective binds a
LIST of buckets once; each ``pready(i)`` releases bucket i for reduction.
On the device path the bucket's bound handle (the comm's
``partitioned_coll`` slot: coll/builtin's ``persistent_coll`` per bucket)
is launched at once and returns without waiting for the card, so the
reduction of bucket i runs while the application is still producing bucket
i+1: the bucketed-gradient-overlap pattern.  On host comms without a
device binding each pready runs the blocking collective, so every rank must
pready in the same order (the trainer's deterministic late-layer-first
schedule satisfies this).

``parrived(i)`` never synchronizes the card: a bucket whose result is a
CUDA tensor records a ``torch.cuda.Event`` on the current stream right
after its launch, and ``parrived`` queries it (the reference asks the
``jax.Array`` ``is_ready()``).  A result on the CPU, or a host result, is
ready as soon as ``pready`` returns.  ``result[i]`` is the bucket's tensor.
"""
from __future__ import annotations

import threading

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.request import Request, RequestState
from ompi_tpu_torch.api.status import Status
from ompi_tpu_torch.runtime import spc, trace


class PartitionedCollRequest(Request):
    """Restartable partitioned collective: start()/pready(i)/parrived(i)
    /wait(), with ``result[i]`` = bucket i's reduction."""

    side = "coll"

    def __init__(self, comm, coll: str, buckets, args=(), handles=None):
        super().__init__(persistent=True)
        buckets = list(buckets)
        if not buckets:
            raise MpiError(ErrorClass.ERR_ARG,
                           "partitioned collective needs >= 1 bucket")
        self._comm = comm
        self._coll = coll
        self._buckets = buckets
        self._args = tuple(args)
        self._handles = handles      # device bindings, or None (host)
        self.partitions = len(buckets)
        self.result: list = [None] * self.partitions
        self._plock = threading.Lock()

    def start(self, buckets=None) -> None:
        """``MPI_Start`` with optional data rebinding: a new round may pass
        fresh buckets matching the bound templates (the
        ``PersistentColl.start(x)`` convention); a mismatching bucket
        raises from its handle's check at its ``pready``."""
        if buckets is not None:
            buckets = list(buckets)
            if len(buckets) != self.partitions:
                raise MpiError(
                    ErrorClass.ERR_ARG,
                    f"rebind needs {self.partitions} buckets, got "
                    f"{len(buckets)}")
            self._buckets = buckets
        super().start()

    def _start(self) -> None:
        with self._plock:
            self._done = [False] * self.partitions
            self._ndone = 0
            self.result = [None] * self.partitions
            self._events = [None] * self.partitions

    def _check_partition(self, p) -> int:
        import numpy as np

        if not isinstance(p, (int, np.integer)) or not \
                0 <= p < self.partitions:
            raise MpiError(
                ErrorClass.ERR_ARG,
                f"bucket {p!r} out of range [0, {self.partitions})")
        return int(p)

    def pready(self, partition) -> None:
        spc.record("part_pready")
        t0 = trace.now() if trace.enabled else None
        if self.state is not RequestState.ACTIVE:
            raise MpiError(ErrorClass.ERR_REQUEST,
                           "Pready on an inactive partitioned collective "
                           "(call start() first)")
        p = self._check_partition(partition)
        with self._plock:
            if self._done[p]:
                raise MpiError(ErrorClass.ERR_ARG,
                               f"bucket {p} was already released in "
                               "this epoch")
            self._done[p] = True
        x = self._buckets[p]
        try:
            if self._handles is not None:
                out = self._handles[p](x)      # async device dispatch
            else:
                out = getattr(self._comm, self._coll)(x, *self._args)
        except Exception:
            # a failed dispatch (e.g. a rebind whose bucket mismatches
            # the bound template) must not wedge the request: the bucket
            # was NOT released, so un-mark it — the epoch stays
            # restartable and a corrected pready(p) can retry
            with self._plock:
                self._done[p] = False
            raise
        event = None
        if getattr(out, "is_cuda", False):
            import torch

            # the launch's completion marker: parrived queries it, never
            # waits on it
            event = torch.cuda.Event()
            event.record()
        nbytes = int(getattr(x, "nbytes", 0) or 0)
        spc.record("part_bytes", nbytes)
        with self._plock:
            self.result[p] = out
            self._events[p] = event
            self._ndone += 1
            done = self._ndone == self.partitions
        if t0 is not None:
            trace.span("pready", "part", t0,
                       args={"partition": p, "nbytes": nbytes,
                             "cid": self._comm.cid, "coll": self._coll})
        if done:
            self.status = Status(_nbytes=sum(
                int(getattr(b, "nbytes", 0) or 0) for b in self._buckets))
            self.complete()

    def parrived(self, partition) -> bool:
        """Bucket released AND its device result materialized (host and
        CPU results are synchronous, so released == arrived there)."""
        spc.record("part_parrived")
        p = self._check_partition(partition)
        if self.persistent and self.state is RequestState.INACTIVE:
            raise MpiError(ErrorClass.ERR_REQUEST,
                           "Parrived on a never-started partitioned "
                           "collective")
        with self._plock:
            out = self.result[p] if self._done[p] else None
            event = self._events[p]
        if out is None:
            return False
        return True if event is None else bool(event.query())
