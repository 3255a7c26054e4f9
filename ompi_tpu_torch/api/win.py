"""RMA windows — the MPI one-sided API surface.

Copy of ``ompi_tpu/api/win.py`` (after the reference's
``ompi/win/win.c`` and the ``osc`` module vtable, ``ompi/mca/osc/osc.h``):
a ``Win`` owns an exposure region (a 1-D numpy array; ``disp_unit`` is the
dtype's itemsize), an internal duplicate of the creating communicator that
isolates its RMA traffic, and the osc module chosen at creation
(``win_select``).  The ops mirror MPI-3 RMA: put/get/accumulate/
get_accumulate/fetch_and_op/compare_and_swap and their request forms
(``rput``...), fence, passive-target lock/unlock/lock_all/flush, PSCW, the
dynamic windows (``create_dynamic``, ``attach_region``) and
``allocate_shared``/``shared_query``.  The epoch calls (fence, lock,
unlock, their ``_all`` forms, flush, flush_all and PSCW) each run under an
osc trace span (``win.py:23``, ``_epoch``: ``win_fence`` ... of category
``osc``) while tracing is on, and the RMA ops record their bytes into
osc/monitoring's counters (``_mon``, ``win.py:187-263``) while monitoring
is on.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.attributes import AttributeHost
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.runtime import trace


class Win(AttributeHost):
    LOCK_EXCLUSIVE = "exclusive"
    LOCK_SHARED = "shared"

    def __init__(self, comm, local: np.ndarray, name: str = "") -> None:
        self.comm = comm            # internal dup — RMA traffic isolation
        self.local = local          # my exposure region
        self.name = name or f"win#{comm.cid}"
        self.module = None          # selected osc module
        self.freed = False
        # a byte-addressed window (symmetric heap): offsets are bytes and
        # typed RMA ops reinterpret target bytes as the origin dtype
        self.byte_addressed = False

    # -- creation (collective) ------------------------------------------
    @classmethod
    def create(cls, comm, size: Optional[int] = None, base=None,
               dtype=np.float64, name: str = "",
               device: bool = False) -> "Win":
        """``MPI_Win_create`` / ``MPI_Win_allocate``.

        ``base``: expose an existing 1-D array; or ``size``: allocate a
        zero-filled region of ``size`` elements of ``dtype``.
        ``device=True`` in a device world allocates the window on the
        card (osc/device: one tensor, row r rank r's exposure region).
        """
        if base is None:
            if size is None:
                raise MpiError(ErrorClass.ERR_WIN,
                               "Win.create needs size= or base=")
            base = np.zeros(size, dtype=dtype)
        else:
            base = np.ascontiguousarray(base)
            if base.ndim != 1:
                raise MpiError(ErrorClass.ERR_WIN,
                               "window base must be 1-D")
        win = cls(comm.dup(), base, name=name)
        win.dtype = base.dtype     # survives device windows (local=None)
        win.device = device
        from ompi_tpu_torch.mca.osc import win_select

        win_select(win)
        win.comm.barrier()  # all exposure agents live before first access
        return win

    @classmethod
    def create_dynamic(cls, comm, name: str = "") -> "Win":
        """``MPI_Win_create_dynamic``: a window with NO exposure region
        at creation; memory is attached later with :meth:`attach`.  The
        reference addresses attached regions by absolute address; here
        :meth:`attach` returns a region handle the application shares
        with peers (the same out-of-band step real MPI apps do with
        ``MPI_Get_address``)."""
        import itertools

        if comm.rte is not None and comm.rte.is_device_world:
            raise MpiError(
                ErrorClass.ERR_WIN,
                "dynamic windows need the multi-process model (attach "
                "semantics are per-process memory; run under tpurun)")
        win = cls(comm.dup(), np.zeros(0, np.uint8), name=name)
        win.dtype = np.dtype(np.uint8)
        win.device = False
        win.dynamic = True
        win.regions = {}
        win._region_ids = itertools.count(1)
        from ompi_tpu_torch.mca.osc import win_select

        win_select(win)
        win.comm.barrier()
        return win

    def attach_region(self, arr) -> int:
        """``MPI_Win_attach`` (local): expose ``arr`` through this
        dynamic window; returns the region handle peers target."""
        self._check()
        if not getattr(self, "dynamic", False):
            raise MpiError(ErrorClass.ERR_WIN,
                           "attach needs a dynamic window")
        if not isinstance(arr, np.ndarray) or \
                not arr.flags["C_CONTIGUOUS"]:
            # a silent ascontiguousarray COPY would expose hidden memory:
            # peers' puts must land in the caller's own array
            raise MpiError(ErrorClass.ERR_WIN,
                           "attach needs a C-contiguous ndarray (remote "
                           "writes target the caller's memory)")
        handle = next(self._region_ids)
        self.regions[handle] = arr
        return handle

    def detach_region(self, handle: int) -> None:
        """``MPI_Win_detach``."""
        self._check()
        if getattr(self, "regions", None) is None \
                or handle not in self.regions:
            raise MpiError(ErrorClass.ERR_WIN,
                           f"no attached region {handle}")
        del self.regions[handle]

    @classmethod
    def allocate(cls, comm, size: int, dtype=np.float64,
                 name: str = "") -> tuple["Win", np.ndarray]:
        """``MPI_Win_allocate``: framework-allocated exposure region;
        returns (win, local buffer)."""
        win = cls.create(comm, size=size, dtype=dtype, name=name)
        return win, win.local

    @classmethod
    def allocate_shared(cls, comm, size: int, dtype=np.float64,
                        name: str = "") -> tuple["Win", np.ndarray]:
        """``MPI_Win_allocate_shared``: same-node windows are genuinely
        shared-memory mapped here (osc/rdma's segments), so allocate IS
        allocate_shared; ``shared_query`` gives the direct view."""
        return cls.allocate(comm, size, dtype, name)

    def shared_query(self, target: int) -> np.ndarray:
        """``MPI_Win_shared_query``: a direct load/store view of
        ``target``'s window (same-node, shm-mapped osc modules only)."""
        self._check()
        seg = getattr(self.module, "_seg", None)
        if seg is None:
            raise MpiError(
                ErrorClass.ERR_RMA_CONFLICT,
                f"window {self.name}'s osc module has no shared segments "
                f"(active-message path); use put/get")
        view = seg(self, target).typed()
        # trim the >=1-byte allocation pad (zero-size windows) off the
        # mapped segment.  shared_query assumes the symmetric allocation
        # allocate_shared performs (same size every rank), so my element
        # count is the peer's too
        nelem = self.local.size if self.local is not None else len(view)
        return view[:nelem]

    # -- accessors -------------------------------------------------------
    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def rank(self) -> int:
        return self.comm.rank

    def _check(self) -> None:
        if self.freed:
            raise MpiError(ErrorClass.ERR_WIN, "window was freed")

    def _mon(self, op: str, nbytes: int) -> None:
        # osc/monitoring interposition (common_monitoring.h's osc slot)
        from ompi_tpu_torch.runtime import monitoring

        if monitoring.enabled():
            monitoring.record_osc(op, nbytes)

    def _epoch(self, name: str, fn, *a):
        """Run one epoch-synchronization call under an osc trace span
        (fence / lock / unlock / PSCW / flush: the waits where RMA skew and
        straggler targets become visible)."""
        if not trace.enabled:
            return fn(*a)
        t0 = trace.now()
        try:
            return fn(*a)
        finally:
            trace.span(name, "osc", t0, args={"win": self.name})

    # -- RMA ops ---------------------------------------------------------
    def put(self, arr, target: int, offset: int = 0,
            region: Optional[int] = None) -> None:
        self._check()
        arr = np.ascontiguousarray(arr)
        self._mon("put", arr.nbytes)
        if region is not None:
            self._region_op("put_region", arr, target, offset, region)
            return
        self.module.put(self, arr, target, offset)

    def get(self, count: int, target: int, offset: int = 0,
            region: Optional[int] = None) -> np.ndarray:
        self._check()
        if region is not None:
            # region dtype lives at the target: count real bytes after
            out = self._region_op("get_region", count, target, offset,
                                  region)
            self._mon("get", out.nbytes)
            return out
        self._mon("get", count * self.dtype.itemsize)
        return self.module.get(self, count, target, offset)

    def _region_op(self, name: str, payload, target: int, offset: int,
                   region: int):
        fn = getattr(self.module, name, None)
        if fn is None:
            raise MpiError(
                ErrorClass.ERR_WIN,
                f"{self.name}'s osc module has no dynamic-region RMA")
        return fn(self, payload, target, offset, region)

    def accumulate(self, arr, target: int, offset: int = 0,
                   op: op_mod.Op = op_mod.SUM) -> None:
        self._check()
        arr = np.ascontiguousarray(arr)
        self._mon("accumulate", arr.nbytes)
        self.module.accumulate(self, arr, target, offset, op)

    def get_accumulate(self, arr, target: int, offset: int = 0,
                       op: op_mod.Op = op_mod.SUM) -> np.ndarray:
        """Atomically fetch the old contents and apply ``arr (op) target``."""
        self._check()
        arr = np.ascontiguousarray(arr)
        self._mon("get_accumulate", arr.nbytes)
        return self.module.get_accumulate(self, arr, target, offset, op)

    def fetch_and_op(self, value, target: int, offset: int = 0,
                     op: op_mod.Op = op_mod.SUM):
        self._check()
        out = self.module.get_accumulate(
            self, np.asarray([value], dtype=self.dtype), target,
            offset, op)
        return out[0]

    def compare_and_swap(self, value, compare, target: int, offset: int = 0):
        self._check()
        self._mon("compare_and_swap", np.asarray(value).nbytes)
        return self.module.compare_and_swap(self, value, compare, target,
                                            offset)

    # -- request-based RMA (MPI_Rput/Rget/Raccumulate/Rget_accumulate) ---
    # The osc modules complete operations on return (mapped windows:
    # direct load/store; active message: request/reply inside the call),
    # so the returned request is born complete — flush is still what
    # orders remote visibility, exactly as MPI allows.
    def rput(self, arr, target: int, offset: int = 0):
        from ompi_tpu_torch.api.request import CompletedRequest

        self.put(arr, target, offset)
        return CompletedRequest()

    def rget(self, count: int, target: int, offset: int = 0):
        from ompi_tpu_torch.api.request import CompletedRequest

        req = CompletedRequest()
        req.result = self.get(count, target, offset)
        return req

    def raccumulate(self, arr, target: int, offset: int = 0,
                    op: op_mod.Op = op_mod.SUM):
        from ompi_tpu_torch.api.request import CompletedRequest

        self.accumulate(arr, target, offset, op)
        return CompletedRequest()

    def rget_accumulate(self, arr, target: int, offset: int = 0,
                        op: op_mod.Op = op_mod.SUM):
        from ompi_tpu_torch.api.request import CompletedRequest

        req = CompletedRequest()
        req.result = self.get_accumulate(arr, target, offset, op)
        return req

    # -- synchronization -------------------------------------------------
    def fence(self) -> None:
        """``MPI_Win_fence``: close + open an active-target epoch."""
        self._check()
        self._epoch("win_fence", self.module.fence, self)

    def lock(self, target: int, lock_type: str = LOCK_EXCLUSIVE) -> None:
        self._check()
        self._epoch("win_lock", self.module.lock, self, target, lock_type)

    def unlock(self, target: int) -> None:
        self._check()
        self._epoch("win_unlock", self.module.unlock, self, target)

    def lock_all(self) -> None:
        self._check()

        def _all():
            for t in range(self.size):
                self.module.lock(self, t, self.LOCK_SHARED)

        self._epoch("win_lock_all", _all)

    def unlock_all(self) -> None:
        self._check()

        def _all():
            for t in range(self.size):
                self.module.unlock(self, t)

        self._epoch("win_unlock_all", _all)

    def flush(self, target: int) -> None:
        """Complete all outstanding ops this process issued to ``target``."""
        self._check()
        self._epoch("win_flush", self.module.flush, self, target)

    def flush_all(self) -> None:
        self._check()

        def _all():
            for t in range(self.size):
                self.module.flush(self, t)

        self._epoch("win_flush_all", _all)

    def flush_local(self, target: int) -> None:
        # origin-local completion; our put/accumulate pack eagerly, so
        # origin buffers are reusable as soon as the call returns
        self._check()

    def sync(self) -> None:
        self._check()

    # PSCW generalized active-target (MPI_Win_post/start/complete/wait)
    def post(self, group: Group) -> None:
        self._check()
        self._epoch("win_post", self.module.post, self, group)

    def start(self, group: Group) -> None:
        self._check()
        self._epoch("win_start", self.module.start, self, group)

    def complete(self) -> None:
        self._check()
        self._epoch("win_complete", self.module.complete, self)

    def wait(self) -> None:
        self._check()
        self._epoch("win_wait", self.module.wait, self)

    def test(self) -> bool:
        """``MPI_Win_test``: nonblocking ``wait`` — True iff the exposure
        epoch completed (all access-group members called complete)."""
        self._check()
        fn = getattr(self.module, "pscw_test", None)
        if fn is None:
            raise MpiError(ErrorClass.ERR_RMA_SYNC,
                           f"{self.name}'s osc module has no "
                           "nonblocking PSCW test")
        return bool(fn(self))

    # -- lifecycle -------------------------------------------------------
    def free(self) -> None:
        if self.freed:
            return
        self.comm.barrier()
        self.module.detach(self)
        self._attrs_delete_all()
        self.comm.free()  # release the internal dup (CID, match state)
        self.freed = True

    def __repr__(self) -> str:
        n = self.local.size if self.local is not None else "device"
        return f"Win({self.name}, rank={self.rank}/{self.size}, len={n})"
