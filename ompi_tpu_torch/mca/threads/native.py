"""threads/native — the C++ worker pool (parallelism without the GIL).

Copy of ``ompi_tpu/mca/threads/native.py`` (after the reference's
``opal/mca/threads/pthreads``, the default OS-thread backend).  Jobs are
split into per-worker chunks inside the native core
(``native/otpu_native.cc``); the submitting ctypes call drops the GIL, so
pack, reduce and copy overlap Python execution.  Priority 40: selected over
``threads/python`` whenever the native core is available.
"""
from __future__ import annotations

import threading

import numpy as np

from ompi_tpu_torch import native
from ompi_tpu_torch.mca.threads import base


class _NativeWork(base.Work):
    """Completion handle; ``_keep`` pins arrays whose raw pointers the
    queued native chunks still dereference (segment tables)."""

    def __init__(self, ticket: int, keep=()):
        self._ticket = ticket
        self._keep = keep
        self._done = False
        self._lock = threading.Lock()

    def _complete(self) -> None:
        # single pool_wait under the lock: the ticket is freed exactly
        # once even when test() and wait() race from two threads
        with self._lock:
            if not self._done:
                native.pool_wait(self._ticket)
                self._done = True
                self._keep = ()

    def test(self) -> bool:
        # the poll must also run under the lock: a concurrent wait()
        # frees the ticket, and pool_test on a freed ticket is UB
        with self._lock:
            if not self._done and native.pool_test(self._ticket):
                # ticket memory is freed by pool_wait — completion via
                # test() must still run it (it returns immediately)
                native.pool_wait(self._ticket)
                self._done = True
                self._keep = ()
            return self._done

    def wait(self) -> None:
        self._complete()

    def __del__(self):
        # an abandoned handle must still free its ticket; the queued
        # chunks always drain (workers only exit after the queue is
        # empty), so this wait is bounded
        try:
            self._complete()
        except Exception:
            pass   # interpreter teardown: the process is going away


def _addr(a: np.ndarray) -> int:
    if not a.flags.c_contiguous:
        raise ValueError("pool jobs need C-contiguous arrays")
    return a.ctypes.data


class NativePool(base.WorkPool):
    parallel_pack = True

    def __init__(self, nworkers: int):
        self._h = native.pool_create(nworkers)
        self.size = native.pool_size(self._h)

    def memcpy(self, dst, src):
        if dst.nbytes != src.nbytes:
            raise ValueError("memcpy size mismatch")
        # keep=: the queued chunks hold raw buffer addresses — the
        # handle must pin the arrays until the workers ran
        return _NativeWork(native.pool_memcpy(
            self._h, _addr(dst), _addr(src), src.nbytes),
            keep=(dst, src))

    def reduce(self, op, acc, src):
        dt = str(acc.dtype)
        if (op not in native.POOL_OPS or dt not in native.POOL_DTYPES
                or acc.shape != src.shape or src.dtype != acc.dtype):
            raise ValueError(
                f"unsupported reduce: {op} {dt} vs {src.dtype}")
        return _NativeWork(native.pool_reduce(
            self._h, op, dt, _addr(acc), _addr(src), acc.size),
            keep=(acc, src))

    def pack(self, mem, out, seg_off, seg_len, extent, base_offset,
             first_elem, nelem):
        so = np.ascontiguousarray(seg_off, np.int64)
        sl = np.ascontiguousarray(seg_len, np.int64)
        # keep=(so, sl): the queued chunks hold these arrays' raw
        # pointers until the workers ran (conversion may have copied)
        return _NativeWork(native.pool_pack(
            self._h, mem, out, so, sl, extent, base_offset,
            first_elem, nelem), keep=(so, sl, mem, out))

    def unpack(self, mem, chunk, seg_off, seg_len, extent, base_offset,
               first_elem, nelem):
        so = np.ascontiguousarray(seg_off, np.int64)
        sl = np.ascontiguousarray(seg_len, np.int64)
        return _NativeWork(native.pool_unpack(
            self._h, mem, chunk, so, sl, extent, base_offset,
            first_elem, nelem), keep=(so, sl, mem, chunk))

    def close(self) -> None:
        if self._h:
            native.pool_destroy(self._h)
            self._h = 0


def substrate() -> dict:
    """Capability report of the native substrate this component fronts:
    which otpu_native tiers compiled in (worker pool, ring ops, the
    progress reactor) and whether the reactor is live in THIS process, so
    a slow run can be attributed to a missing toolchain at a glance."""
    from ompi_tpu_torch.runtime import reactor

    return {"available": native.available(),
            "pool": native.available(),
            "reactor": native.reactor_supported(),
            "reactor_active": reactor.active()}


class NativeThreadsComponent(base.ThreadsComponent):
    name = "native"
    priority = 40

    def open(self) -> bool:
        return native.available()

    def make_pool(self, nworkers: int) -> base.WorkPool:
        return NativePool(nworkers)


COMPONENT = NativeThreadsComponent()
