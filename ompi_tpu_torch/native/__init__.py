"""ompi_tpu_torch.native — C++ twins of the hot host-path loops.

Port of ``ompi_tpu/native/__init__.py``: a lazy ctypes binding over
``otpu_native.cc`` (this package's own copy of the JAX package's source):
the datatype pack/unpack element loops, the btl/sm SPSC ring, the shared
locks and atomics, the worker pool of ``threads/native`` and the epoll
progress reactor of ``runtime/reactor``.

The library is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into the directory ``OTPU_NATIVE_CACHE`` names when
it is set, as the reference's does, else into ``ompi_tpu_torch/build/``
(listed in ``.gitignore``; the reference's default is the system temp dir),
its file name carrying a hash of the source and the flags, under an
exclusive file lock so that the ranks of a job and parallel test workers
build it once.

``OTPU_NATIVE_DISABLE`` (any non-empty value) keeps every caller on its
pure-Python lane, as if the toolchain were absent.  A build that fails is
not silent: ``available()`` is False and :func:`unavailable_reason` says
why (the compiler's message, or the switch).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "otpu_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_reason = ""

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_has_reactor = False


def build_dir() -> Path:
    """Where the library is built: ``OTPU_NATIVE_CACHE`` when it is set
    (``ompi_tpu/native/__init__.py:30-37``), else :data:`BUILD_DIR`."""
    cache = os.environ.get("OTPU_NATIVE_CACHE")
    return Path(cache) if cache else BUILD_DIR


def library_path() -> Path:
    """``<build dir>/libotpu_native-<hash>.so``: the hash covers the source
    and the compiler flags, so a changed source is rebuilt."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_dir() / f"libotpu_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the library into ``so`` unless it exists; one builder at a
    time across processes (``flock`` on ``otpu_native.lock`` beside it)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "otpu_native.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so.exists():
            return
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH")
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        r = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ exit {r.returncode}: "
                               f"{(r.stderr or r.stdout)[-2000:]}")
        os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> bool:
    """Declare every entry point; returns whether the reactor's exist."""
    lib.otpu_pack_elems.restype = ctypes.c_int64
    lib.otpu_pack_elems.argtypes = [
        _U8P, _U8P, _I64P, _I64P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64]
    lib.otpu_unpack_elems.restype = ctypes.c_int64
    lib.otpu_unpack_elems.argtypes = [
        _U8P, _U8P, _I64P, _I64P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64]
    lib.otpu_ring_push.restype = ctypes.c_int
    lib.otpu_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, _U8P, ctypes.c_uint64]
    lib.otpu_ring_push2.restype = ctypes.c_int
    lib.otpu_ring_push2.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, _U8P, ctypes.c_uint64,
        _U8P, ctypes.c_uint64]
    lib.otpu_ring_peek_len.restype = ctypes.c_int64
    lib.otpu_ring_peek_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.otpu_ring_pop.restype = ctypes.c_int64
    lib.otpu_ring_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, _U8P, ctypes.c_uint64]
    for name in ("otpu_lock_excl_try", "otpu_lock_shared_try"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    for name in ("otpu_lock_excl_release", "otpu_lock_shared_release"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]
    lib.otpu_atomic_add_i64.restype = ctypes.c_int64
    lib.otpu_atomic_add_i64.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.otpu_atomic_cas_i64.restype = ctypes.c_int64
    lib.otpu_atomic_cas_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.otpu_atomic_load_u64.restype = ctypes.c_uint64
    lib.otpu_atomic_load_u64.argtypes = [ctypes.c_void_p]
    lib.otpu_atomic_store_u64.restype = None
    lib.otpu_atomic_store_u64.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    # worker pool (mca/threads native substrate)
    lib.otpu_pool_create.restype = ctypes.c_int64
    lib.otpu_pool_create.argtypes = [ctypes.c_int32]
    lib.otpu_pool_destroy.restype = None
    lib.otpu_pool_destroy.argtypes = [ctypes.c_int64]
    lib.otpu_pool_size.restype = ctypes.c_int32
    lib.otpu_pool_size.argtypes = [ctypes.c_int64]
    lib.otpu_pool_memcpy.restype = ctypes.c_int64
    lib.otpu_pool_memcpy.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.otpu_pool_reduce.restype = ctypes.c_int64
    lib.otpu_pool_reduce.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    for name in ("otpu_pool_pack", "otpu_pool_unpack"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_int64, _U8P, _U8P, _I64P, _I64P,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
    lib.otpu_pool_test.restype = ctypes.c_int32
    lib.otpu_pool_test.argtypes = [ctypes.c_int64]
    lib.otpu_pool_wait.restype = None
    lib.otpu_pool_wait.argtypes = [ctypes.c_int64]
    # progress reactor (runtime/reactor.py front-end); a non-Linux build
    # stubs these and reactor_create then returns 0
    try:
        lib.otpu_reactor_create.restype = ctypes.c_int64
        lib.otpu_reactor_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.otpu_reactor_destroy.restype = None
        lib.otpu_reactor_destroy.argtypes = [ctypes.c_int64]
        lib.otpu_reactor_notify_fd.restype = ctypes.c_int
        lib.otpu_reactor_notify_fd.argtypes = [ctypes.c_int64]
        lib.otpu_reactor_wait_fd.restype = ctypes.c_int
        lib.otpu_reactor_wait_fd.argtypes = [ctypes.c_int64]
        lib.otpu_reactor_add.restype = ctypes.c_int
        lib.otpu_reactor_add.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.otpu_reactor_del.restype = ctypes.c_int
        lib.otpu_reactor_del.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.otpu_reactor_rearm.restype = ctypes.c_int
        lib.otpu_reactor_rearm.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.otpu_reactor_want_write.restype = ctypes.c_int
        lib.otpu_reactor_want_write.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        # raw void* out-buffer (not an ndpointer): the per-tick caller
        # passes a cached buffer ADDRESS, skipping numpy's from_param
        # validation on the hottest ctypes call
        lib.otpu_reactor_drain.restype = ctypes.c_int64
        lib.otpu_reactor_drain.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_uint64]
        lib.otpu_reactor_take_oversize.restype = ctypes.c_int64
        lib.otpu_reactor_take_oversize.argtypes = [
            ctypes.c_int64, ctypes.c_int, _U8P, ctypes.c_uint64]
        lib.otpu_reactor_stats.restype = ctypes.c_int
        lib.otpu_reactor_stats.argtypes = [ctypes.c_int64, _I64P, ctypes.c_int]
    except AttributeError:
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _reason, _has_reactor
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("OTPU_NATIVE_DISABLE"):
            # the fallback-lane switch: behave exactly as if the toolchain
            # were absent, so the pure-Python lanes stay testable
            _reason = "OTPU_NATIVE_DISABLE is set"
            return None
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            _has_reactor = _bind(lib)
        except Exception as exc:
            _reason = f"native core build or load failed: {exc}"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is False ("" while it is True or untried)."""
    _load()
    return _reason


def reactor_supported() -> bool:
    """The library is loaded AND exports the progress-reactor entry
    points (a non-Linux build stubs them; ``reactor_create`` then returns
    0 and the runtime stays on the pure-Python lane)."""
    return _load() is not None and _has_reactor


# -- progress reactor entry points ----------------------------------------

def reactor_create(ring_cap: int = 8 << 20,
                   oversize_limit: int = 4 << 20) -> int:
    """Start the epoll reactor thread; returns a handle (0: failed)."""
    if not reactor_supported():
        return 0
    return int(_load().otpu_reactor_create(ring_cap, oversize_limit))


def reactor_destroy(handle: int) -> None:
    _load().otpu_reactor_destroy(handle)


def reactor_notify_fd(handle: int) -> int:
    """The eventfd the reactor pokes when completed records land (drain
    clears it)."""
    return int(_load().otpu_reactor_notify_fd(handle))


def reactor_wait_fd(handle: int) -> int:
    """The consumer waiter fd: readable when the reactor's epoll set has
    ready events OR completed records are queued.  Registered as the
    progress waiter, so an idle consumer wakes on raw socket readiness and
    picks the frame up inline through the drain-time pump."""
    return int(_load().otpu_reactor_wait_fd(handle))


def reactor_add(handle: int, fd: int, mode: int) -> bool:
    """Register ``fd``: mode 0 = byte stream (framing + parse), 1 =
    notify-only oneshot (listener), 2 = drain-dgram (doorbell)."""
    return int(_load().otpu_reactor_add(handle, fd, mode)) == 0


def reactor_del(handle: int, fd: int) -> bool:
    return int(_load().otpu_reactor_del(handle, fd)) == 0


def reactor_rearm(handle: int, fd: int) -> bool:
    """Re-arm a notify-mode fd after servicing its ACCEPT record."""
    return int(_load().otpu_reactor_rearm(handle, fd)) == 0


def reactor_want_write(handle: int, fd: int, on: bool) -> bool:
    """(De)register EPOLLOUT interest for a backpressured stream fd."""
    return int(_load().otpu_reactor_want_write(handle, fd,
                                               1 if on else 0)) == 0


def reactor_drain(handle: int, out: np.ndarray) -> int:
    """Copy completed records into ``out``; returns bytes copied, or a
    NEGATIVE needed size when the next record does not fit."""
    return int(_load().otpu_reactor_drain(handle, out.ctypes.data, len(out)))


def reactor_drain_fn():
    """The bound ctypes drain entry point, for the per-tick caller
    (``runtime/reactor.drain``) to cache: called with (handle, buffer
    address, capacity) ints, it skips the module lookup and wrapper frame.
    Releases the GIL for the call like any CDLL call."""
    lib = _load()
    return None if lib is None else lib.otpu_reactor_drain


def reactor_take_oversize(handle: int, fd: int, out: np.ndarray) -> int:
    """Fetch a parked oversize frame (resumes the stream); returns its
    length, a negative needed size, or -1 when nothing is parked."""
    return int(_load().otpu_reactor_take_oversize(handle, fd, out, len(out)))


def reactor_stats(handle: int) -> dict:
    """Reactor counters (racy reads)."""
    out = np.zeros(7, np.int64)
    n = int(_load().otpu_reactor_stats(handle, out, len(out)))
    keys = ("fds", "records", "frames_fast", "frames_raw",
            "overflow", "wakeups", "pumps")
    return {k: int(out[i]) for i, k in enumerate(keys[:n])}


# -- datatype engine entry points ----------------------------------------

def pack_elems(mem: np.ndarray, out: np.ndarray, seg_off: np.ndarray,
               seg_len: np.ndarray, extent: int, base_offset: int,
               first_elem: int, nelem: int) -> int:
    """Gather ``nelem`` whole elements into ``out``; returns bytes."""
    return int(_load().otpu_pack_elems(
        mem, out, seg_off, seg_len, len(seg_off), extent, base_offset,
        first_elem, nelem))


def unpack_elems(mem: np.ndarray, chunk: np.ndarray, seg_off: np.ndarray,
                 seg_len: np.ndarray, extent: int, base_offset: int,
                 first_elem: int, nelem: int) -> int:
    return int(_load().otpu_unpack_elems(
        mem, chunk, seg_off, seg_len, len(seg_off), extent, base_offset,
        first_elem, nelem))


# -- shared locks and atomics (coll/sm's counters) ------------------------

def lock_excl_try(addr: int) -> bool:
    return bool(_load().otpu_lock_excl_try(addr))


def lock_excl_release(addr: int) -> None:
    _load().otpu_lock_excl_release(addr)


def lock_shared_try(addr: int) -> bool:
    return bool(_load().otpu_lock_shared_try(addr))


def lock_shared_release(addr: int) -> None:
    _load().otpu_lock_shared_release(addr)


def atomic_add_i64(addr: int, delta: int) -> int:
    """Fetch-and-add on a mapped int64; returns the old value."""
    return int(_load().otpu_atomic_add_i64(addr, delta))


def atomic_cas_i64(addr: int, expected: int, desired: int) -> tuple:
    """(old_value, swapped) CAS on a mapped int64."""
    ok = ctypes.c_int32(0)
    old = _load().otpu_atomic_cas_i64(addr, expected, desired,
                                      ctypes.byref(ok))
    return int(old), bool(ok.value)


def atomic_load_u64(addr: int) -> int:
    return int(_load().otpu_atomic_load_u64(addr))


def atomic_store_u64(addr: int, v: int) -> None:
    _load().otpu_atomic_store_u64(addr, v)


# -- worker pool (mca/threads native substrate) ---------------------------

#: reduce op codes shared with otpu_pool_reduce
POOL_OPS = {"sum": 0, "prod": 1, "max": 2, "min": 3}
#: dtype codes shared with otpu_pool_reduce
POOL_DTYPES = {"float32": 0, "float64": 1, "int32": 2, "int64": 3}


def pool_create(nthreads: int) -> int:
    return int(_load().otpu_pool_create(nthreads))


def pool_destroy(handle: int) -> None:
    _load().otpu_pool_destroy(handle)


def pool_size(handle: int) -> int:
    return int(_load().otpu_pool_size(handle))


def pool_memcpy(handle: int, dst_addr: int, src_addr: int,
                nbytes: int) -> int:
    """Parallel memcpy; returns a ticket for pool_wait/pool_test."""
    return int(_load().otpu_pool_memcpy(handle, dst_addr, src_addr, nbytes))


def pool_reduce(handle: int, op: str, dtype: str, acc_addr: int,
                src_addr: int, count: int) -> int:
    """Parallel elementwise ``acc = acc <op> src``; returns a ticket."""
    return int(_load().otpu_pool_reduce(
        handle, POOL_OPS[op], POOL_DTYPES[dtype], acc_addr, src_addr, count))


def pool_pack(handle: int, mem: np.ndarray, out: np.ndarray,
              seg_off: np.ndarray, seg_len: np.ndarray, extent: int,
              base_offset: int, first_elem: int, nelem: int) -> int:
    """Parallel whole-element gather (pack_elems split over workers)."""
    return int(_load().otpu_pool_pack(
        handle, mem, out, seg_off, seg_len, len(seg_off), extent,
        base_offset, first_elem, nelem))


def pool_unpack(handle: int, mem: np.ndarray, chunk: np.ndarray,
                seg_off: np.ndarray, seg_len: np.ndarray, extent: int,
                base_offset: int, first_elem: int, nelem: int) -> int:
    return int(_load().otpu_pool_unpack(
        handle, mem, chunk, seg_off, seg_len, len(seg_off), extent,
        base_offset, first_elem, nelem))


def pool_test(ticket: int) -> bool:
    return bool(_load().otpu_pool_test(ticket))


def pool_wait(ticket: int) -> None:
    """Block until done and free the ticket (call exactly once)."""
    _load().otpu_pool_wait(ticket)


# -- sm ring entry points -------------------------------------------------

def ring_push(buf_addr: int, cap: int, payload: np.ndarray) -> bool:
    return bool(_load().otpu_ring_push(buf_addr, cap, payload, len(payload)))


def ring_push2(buf_addr: int, cap: int, a: np.ndarray,
               b: np.ndarray) -> bool:
    """Gather-push one frame from two buffers (header + payload)."""
    return bool(_load().otpu_ring_push2(buf_addr, cap, a, len(a), b, len(b)))


def ring_peek_len(buf_addr: int, cap: int) -> int:
    """Next complete frame's length, or -1 when none is ready."""
    return int(_load().otpu_ring_peek_len(buf_addr, cap))


def ring_pop(buf_addr: int, cap: int, out: np.ndarray) -> int:
    """Returns payload length, -1 if empty/incomplete, -2 if out too small."""
    return int(_load().otpu_ring_pop(buf_addr, cap, out, len(out)))
