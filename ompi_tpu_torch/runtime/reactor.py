"""runtime/reactor — Python front end of the native progress reactor.

Copy of ``ompi_tpu/runtime/reactor.py``.  An epoll loop in the native core
(the reactor section of ``native/otpu_native.cc``) owns the btl fds and runs
socket drain, wire framing, split-tail reassembly and header-type lane
routing on a dedicated OS thread, with no GIL on the receive hot path.
Python sees only COMPLETED work: one ctypes call per :func:`drain` empties
the lock-free record queue, and each record goes to the handler its fd
registered (btl/tcp builds the Frag from a ready-to-unpack fast header;
btl/sm's doorbell just wakes).

Lane contract (why the fallback is bit-identical): the native side forwards
any frame that is not a plain fast header (crc-armed, quantized, pickle,
handshake) as a RAW record, and the btl feeds those bytes to the same
``_parse_frame`` its pure-Python lane uses.  The reactor never engages under
``OTPU_SANITIZE`` (the sanitizer's checks run on the pure-Python lane), and
with ``otpu_progress_native=0``, ``OTPU_NATIVE_DISABLE`` or no toolchain
nothing here runs: btl/tcp's selector loop carries the job.

Registered with the progress engine two ways: :func:`drain` is a progress
callback, and the reactor's WAIT fd (readable on raw btl-socket readiness
or queued records) is a progress WAITER, so ``idle_wait`` wakes the moment
wire bytes arrive and the next drain's inline pump parses them on the
consumer thread.  The drain's ctypes call runs in its own frame,
:func:`_native_drain` (``reactor.py:237-267``), the name the sampling
profiler classifies a GIL-released native site by
(``profile._NATIVE_NAMES``).
"""
from __future__ import annotations

import os
import struct
import threading
from typing import Callable

import numpy as np

from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime import sanitizer, spc
from ompi_tpu_torch.runtime.hotpath import hot_path

# record stream (mirrors the emit() layout in otpu_native.cc):
#   [u32 payload_len][i32 fd][u8 etype][payload]
_REC = struct.Struct("<IiB")

# record etypes (otpu_native.cc REC_*)
REC_RAW = 0        # whole frame -> the Python slow lane (_parse_frame)
REC_FAST = 1       # frame after the htype byte: !IIIiqBqqq hdr + payload
REC_EOF = 2        # peer closed / hard error
REC_ACCEPT = 3     # notify-mode fd readable (oneshot; rearm after)
REC_WRITABLE = 4   # backpressured fd turned writable
REC_DOORBELL = 5   # drain-mode dgram fd rang (dgrams consumed natively)
REC_OVERSIZE = 6   # u64 frame_len parked in the stream (take_oversize)
REC_DESYNC = 7     # u64 bad frame_len: framing desync, fail loudly

#: fd registration modes (otpu_reactor_add)
MODE_STREAM = 0
MODE_NOTIFY = 1
MODE_DRAIN = 2

_native_var = registry.register(
    "progress", None, "native",
    vtype=VarType.BOOL, default=True,
    help="Run the btl hot loops (socket drain, framing, fast-frame "
         "parse) on the native epoll reactor thread when the compiled "
         "otpu_native library is available.  0 keeps the pure-Python "
         "selector loop — bit-identical behavior, only slower.")

_lock = threading.RLock()
_drain_gate = threading.Lock()   # one drainer at a time (SPSC consumer)
_handle = 0
_pid = 0
_wait_fd = -1
_byfd: dict[int, Callable] = {}
_drainbuf: np.ndarray = None
_drainbuf_ptr = 0                # cached buffer address for the raw call
_drain_fn = None                 # bound ctypes entry point (engage())

# the handler registry and the reactor lifecycle fields mutate only under
# the module lock (drain reads _byfd lock-free: a GIL-atomic dict get)


def configured() -> bool:
    """The otpu_progress_native knob (env: OTPU_MCA_progress_native)."""
    return bool(_native_var.value)


def available() -> bool:
    """Toolchain contract: the native library compiled AND exports the
    reactor entry points.  False means every caller stays on its
    pure-Python lane — same meaning as ``native.available()``."""
    from ompi_tpu_torch import native

    return native.reactor_supported()


def active() -> bool:
    return _handle != 0 and _pid == os.getpid()


def engage() -> bool:
    """Start (or confirm) the reactor for this process.  Idempotent;
    returns False when disabled, unsupported, or under the sanitizer
    (whose strict checks stay on the authoritative pure-Python lane).
    """
    global _handle, _pid, _wait_fd
    if not configured() or sanitizer.enabled:
        return False
    with _lock:
        if active():
            return True
        if _handle:
            # forked child inherited a dead handle: forget it (the
            # parent's reactor thread did not survive the fork)
            _forget_locked()
        if not available():
            return False
        from ompi_tpu_torch import native

        h = native.reactor_create()
        if h == 0:
            return False
        _handle = h
        _pid = os.getpid()
        _wait_fd = native.reactor_wait_fd(h)
        global _drain_fn
        _drain_fn = native.reactor_drain_fn()
        _ensure_drainbuf(1 << 20)
        from ompi_tpu_torch.runtime import progress as progress_mod

        progress_mod.register(drain)
        progress_mod.register_waiter(_wait_fd)
        return True


def _forget_locked() -> None:
    """Drop reactor state without touching the native side (fork)."""
    global _handle, _pid, _wait_fd
    _handle = 0
    _pid = 0
    _wait_fd = -1
    _byfd.clear()


def shutdown() -> None:
    """Stop the reactor thread and deregister from the progress engine
    (instance teardown / progress.reset_for_testing)."""
    global _handle
    with _lock:
        if not _handle:
            return
        from ompi_tpu_torch.runtime import progress as progress_mod

        progress_mod.unregister(drain)
        if _wait_fd >= 0:
            progress_mod.unregister_waiter(_wait_fd)
        if _pid == os.getpid():
            from ompi_tpu_torch import native

            native.reactor_destroy(_handle)
        _forget_locked()


def add(fd: int, mode: int, handler: Callable) -> bool:
    """Register ``fd`` with ``handler(etype, payload) -> int`` (events
    progressed).  ``payload`` is a memoryview into the drain buffer,
    valid until the next drain — the btl's borrowed-frag contract."""
    with _lock:
        if not active():
            return False
        from ompi_tpu_torch import native

        if not native.reactor_add(_handle, fd, mode):
            return False
        _byfd[fd] = handler
        return True


def remove(fd: int) -> None:
    with _lock:
        _byfd.pop(fd, None)
        if active():
            from ompi_tpu_torch import native

            native.reactor_del(_handle, fd)


def rearm(fd: int) -> None:
    """Re-arm a MODE_NOTIFY fd after servicing its ACCEPT record."""
    if active():
        from ompi_tpu_torch import native

        native.reactor_rearm(_handle, fd)


def want_write(fd: int, on: bool) -> bool:
    """(De)register writability interest for a backpressured stream."""
    if not active():
        return False
    from ompi_tpu_torch import native

    return native.reactor_want_write(_handle, fd, on)


def take_oversize(fd: int) -> np.ndarray:
    """Fetch a parked oversize frame as an OWNED array (the fetch also
    resumes the parked stream on the reactor thread)."""
    from ompi_tpu_torch import native

    out = np.empty(1 << 16, np.uint8)
    n = native.reactor_take_oversize(_handle, fd, out)
    if n < -1:
        out = np.empty(-n, np.uint8)
        n = native.reactor_take_oversize(_handle, fd, out)
    if n < 0:
        raise sanitizer.SanitizeError(
            "reactor oversize frame vanished for fd %d" % fd)
    return out[:n]


def _ensure_drainbuf(nbytes: int) -> np.ndarray:
    global _drainbuf, _drainbuf_ptr
    buf = _drainbuf
    if buf is None or len(buf) < nbytes:
        buf = _drainbuf = np.empty(int(nbytes), np.uint8)
        _drainbuf_ptr = buf.ctypes.data
    return buf


def _native_drain(fn, h, ptr, cap):
    """The CDLL drain call in its own frame: ctypes releases the GIL for
    the call's duration (socket drain, framing and the inline pump all run
    GIL-free), and the sampling profiler classifies a thread parked here
    as a GIL-released native site by this frame's name
    (``profile._NATIVE_NAMES``)."""
    return fn(h, ptr, cap)


@hot_path
def drain() -> int:
    """Empty the native record queue — the one ctypes call per
    progress() tick (the cached raw-pointer binding: no module lookup,
    no ndarray argument marshalling) — and dispatch each record to its
    fd's handler.  Registered as a normal progress callback while
    engaged."""
    h = _handle
    fn = _drain_fn
    if not h or fn is None or _pid != os.getpid():
        return 0
    if not _drain_gate.acquire(blocking=False):
        return 0      # another thread is mid-drain (SPSC consumer)
    try:
        buf = _drainbuf
        n = _native_drain(fn, h, _drainbuf_ptr, len(buf))
        if n < 0:
            buf = _ensure_drainbuf(-n)
            n = _native_drain(fn, h, _drainbuf_ptr, len(buf))
        if n <= 0:
            return 0
        spc.record("progress_native_drains")
        view = memoryview(buf)
        byfd = _byfd
        events = 0
        pos = 0
        while pos < n:
            plen, fd, etype = _REC.unpack_from(buf, pos)
            pos += _REC.size
            payload = view[pos:pos + plen]
            pos += plen
            handler = byfd.get(fd)
            if handler is not None:
                events += handler(etype, payload)
        return events
    finally:
        _drain_gate.release()


def stats() -> dict:
    """Reactor state (racy native counters)."""
    out = {"configured": configured(), "available": available(),
           "active": active(), "registered_fds": len(_byfd)}
    if active():
        from ompi_tpu_torch import native

        out.update(native.reactor_stats(_handle))
    return out
