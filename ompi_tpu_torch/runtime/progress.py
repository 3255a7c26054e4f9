"""Central progress engine — the hot loop of the host tier.

Copy of ``ompi_tpu/runtime/progress.py`` (after the reference's
``opal/runtime/opal_progress.c``): registered callbacks are polled by
:func:`progress` (``opal_progress.c:216,224``); components register via
:func:`register` / :func:`unregister` (``:414``).  Device collectives need
no progress engine (the stream is one); this loop serves the host tier:
btl polling, the rendezvous protocol and blocking probes.  An idle waiter blocks in
``select`` on the readable fds transports register (:func:`idle_wait`);
the native reactor (``runtime/reactor.py``) registers its drain as a
callback and its wait fd as a waiter (``ompi_tpu/runtime/progress.py:185``),
and :func:`reset_for_testing` stops its thread first.  A sanitizer trip
(``SanitizeError``: wire corruption, a quant frame that does not decode)
propagates to the waiting caller instead of quarantining the callback.
The engine's depth is the ``progress`` telemetry source
(``progress.py:204-218``).  Not copied: the low-priority callbacks run
every 8th tick (``:227``; no port component registers one yet), so the
source's ``low_priority`` is always 0.
"""
from __future__ import annotations

import os
import selectors
import threading
import time
from typing import Callable

from ompi_tpu_torch.runtime import sanitizer
from ompi_tpu_torch.runtime.hotpath import hot_path

_lock = threading.RLock()
_callbacks: list[Callable[[], int]] = []
_in_progress = threading.local()

# -- event-based idle wait (the libevent role in opal_progress) ----------
#
# Transports register a readable fd that goes hot when work arrives (the
# btl/sm doorbell socket).  An idle waiter blocks in select() on these
# instead of sleeping blind: message arrival wakes it in ~10 µs instead of
# a scheduler quantum.
_waiter_sel = selectors.DefaultSelector()
_waiter_count = 0


def register_waiter(fileobj) -> None:
    global _waiter_count
    with _lock:
        _waiter_sel.register(fileobj, selectors.EVENT_READ)
        _waiter_count += 1


def unregister_waiter(fileobj) -> None:
    global _waiter_count
    with _lock:
        try:
            _waiter_sel.unregister(fileobj)
            _waiter_count -= 1
        except KeyError:
            pass


def _prune_dead_waiters() -> None:
    """Drop registrations whose fd was closed under the selector."""
    global _waiter_count
    with _lock:
        for key in list(_waiter_sel.get_map().values()):
            try:
                os.fstat(key.fd)
            except OSError:
                try:
                    _waiter_sel.unregister(key.fileobj)
                    _waiter_count -= 1
                except KeyError:
                    pass


def idle_wait(timeout: float) -> bool:
    """Block until a transport fd is readable or ``timeout`` elapses.
    Returns True when woken by an fd (the caller should poll progress)."""
    if _waiter_count == 0:
        time.sleep(timeout)
        return False
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        try:
            return bool(_waiter_sel.select(remaining))
        except OSError:
            # an fd closed concurrently with the select: prune the dead
            # registrations and retry on the survivors for what is left
            _prune_dead_waiters()
            if _waiter_count == 0:
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    time.sleep(remaining)
                return False


def register(cb: Callable[[], int]) -> None:
    """Register a callback returning the number of events it progressed."""
    with _lock:
        if cb not in _callbacks:
            _callbacks.append(cb)


def unregister(cb: Callable[[], int]) -> None:
    with _lock:
        if cb in _callbacks:
            _callbacks.remove(cb)


@hot_path
def progress() -> int:
    """Poll all registered callbacks once; returns events progressed."""
    if getattr(_in_progress, "active", False):
        return 0  # no recursive progress (callbacks may wait internally)
    _in_progress.active = True
    try:
        with _lock:
            cbs = list(_callbacks)
        events = 0
        for cb in cbs:
            try:
                events += cb()
            except sanitizer.SanitizeError:
                # a deliberate fatal integrity stop, not a broken callback:
                # quarantining it would turn detected corruption into a
                # silent hang
                raise
            except Exception:
                # a broken progress callback must not kill the loop; it is
                # removed and reported once
                unregister(cb)
                import traceback

                from ompi_tpu_torch.base.output import show_help

                show_help("help-progress", "callback-failed",
                          detail=traceback.format_exc(limit=3))
        return events
    finally:
        _in_progress.active = False


def reset_for_testing() -> None:
    # the native reactor registered a callback and a waiter here: stop its
    # thread BEFORE clearing the lists, so that no late record dispatch
    # fires into a half-reset engine
    from ompi_tpu_torch.runtime import reactor as _reactor

    _reactor.shutdown()
    with _lock:
        _callbacks.clear()


from ompi_tpu_torch.base.output import register_help as _rh  # noqa: E402

_rh("help-progress", "callback-failed",
    "A progress callback raised and was unregistered:\n{detail}")

# progress-engine depth for otpu_top (sampler-thread-only provider)
from ompi_tpu_torch.runtime import telemetry as _telemetry  # noqa: E402


def _telemetry_stats() -> dict:
    from ompi_tpu_torch.runtime import reactor as _reactor

    with _lock:
        out = {"callbacks": len(_callbacks), "low_priority": 0,
               "waiters": _waiter_count}
    out["reactor_active"] = _reactor.active()
    return out


_telemetry.register_source("progress", _telemetry_stats)
