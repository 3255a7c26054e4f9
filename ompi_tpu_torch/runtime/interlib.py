"""interlib — coordination between several MPI-using libraries.

Copy of ``ompi_tpu/runtime/interlib.py`` (after the reference's
``ompi/interlib/interlib.c``): when two independent libraries in one
process both use the runtime, neither may tear it down while the other
still needs it (``finalize`` returns while a registration is held), and the
effective thread level is the strongest any registrant asked for.

Thread levels (``MPI_THREAD_*``): the engine is thread-safe (every shared
structure is lock-guarded and the GIL serialises the rest), so ``provided``
is always THREAD_MULTIPLE whatever level was requested, which is therefore
not stored.
"""
from __future__ import annotations

import threading

THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3

_lock = threading.Lock()
_registrations = 0
_main_thread = None


def note_main_thread(force: bool = False) -> None:
    """Record the thread performing MPI init (``MPI_Is_thread_main``'s
    reference point).  ``force``: init's anchor overrides an earlier
    register() from a library worker thread."""
    global _main_thread
    with _lock:
        if force or _main_thread is None:
            _main_thread = threading.current_thread()


def register(thread_level: int = THREAD_SINGLE) -> int:
    """A library announces itself (``ompi_interlib_declare``); returns
    the provided thread level."""
    global _registrations
    with _lock:
        _registrations += 1
    note_main_thread()
    return THREAD_MULTIPLE


def deregister() -> int:
    """The remaining registration count: finalize may tear the runtime
    down only when it is zero."""
    global _registrations
    with _lock:
        _registrations = max(0, _registrations - 1)
        return _registrations


def registrations() -> int:
    with _lock:
        return _registrations


def query_thread() -> int:
    """``MPI_Query_thread``: the provided level."""
    return THREAD_MULTIPLE


def is_thread_main() -> bool:
    """``MPI_Is_thread_main``."""
    with _lock:
        return _main_thread is None or \
            threading.current_thread() is _main_thread


def reset_for_testing() -> None:
    global _registrations, _main_thread
    with _lock:
        _registrations = 0
        _main_thread = None
