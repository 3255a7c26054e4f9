"""Request lifecycle: completion callbacks, cancellation, persistent
requests, and the wait/test families.

Copy of ``ompi_tpu/api/request.py`` (after the reference's
``ompi/request/request.h``; the ``ompi_request_wait_completion`` spin at
``request.h:427`` becomes a progress-driven wait loop).  A device request
is born complete (the stream is its progress engine); a host request
(pml/ob1's sends and receives) completes from the progress engine, which
``wait`` and ``test`` drive.  ``GeneralizedRequest`` is
``MPI_Grequest_start``'s user-completed request.  Not copied: the
partitioned hooks (``pready``/``parrived``, with ``mca/part``) and the FT
completion of ``req_ft.c``.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.status import UNDEFINED, Status


class RequestState(enum.Enum):
    INACTIVE = "inactive"
    ACTIVE = "active"
    COMPLETE = "complete"
    CANCELLED = "cancelled"


def _progress() -> int:
    from ompi_tpu_torch.runtime.progress import progress

    return progress()


#: Empty progress polls before yielding the core.  On an oversubscribed
#: host (more ranks than cores) a waiter that keeps spinning holds its
#: scheduler quantum while the peer it waits on is runnable but
#: descheduled; yielding after a handful of empty polls costs ~1 µs on an
#: idle machine.
_YIELD_AFTER = 4
_SLEEP_AFTER = 64


def _idle_backoff(spins: int) -> None:
    """Escalating wait: spin, then sched_yield, then block on the
    transports' fds (the btl/sm doorbell; wakes in ~10 µs on arrival)."""
    if spins >= _SLEEP_AFTER:
        from ompi_tpu_torch.runtime.progress import idle_wait

        idle_wait(0.001)
    elif spins >= _YIELD_AFTER:
        time.sleep(0)          # bare yield: give the peer the core


class Request:
    """Base request; subclasses drive completion from the progress engine."""

    def __init__(self, persistent: bool = False):
        self.state = RequestState.INACTIVE if persistent else RequestState.ACTIVE
        self.persistent = persistent
        self.status = Status()
        self.error: Optional[MpiError] = None
        self._callbacks: list[Callable[["Request"], None]] = []
        self._lock = threading.Lock()

    # -- completion ------------------------------------------------------
    def on_complete(self, cb: Callable[["Request"], None]) -> None:
        fire = False
        with self._lock:
            if self.state in (RequestState.COMPLETE, RequestState.CANCELLED):
                fire = True
            else:
                self._callbacks.append(cb)
        if fire:
            cb(self)

    def complete(self, error: Optional[MpiError] = None) -> None:
        with self._lock:
            if self.state is RequestState.COMPLETE:
                return
            self.state = RequestState.COMPLETE
            self.error = error
            if error is not None:
                self.status.error = error.error_class
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    @property
    def complete_flag(self) -> bool:
        return self.state in (RequestState.COMPLETE, RequestState.CANCELLED)

    # -- MPI operations --------------------------------------------------
    def test(self) -> tuple[bool, Optional[Status]]:
        if self.persistent and self.state is RequestState.INACTIVE:
            return True, Status()    # MPI-3.1 §3.7.3: inactive → empty status
        if not self.complete_flag:
            _progress()
        if self.complete_flag:
            self._raise_if_error()
            return True, self.status
        return False, None

    def wait(self, timeout: Optional[float] = None) -> Status:
        """Spin in the progress engine until complete (``request.h:427``).
        An inactive persistent request returns the empty status at once
        (MPI-3.1 §3.7.3) instead of spinning forever."""
        if self.persistent and self.state is RequestState.INACTIVE:
            return Status()
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        while not self.complete_flag:
            made = _progress()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("request wait timed out")
            if made == 0:
                spins += 1
                _idle_backoff(spins)
            else:
                spins = 0
        self._raise_if_error()
        return self.status

    def get_status(self) -> tuple[bool, Optional[Status]]:
        """``MPI_Request_get_status``: like test() but errors surface in
        ``status.error`` rather than raising."""
        try:
            return self.test()
        except MpiError:
            return True, self.status

    def cancel(self) -> None:
        with self._lock:
            if self.state is RequestState.ACTIVE and self._try_cancel():
                self.state = RequestState.CANCELLED
                self.status.set_cancelled(True)

    def _try_cancel(self) -> bool:  # subclass hook
        return False

    def start(self) -> None:
        """Restart a persistent request (``MPI_Start``)."""
        if not self.persistent:
            raise MpiError(ErrorClass.ERR_REQUEST, "not a persistent request")
        if self.state is RequestState.ACTIVE:
            raise MpiError(ErrorClass.ERR_REQUEST, "already active")
        self.state = RequestState.ACTIVE
        self.status = Status()
        self.error = None
        self._start()

    def _start(self) -> None:  # subclass hook
        raise MpiError(ErrorClass.ERR_REQUEST, "not startable")

    def free(self) -> None:
        self.state = RequestState.INACTIVE

    def _raise_if_error(self) -> None:
        if self.error is not None:
            raise self.error


class CompletedRequest(Request):
    """Immediately-complete request (device collectives, empty ops,
    trivial sends)."""

    def __init__(self, status: Optional[Status] = None):
        super().__init__()
        if status is not None:
            self.status = status
        self.complete()


class PersistentP2P(Request):
    """A reusable communication specification (``MPI_Send_init`` and the
    persistent collectives): each ``start()`` issues a fresh inner request,
    whose completion and status are mirrored up.  Inactive until the first
    start."""

    def __init__(self, issue) -> None:
        super().__init__(persistent=True)
        self._issue = issue
        self._inner: Optional[Request] = None

    @property
    def result(self):
        """The inner request's payload (a persistent collective's output)."""
        return getattr(self._inner, "result", None)

    def _start(self) -> None:
        try:
            inner = self._issue()
        except MpiError as exc:
            # complete in error, so wait() returns and the request stays
            # restartable, then surface the error as the blocking call would
            self.complete(exc)
            raise
        self._inner = inner

        def mirror(r: Request) -> None:
            self.status = r.status
            self.complete(r.error)

        inner.on_complete(mirror)

    def _try_cancel(self) -> bool:
        if self._inner is None:
            return False
        self._inner.cancel()
        return self._inner.state is RequestState.CANCELLED


class GeneralizedRequest(Request):
    """``MPI_Grequest_start``: user-driven completion with query/free/cancel."""

    def __init__(self, query_fn=None, free_fn=None, cancel_fn=None):
        super().__init__()
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn

    def grequest_complete(self) -> None:
        if self._query_fn is not None:
            self._query_fn(self.status)
        self.complete()

    def _try_cancel(self) -> bool:
        if self._cancel_fn is not None:
            self._cancel_fn(False)
            return True
        return False

    def free(self) -> None:
        if self._free_fn is not None:
            self._free_fn()
        super().free()


# -- wait/test families (``ompi/request/req_wait.c`` / ``req_test.c``) ----

def waitall(requests: Sequence[Request],
            timeout: Optional[float] = None) -> list[Status]:
    errs = []
    stats = []
    for r in requests:
        try:
            stats.append(r.wait(timeout))
        except MpiError as e:
            errs.append(e)
            stats.append(r.status)
    if errs:
        raise MpiError(ErrorClass.ERR_IN_STATUS, f"{len(errs)} request(s) failed")
    return stats


def waitany(requests: Sequence[Request]) -> tuple[int, Status]:
    if not requests or all(r.state is RequestState.INACTIVE for r in requests):
        return UNDEFINED, Status()
    spins = 0
    while True:
        for i, r in enumerate(requests):
            if r.complete_flag:
                r._raise_if_error()
                return i, r.status
        made = _progress()
        spins = spins + 1 if made == 0 else 0
        _idle_backoff(spins)


def waitsome(requests: Sequence[Request]):
    """Returns ``(indices, statuses)``; ``(UNDEFINED, [])`` when the list
    holds no active request (outcount=MPI_UNDEFINED, MPI-3.1 §3.7.5)."""
    idx, _ = waitany(requests)
    if idx == UNDEFINED:
        return UNDEFINED, []
    out, stats = [], []
    for i, r in enumerate(requests):
        if r.complete_flag:
            r._raise_if_error()
            out.append(i)
            stats.append(r.status)
    return out, stats


def _inactive(r: Request) -> bool:
    """Inactive persistent requests don't participate in the wait/test
    families and count as trivially complete (MPI-3.1 §3.7.3/§3.7.5)."""
    return r.persistent and r.state is RequestState.INACTIVE


def testall(requests: Sequence[Request]) -> tuple[bool, Optional[list[Status]]]:
    _progress()
    if all(r.complete_flag or _inactive(r) for r in requests):
        out = []
        for r in requests:
            if _inactive(r):
                out.append(Status())
                continue
            r._raise_if_error()
            out.append(r.status)
        return True, out
    return False, None


def testany(requests: Sequence[Request]) -> tuple[bool, int, Optional[Status]]:
    _progress()
    active = False
    for i, r in enumerate(requests):
        if _inactive(r):
            continue
        active = True
        if r.complete_flag:
            r._raise_if_error()
            return True, i, r.status
    if not active:
        return True, UNDEFINED, Status()
    return False, UNDEFINED, None


def testsome(requests: Sequence[Request]):
    """Returns ``(indices, statuses)``; ``(UNDEFINED, [])`` when the list
    holds no active request (outcount=MPI_UNDEFINED, MPI-3.1 §3.7.5)."""
    _progress()
    if not requests or all(r.state is RequestState.INACTIVE
                           for r in requests):
        return UNDEFINED, []
    out, stats = [], []
    for i, r in enumerate(requests):
        if r.complete_flag:
            r._raise_if_error()
            out.append(i)
            stats.append(r.status)
    return out, stats


def start_all(requests: Iterable[Request]) -> None:
    """``MPI_Startall``."""
    for r in requests:
        r.start()


startall = start_all   # MPI spelling
