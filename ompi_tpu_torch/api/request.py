"""Requests: the lifecycle of the persistent device collectives.

Copy of ``Request``, ``CompletedRequest`` and ``PersistentP2P`` from
``ompi_tpu/api/request.py:78-271``.  The device world has no progress engine:
every device request is born complete (the stream is the progress engine),
so ``wait`` and ``test`` never have to drive one.  Not ported yet: the
progress-driven wait of host requests, the partitioned hooks
(``pready``/``parrived``), ``GeneralizedRequest`` and the wait/test
families; they come with the host tier.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Optional

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.status import Status


class RequestState(enum.Enum):
    INACTIVE = "inactive"
    ACTIVE = "active"
    COMPLETE = "complete"
    CANCELLED = "cancelled"


class Request:
    """Base request; a subclass completes it."""

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
        if self.complete_flag:
            self._raise_if_error()
            return True, self.status
        return False, None

    def wait(self, timeout: Optional[float] = None) -> Status:
        """Wait until complete; an inactive persistent request returns the
        empty status at once (MPI-3.1 §3.7.3).  With nothing to progress,
        an incomplete request only yields the core while it waits."""
        if self.persistent and self.state is RequestState.INACTIVE:
            return Status()
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.complete_flag:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("request wait timed out")
            time.sleep(0)
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
    """Immediately-complete request (device collectives, empty ops)."""

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
