"""MPI buffered-send machinery (``MPI_Buffer_attach`` / ``MPI_Bsend``).

Copy of ``ompi_tpu/api/buffer.py``, after the reference's
``ompi/mpi/c/buffer_attach.c`` + the bsend allocator
(``ompi/runtime/ompi_mpi_init.c`` pml base bsend).  One buffer per
process; Bsend copies the message out of the user's buffer immediately
(so the user may reuse it on return) and accounts the copy against the
attached capacity until the underlying send completes.  Detach blocks
until every buffered send has drained — the MPI semantic tools rely on.
"""
from __future__ import annotations

import threading

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError

BSEND_OVERHEAD = 64     # accounting slack per message (MPI_BSEND_OVERHEAD)

_lock = threading.Lock()
_capacity = 0
_in_use = 0
_pending: list = []
_attached_obj = None


def attach(buf) -> None:
    """``MPI_Buffer_attach``: int size or a numpy buffer (its nbytes)."""
    global _capacity, _in_use, _attached_obj
    with _lock:
        if _attached_obj is not None:
            raise MpiError(ErrorClass.ERR_BUFFER,
                           "a bsend buffer is already attached")
        nbytes = int(buf) if isinstance(buf, (int, np.integer)) \
            else int(np.asarray(buf).nbytes)
        _attached_obj = buf
        _capacity = nbytes
        _in_use = 0


def detach():
    """``MPI_Buffer_detach``: waits for all buffered sends, returns the
    attached buffer (or its size)."""
    global _capacity, _in_use, _attached_obj
    with _lock:
        if _attached_obj is None:
            raise MpiError(ErrorClass.ERR_BUFFER, "no bsend buffer attached")
        pending = list(_pending)
    for req in pending:
        try:
            req.wait()
        except Exception:
            # a buffered send to a dead peer completes in error; the
            # detach must still succeed (the buffer IS drained — the
            # message just won't arrive), or buffered sends would be
            # bricked for the rest of the process
            pass
    with _lock:
        obj = _attached_obj
        _attached_obj = None
        _capacity = 0
        _in_use = 0
        _pending.clear()
    return obj


def claim(nbytes: int) -> None:
    """Reserve bsend space for one message (raises if it can't fit)."""
    global _in_use
    need = nbytes + BSEND_OVERHEAD
    with _lock:
        if _attached_obj is None:
            raise MpiError(ErrorClass.ERR_BUFFER,
                           "MPI_Bsend without an attached buffer")
        if _in_use + need > _capacity:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"bsend buffer exhausted ({_in_use}+{need} > {_capacity})")
        _in_use += need


def release(nbytes: int) -> None:
    """Undo a claim whose send was never issued (isend raised)."""
    global _in_use
    with _lock:
        _in_use = max(0, _in_use - (nbytes + BSEND_OVERHEAD))


def track(req, nbytes: int) -> None:
    """Release the claim when the underlying send completes."""
    def done(_r, n=nbytes + BSEND_OVERHEAD):
        global _in_use
        with _lock:
            _in_use = max(0, _in_use - n)
            if req in _pending:
                _pending.remove(req)

    with _lock:
        _pending.append(req)
    req.on_complete(done)


def reset_for_testing() -> None:
    global _capacity, _in_use, _attached_obj
    with _lock:
        _capacity = 0
        _in_use = 0
        _attached_obj = None
        _pending.clear()
