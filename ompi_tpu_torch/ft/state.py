"""Global failure state: the set of world ranks known dead.

Copy of ``ompi_tpu/ft/state.py`` (after the reference's proc-failure
bookkeeping, ``ompi/proc/proc.c`` and ``ompi/communicator/ft/comm_ft.c``):
the detector and the propagator feed this set, and the API-level liveness
checks (``ompi/mpi/c/send.c:84``) read it.  Revocations are keyed by
``(scope, cid, epoch)``, so a CID reused in a later epoch is not taken for
the revoked one.  In the device world a virtual rank marked failed is a
local fact of the one process.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable

_lock = threading.Lock()
_failed: set[int] = set()
_listeners: list[Callable[[int], None]] = []
_revoked_cids: set[tuple] = set()  # (job, cid, epoch)


def mark_failed(world_rank: int) -> None:
    with _lock:
        if world_rank in _failed:
            return
        _failed.add(world_rank)
        listeners = list(_listeners)
    for cb in listeners:
        cb(world_rank)


def is_failed(world_rank: int) -> bool:
    return world_rank in _failed


def failed_ranks() -> frozenset:
    with _lock:
        return frozenset(_failed)


def on_failure(cb: Callable[[int], None]) -> None:
    """Register a callback fired once per newly-detected failure."""
    with _lock:
        _listeners.append(cb)


def mark_revoked(cid: int, epoch: int = 0, job: str = "0") -> None:
    """Record a communicator revocation (``comm_ft_revoke.c``).

    Keyed by (cid, epoch) so a reused CID in a later epoch is not confused
    with the revoked incarnation (``comm_cid.c:73-78``).
    """
    with _lock:
        _revoked_cids.add((job, cid, epoch))


def is_comm_revoked(cid: int, epoch: int = 0, job: str = "0") -> bool:
    return (job, cid, epoch) in _revoked_cids


def is_revoked_key(key: tuple) -> bool:
    """Hot-path variant: membership probe on a prebuilt (job, cid, epoch)
    key — comms cache their key so _check_state costs one set lookup."""
    return key in _revoked_cids


def reset_for_testing() -> None:
    with _lock:
        _failed.clear()
        _listeners.clear()
        _revoked_cids.clear()
