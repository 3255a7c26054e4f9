"""Global failure state: the set of world ranks known dead.

Copy of ``ompi_tpu/ft/state.py`` (after the reference's proc-failure
bookkeeping, ``ompi/proc/proc.c`` and ``ompi/communicator/ft/comm_ft.c``):
the detector and the propagator feed this set, and the API-level liveness
checks (``ompi/mpi/c/send.c:84``) read it.  Revocations are keyed by
``(scope, cid, epoch)``, so a CID reused in a later epoch is not taken for
the revoked one.  In the device world a virtual rank marked failed is a
local fact of the one process.

Unlike the reference, a revocation also has listeners (``on_revoke``):
pml/ob1 completes the comm's pending point-to-point requests with
``RevokedError`` when the revocation lands, as ULFM's revoke requires
(``comm_ft_revoke.c`` → ``pml_revoke_comm``), so a rank blocked in a
receive from a live peer that has left the operation to recover is
released instead of waiting for that peer's death.  For the same reason a
revocation reaches the sub-communicators that coll/han runs the revoked
comm's collectives on (``link_revocation``): a rank blocked in han's
intra-node step on a live peer that has left to recover is released too.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable

_lock = threading.Lock()
_failed: set[int] = set()
_listeners: list[Callable[[int], None]] = []
_revoked_cids: set[tuple] = set()  # (job, cid, epoch)
_revoke_listeners: list[Callable[[str, int, int], None]] = []
#: revocation key -> the keys of the sub-communicators revoked with it
_revoke_children: dict[tuple, list[tuple]] = {}


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
    key = (job, cid, epoch)
    with _lock:
        if key in _revoked_cids:
            return
        _revoked_cids.add(key)
        listeners = list(_revoke_listeners)
        children = _revoke_children.pop(key, ())
    for cb in listeners:
        cb(job, cid, epoch)
    for cjob, ccid, cepoch in children:
        mark_revoked(ccid, cepoch, cjob)


def link_revocation(parent: tuple, children: list) -> None:
    """Revoke each of ``children`` with ``parent`` (``(job, cid, epoch)``
    keys): the sub-communicators coll/han carries the parent's collectives
    on.  A parent revoked already revokes them now."""
    with _lock:
        if parent not in _revoked_cids:
            _revoke_children.setdefault(parent, []).extend(children)
            return
    for job, cid, epoch in children:
        mark_revoked(cid, epoch, job)


def unlink_revocation(parent: tuple) -> None:
    """Forget ``parent``'s sub-communicators (freed with their module)."""
    with _lock:
        _revoke_children.pop(parent, None)


def on_revoke(cb: Callable[[str, int, int], None]) -> None:
    """Register a callback fired once per newly-recorded revocation, with
    its (job, cid, epoch)."""
    with _lock:
        _revoke_listeners.append(cb)


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
        _revoke_listeners.clear()
        _revoke_children.clear()
