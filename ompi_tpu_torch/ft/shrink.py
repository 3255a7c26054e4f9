"""``MPIX_Comm_shrink`` (``ompi/communicator/ft/comm_ft.c``
``ompi_comm_shrink_internal``).

Copy of ``ompi_tpu/ft/shrink.py``: (1) agree on the failed set, (2) build
the survivor group, (3) take a fresh CID and bump the FT epoch, so the new
communicator cannot be confused with the revoked or damaged parent
(``comm_cid.c:73-78``).  In the device world the one process's failure
knowledge is the agreement: the survivors and ``next_local_cid``.  In the
multi-process world two ``agree_kv`` rounds over the coordination service:
the union of failed sets with the MAX of proposed CIDs, then a check that
the MAX is free on every survivor (re-proposed above it otherwise).  Every
survivor then publishes the agreed survivors as the dynamic pset
``mpi://shrunk/<cid>`` (``shrink.py:76``), so a recovery loop or a fresh
session rebuilds from it by name.
"""
from __future__ import annotations

from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.ft import state as ft_state


def shrink(comm):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.runtime import init as rt

    members = list(comm.group.world_ranks)

    if comm.rte is None or comm.rte.is_device_world:
        # single-controller model: failure knowledge is already uniform
        survivors = [r for r in members if not ft_state.is_failed(r)]
        cid = rt.next_local_cid()
    else:
        from ompi_tpu_torch.ft.agreement import agree_kv

        seq = comm._ft_seq = getattr(comm, "_ft_seq", 0) + 1

        def combine(a, b):
            return (a[0] | b[0], max(a[1], b[1]), min(a[2], b[2]))

        live = [r for r in members if not ft_state.is_failed(r)]
        # multi-round: propose (unreserved) candidate, confirm the MAX is
        # free on every survivor; re-propose above it on conflict
        floor, attempt, prev_ok = 0, 0, True
        while True:
            attempt += 1
            proposed = rt.candidate_cid(floor)
            key = ("shrink", comm.cid, comm.epoch, seq, attempt)
            (failed_bits, cid, _), agreed_failed = agree_kv(
                comm.rte, key,
                (_bits(members, ft_state.failed_ranks()), proposed, 1),
                live, combine,
                prev_instance=(("shrink", comm.cid, comm.epoch, seq - 2,
                                attempt) if seq > 2 and prev_ok else None),
            )
            okkey = ("shrinkok", comm.cid, comm.epoch, seq, attempt)
            (_, _, all_ok), _ = agree_kv(
                comm.rte, okkey,
                (0, 0, 1 if rt.is_cid_free(cid) else 0),
                live, combine)
            if all_ok:
                break
            floor, prev_ok = cid + 1, False
        dead = {r for r in agreed_failed} | _unbits(members, failed_bits)
        survivors = [r for r in members if r not in dead]

    rt.reserve_cid(cid)
    newcomm = Comm(Group(survivors), cid, comm.rte,
                   name=f"{comm.name}~shrink", epoch=comm.epoch + 1,
                   parent=comm)
    comm._finish_create(newcomm)
    # dynamic pset: the agreed surviving set under a stable name
    # (Group_from_session_pset + Comm_create_from_group instead of
    # threading the survivor list through application state).  Every
    # survivor publishes the same agreed value; the write is idempotent.
    client = getattr(comm.rte, "client", None)
    if client is not None:
        try:
            client.pset_publish(f"mpi://shrunk/{cid}", survivors,
                                source="dynamic")
        except Exception:
            pass   # coord gone: shrink itself already succeeded
    return newcomm


def _bits(members, failed) -> int:
    out = 0
    for i, r in enumerate(members):
        if r in failed:
            out |= 1 << i
    return out


def _unbits(members, bits: int) -> set:
    return {r for i, r in enumerate(members) if bits >> i & 1}
