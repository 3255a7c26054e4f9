"""Debugger handle introspection — the MPIR / debugger-DLL analog.

Copy of ``ompi_tpu/runtime/debugger.py`` with its imports re-pointed, after
Open MPI's ``ompi/debuggers/ompi_common_dll.c`` + ``ompi_msgq_dll.c``:
parallel debuggers (TotalView, DDT) attach to an MPI job and walk the
library's internal handle tables — the communicator list, the three
per-communicator message queues (posted receives, unexpected messages,
pending sends), and the MPIR proctable — through a compiled
debugger-support DLL that knows the struct layouts.

This analog needs no struct-layout DLL: debuggers here attach with
pdb/py-spy or query over the launcher, so the same three views are
exposed as plain data (the proc table's rows carry the reference's keys
and, beside them, the ``device`` a rank's world binds to where this
process knows it):

- :func:`comm_table` — every live communicator (the handle-table walk).
- :func:`message_queues` — pml/ob1 matching state per (cid, rank):
  posted receives, unexpected frags, out-of-order frags, active
  send/recv requests (the ``mqs_setup_operation_iterator`` views).
- :func:`proc_table` — MPIR_proctable analog (world ranks, node, pid,
  device).
- :func:`dump` — everything, as one plain dict (otpu_info --debug-dump).
"""
from __future__ import annotations

import os
from typing import Any, Optional


def comm_table() -> list:
    """One row per live communicator, ``ompi_common_dll``'s
    communicator iteration."""
    from ompi_tpu_torch.api.comm import live_comms

    rows = []
    for c in live_comms():
        if getattr(c, "freed", False):
            continue
        rows.append({
            "cid": c.cid, "epoch": c.epoch, "name": c.name,
            "rank": c.rank, "size": c.size,
            "peers": list(c.group.world_ranks),
            "inter": bool(c.remote_group is not None),
            "topo": type(c.topo).__name__ if c.topo is not None else None,
            "revoked": bool(getattr(c, "revoked", False)),
        })
    return rows


def _frag_row(frag) -> dict:
    data = getattr(frag, "data", None)
    return {"src": frag.src, "tag": frag.tag,
            "seq": getattr(frag, "seq", None),
            "nbytes": 0 if data is None else len(data),
            "kind": getattr(frag, "kind", None)}


def _req_row(req) -> dict:
    return {"peer": getattr(req, "dest", getattr(req, "source", None)),
            "tag": getattr(req, "tag", None),
            "nbytes": getattr(req, "nbytes", None),
            "complete": bool(getattr(req, "complete", False)),
            "type": type(req).__name__}


def _find_ob1(pml):
    """Unwrap interposition layers (monitoring, vprotocol) down to the
    matching engine that owns the queues."""
    seen = set()
    while pml is not None and id(pml) not in seen:
        seen.add(id(pml))
        if hasattr(pml, "_match"):
            return pml
        pml = getattr(pml, "pml", getattr(pml, "_pml", None))
    return None


def message_queues(comm=None) -> list:
    """The three MPIR message queues per (cid, receiver-rank) matching
    state — ``ompi_msgq_dll.c``'s pending-receive / unexpected /
    pending-send iterations."""
    from ompi_tpu_torch.api.comm import live_comms

    comms = [comm] if comm is not None else [
        c for c in live_comms() if not getattr(c, "freed", False)]
    rows = []
    for c in comms:
        ob1 = _find_ob1(getattr(c, "pml", None))
        if ob1 is None:
            continue
        with ob1._lock:
            for (cid, rank), st in ob1._match.items():
                if cid != c.cid:
                    continue
                rows.append({
                    "cid": cid, "rank": rank,
                    "posted_recvs": [_req_row(r) for r in st.posted],
                    "unexpected": [_frag_row(f) for f in st.unexpected],
                    "out_of_order": {
                        src: sorted(frags)
                        for src, frags in ((s, list(d)) for s, d in
                                           st.ooo.items()) if frags},
                })
            pending_sends = [_req_row(r)
                             for r in ob1._send_reqs.values()
                             if getattr(r, "comm", None) is c]
            pending_recvs = [_req_row(r)
                             for r in ob1._recv_reqs.values()
                             if getattr(r, "comm", None) is c]
        if pending_sends or pending_recvs:
            rows.append({"cid": c.cid, "active_send_requests":
                         pending_sends,
                         "active_recv_requests": pending_recvs})
    return rows


def proc_table(rte=None) -> list:
    """MPIR_proctable analog: every world rank the runtime knows, with
    node identity and (where local) the pid."""
    if rte is None:
        from ompi_tpu_torch.runtime import init as rt

        rte = getattr(rt, "_rte", None)
    if rte is None:
        return []
    rows = []
    # every world rank: the reference reads ``rte.nprocs``, which its rte
    # does not have, and so lists rank 0 alone
    n = getattr(rte, "world_size", 1)
    me = getattr(rte, "my_world_rank", 0)
    for rank in range(n):
        dev = rte.device_of(rank)
        rows.append({
            "rank": rank,
            "node": (os.environ.get("OTPU_NODE_ID")
                     if rank == me else None),
            "pid": os.getpid() if rank == me else None,
            "is_me": rank == me,
            "device": None if dev is None else str(dev),
        })
    return rows


def dump(comm: Optional[Any] = None) -> dict:
    """Everything a debugger wants, as one plain dict."""
    return {"comms": comm_table(),
            "message_queues": message_queues(comm),
            "procs": proc_table()}
