"""monitoring — per-peer traffic matrices (pml/coll/osc interposition).

Copy of ``ompi_tpu/runtime/monitoring.py`` (after the reference's
``ompi/mca/common/monitoring/common_monitoring.h:48-91`` and the
pml/coll/osc ``monitoring`` interposition components): when enabled
(``otpu_monitoring_enable``), every point-to-point send is recorded into a per-(src, dst) byte/message matrix,
and every collective invocation into per-collective counters — the data the
reference exports through MPI_T pvars and dumps at finalize.

The interposition points are the pml module (wrapped at selection time,
the ``pml/monitoring`` slot) and the per-comm c_coll table (wrapped after
``comm_select``, the ``coll/monitoring`` slot).

A buffer's byte count is its ``nbytes`` attribute (:func:`nbytes_of`): a
tensor's, on the CPU or the card, with no host copy.  The reference reads
``np.asarray(buf).nbytes``, the same number for a ``jax.Array`` (its
host copy's size); on a card tensor that conversion fails, so the port
reads the attribute and falls back to numpy only for buffers without one
(lists, scalars, bytes), where the two agree.
"""
from __future__ import annotations

import atexit
import threading
from typing import Optional

import numpy as np

from ompi_tpu_torch.base.var import VarType, registry

_enable_var = registry.register(
    "monitoring", None, "enable", vtype=VarType.BOOL, default=False,
    help="Record per-peer p2p byte/message matrices and per-collective "
         "counters (pml/coll monitoring interposition)")
_dump_var = registry.register(
    "monitoring", None, "dump_at_exit", vtype=VarType.BOOL, default=False,
    help="Print the monitoring matrices at finalize (stderr)")

_lock = threading.Lock()
# (src_world, dst_world) -> [messages, bytes]
_p2p: dict[tuple[int, int], list] = {}
# (coll_name) -> [calls, bytes]
_coll: dict[str, list] = {}
_osc: dict[str, list] = {}


def enabled() -> bool:
    return bool(_enable_var.value)


def nbytes_of(buf) -> int:
    """Bytes of a send buffer or collective operand, with no host copy of a
    tensor (see the module docstring)."""
    nb = getattr(buf, "nbytes", None)
    if nb is None:
        return int(np.asarray(buf).nbytes)
    return int(nb)


def record_p2p(src: int, dst: int, nbytes: int) -> None:
    with _lock:
        cell = _p2p.setdefault((src, dst), [0, 0])
        cell[0] += 1
        cell[1] += nbytes


def record_coll(name: str, nbytes: int) -> None:
    with _lock:
        cell = _coll.setdefault(name, [0, 0])
        cell[0] += 1
        cell[1] += nbytes


def record_osc(op: str, nbytes: int) -> None:
    with _lock:
        cell = _osc.setdefault(op, [0, 0])
        cell[0] += 1
        cell[1] += nbytes


def p2p_matrix(n: Optional[int] = None):
    """(msgs, bytes) matrices as dense numpy arrays over world ranks."""
    with _lock:
        if not _p2p and not n:
            return np.zeros((0, 0), np.int64), np.zeros((0, 0), np.int64)
        size = n or (max(max(s, d) for s, d in _p2p) + 1)
        msgs = np.zeros((size, size), np.int64)
        byts = np.zeros((size, size), np.int64)
        for (s, d), (m, b) in _p2p.items():
            if s < size and d < size:
                msgs[s, d] = m
                byts[s, d] = b
        return msgs, byts


def coll_counters() -> dict:
    with _lock:
        return {k: tuple(v) for k, v in _coll.items()}


def osc_counters() -> dict:
    with _lock:
        return {k: tuple(v) for k, v in _osc.items()}


def reset() -> None:
    with _lock:
        _p2p.clear()
        _coll.clear()
        _osc.clear()


def summary() -> str:
    lines = ["monitoring: per-peer p2p matrix (src -> dst: msgs/bytes)"]
    with _lock:
        for (s, d) in sorted(_p2p):
            m, b = _p2p[(s, d)]
            lines.append(f"  {s} -> {d}: {m} msgs, {b} bytes")
        for name in sorted(_coll):
            c, b = _coll[name]
            lines.append(f"  coll {name}: {c} calls, {b} bytes")
        for name in sorted(_osc):
            c, b = _osc[name]
            lines.append(f"  osc {name}: {c} calls, {b} bytes")
    return "\n".join(lines)


class MonitoringPml:
    """pml/monitoring: records, then forwards to the real pml module."""

    def __init__(self, inner) -> None:
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _record(self, comm, buf, dest) -> None:
        grp = comm.remote_group if comm.is_inter else comm.group
        try:
            dst_world = grp.world_rank(dest)
        except Exception:
            return
        record_p2p(comm.world_rank(comm.rank), dst_world, nbytes_of(buf))

    def send(self, comm, buf, dest, tag, **kw):
        self._record(comm, buf, dest)
        return self._inner.send(comm, buf, dest, tag, **kw)

    def isend(self, comm, buf, dest, tag, **kw):
        self._record(comm, buf, dest)
        return self._inner.isend(comm, buf, dest, tag, **kw)


_COLL_BYTES_ARG = {"bcast", "allreduce", "reduce", "allgather", "alltoall",
                   "reduce_scatter", "gather", "scatter", "scan", "exscan",
                   "allreduce_array", "bcast_array", "allgather_array",
                   "reduce_scatter_array", "alltoall_array"}


def wrap_coll_table(comm) -> None:
    """coll/monitoring: wrap every selected c_coll slot with a recorder."""
    if not enabled():
        return

    def make(name, fn):
        def wrapped(comm_arg, *args, **kw):
            nbytes = 0
            if name in _COLL_BYTES_ARG and args:
                try:
                    nbytes = nbytes_of(args[0])
                except Exception:
                    nbytes = 0
            record_coll(name, nbytes)
            return fn(comm_arg, *args, **kw)

        wrapped.__monitored__ = True
        wrapped.__self__ = getattr(fn, "__self__", None)
        return wrapped

    for name, fn in list(comm.c_coll.items()):
        if not getattr(fn, "__monitored__", False):
            comm.c_coll[name] = make(name, fn)


def maybe_wrap_pml(pml_module):
    """Interpose the pml when monitoring is on (pml/monitoring slot)."""
    if enabled():
        return MonitoringPml(pml_module)
    return pml_module


_KV_KEY = "otpu_monitoring"


def finalize_publish(rte) -> None:
    """Publish this rank's monitoring matrices into the coord KV at
    finalize (instance teardown, while the client is still alive) so
    the launcher can print ONE job-wide communication matrix instead of
    requiring N interleaved per-rank atexit dumps.  The explicit
    ``monitoring_dump_at_exit`` dump is NOT suppressed by the publish:
    only a launcher that actually gathers the KV prints the merged
    view, and a non-tpurun embedding must not lose its matrices."""
    if not enabled():
        return
    client = getattr(rte, "client", None)
    if client is None:
        return
    import json

    rank = int(getattr(rte, "my_world_rank", 0) or 0)
    with _lock:
        payload = {
            "rank": rank,
            "p2p": [[s, d, m, b] for (s, d), (m, b) in
                    sorted(_p2p.items())],
            "coll": {k: list(v) for k, v in _coll.items()},
            "osc": {k: list(v) for k, v in _osc.items()},
        }
    client.put(rank, _KV_KEY, json.dumps(payload))


def merged_summary(payloads: list, nprocs: int) -> str:
    """Launcher-side job-wide view: sum every rank's published p2p
    matrix into one ``src -> dst`` table plus per-collective totals
    (``tpurun`` prints this at job end when monitoring ran)."""
    p2p: dict = {}
    coll: dict = {}
    for p in payloads:
        for s, d, m, b in p.get("p2p", []):
            cell = p2p.setdefault((int(s), int(d)), [0, 0])
            cell[0] += int(m)
            cell[1] += int(b)
        for name, (c, b) in p.get("coll", {}).items():
            cell = coll.setdefault(name, [0, 0])
            cell[0] += int(c)
            cell[1] += int(b)
    lines = [f"monitoring: job-wide p2p matrix ({nprocs} ranks, "
             f"{len(payloads)} reporting; src -> dst: msgs/bytes)"]
    for (s, d) in sorted(p2p):
        m, b = p2p[(s, d)]
        lines.append(f"  {s} -> {d}: {m} msgs, {b} bytes")
    for name in sorted(coll):
        c, b = coll[name]
        lines.append(f"  coll {name}: {c} calls, {b} bytes")
    return "\n".join(lines)


def _atexit_dump() -> None:
    if enabled() and bool(_dump_var.value):
        import sys

        print(summary(), file=sys.stderr, flush=True)


atexit.register(_atexit_dump)
