"""coll/sm — shared-memory collectives on a mapped segment.

Copy of ``ompi_tpu/mca/coll/sm_coll.py`` (after the reference's
``ompi/mca/coll/sm/``): the ranks of a single-node communicator map one
shared segment and run bcast, allreduce, reduce and barrier through it
directly — one copy in, one copy out, no per-fragment framing through the
btl rings.  Synchronization uses monotonically increasing shared counters
(the native core's atomics), so no reset races exist: round ``k`` of an
operation waits for its counter to reach ``k * n``.

Segment layout::

    [ bar_arrive u64 | bc_gen u64 | bc_readers u64 | ar_arrive u64 |
      ar_done u64 | pad to 64 ]
    [ bcast buffer: slot ]
    [ n contribution slots: slot each ]

Payloads larger than the slot (``otpu_coll_sm_coll_slot_size``, 2 MB) fall
through to the next coll module down the comm's stack (coll/tuned's
ladders; coll/basic only when nothing else is selected).  Priority 35,
between tuned (30) and han (40); it declines in the device world, on a
comm that spans nodes, and without the native core (``:259-280``).  A
tensor is staged to the host once, at a slot's entry.  The segment's name
carries the port's prefix (``otpt_csm``).  Not copied: the FT branch of
the counter wait (a failed member turns the wait into ``ProcFailedError``,
``:157-172``; ROADMAP A 4).
"""
from __future__ import annotations

import os
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.output import register_help, show_help
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.btl.sm import NAME_PREFIX, _attach
from ompi_tpu_torch.mca.coll.basic import BasicCollModule, staged

_HDR = 64
_BAR_ARRIVE = 0
_BC_GEN = 8
_BC_READERS = 16
_AR_ARRIVE = 24
_AR_DONE = 32


class SmCollModule:
    def __init__(self, component: "SmCollComponent") -> None:
        self._c = component
        self._fallback = BasicCollModule()
        self._seg = None
        self._addr = 0
        self._slot = int(component.slot_var.value)
        self._rounds = {"bar": 0, "bc": 0, "ar": 0}

    # -- lifecycle -------------------------------------------------------
    def comm_enable(self, comm) -> None:
        from ompi_tpu_torch import native

        self._native = native
        # above-slot fallback: the next provider DOWN the comm's own coll
        # stack (normally coll/tuned's decision ladders — measured ~25%
        # faster than coll/basic at 4MB), honoring the user's component
        # include/exclude instead of hardcoding basic
        try:
            mine = comm.coll_modules.index(self)
            found = next(
                (m for m in reversed(comm.coll_modules[:mine])
                 if hasattr(m, "allreduce") and hasattr(m, "bcast")),
                None)
            if found is not None:
                self._fallback = found
            else:
                show_help("help-coll-sm", "no-fallback", comm=comm.name)
        except (ValueError, AttributeError):
            pass
        n = comm.size
        size = _HDR + self._slot * (n + 1)
        tag = os.environ.get("OTPU_COORD", "l").replace(":", "_") \
            .replace(".", "_")
        rte = comm.rte
        name = f"{NAME_PREFIX}_csm_{tag}_{comm.cid}"
        try:
            if comm.rank == 0:
                shm = shared_memory.SharedMemory(name=name, create=True,
                                                 size=size)
                shm.buf[:_HDR] = b"\0" * _HDR
                rte.modex_put(f"coll_sm_{comm.cid}", name)
            else:
                # rank 0 publishes during ITS comm_enable; comm creation
                # is collective so the blocking get cannot deadlock
                got = rte.modex_get(comm.group.world_rank(0),
                                    f"coll_sm_{comm.cid}")
                if got is False:
                    raise OSError("peer could not create the segment")
                shm = _attach(got)
        except OSError as exc:
            # constrained /dev/shm (container defaults are as small as
            # 64MB): surrender the slots to the fallback module instead
            # of failing the communicator.  rank 0 publishes False so
            # peers don't block on a name that will never appear.
            if comm.rank == 0:
                rte.modex_put(f"coll_sm_{comm.cid}", False)
            show_help("help-coll-sm", "no-segment", comm=comm.name,
                      error=str(exc))
            shm = None
        # the enable/disable decision must be COLLECTIVE: one rank whose
        # attach failed running message-based collectives while the rest
        # spin on shared counters would hang the communicator.  Vote over
        # the fallback module (comm creation is collective, so everyone
        # is here).
        ok = np.array([1 if shm is not None else 0], np.int64)
        all_ok = int(np.asarray(self._fallback.allreduce(
            comm, ok, op_mod.MIN)).ravel()[0])
        if not all_ok:
            if shm is not None:
                try:
                    shm.close()
                    if comm.rank == 0:
                        shm.unlink()
                except OSError:
                    pass
            self._seg = None
            return
        self._seg = shm
        self._buf = np.frombuffer(shm.buf, np.uint8, offset=_HDR)
        self._addr = self._buf.ctypes.data - _HDR
        self._owner = comm.rank == 0

    def comm_unquery(self, comm) -> None:
        if self._seg is not None:
            try:
                self._buf = None
                self._seg.close()
            except Exception:
                pass
            if self._owner:
                try:
                    self._seg.unlink()
                except Exception:
                    pass
            self._seg = None

    # -- shared-counter helpers ------------------------------------------
    def _wait_at_least(self, off: int, target: int) -> None:
        """Spin until the shared counter reaches ``target``."""
        from ompi_tpu_torch.runtime.progress import progress

        while self._native.atomic_load_u64(self._addr + off) < target:
            # keep the transports moving: a peer may be unable to reach
            # this collective until our queued btl output (pending
            # rendezvous frags) drains — spinning without progress would
            # deadlock the pair
            progress()
            time.sleep(0)

    def _bump(self, off: int) -> None:
        self._native.atomic_add_i64(self._addr + off, 1)

    def _bc_buf(self) -> np.ndarray:
        return self._buf[:self._slot]

    def _slot_buf(self, rank: int) -> np.ndarray:
        start = self._slot * (rank + 1)
        return self._buf[start:start + self._slot]

    # -- collectives ------------------------------------------------------
    def barrier(self, comm) -> None:
        if self._seg is None:
            return self._fallback.barrier(comm)
        self._rounds["bar"] += 1
        self._bump(_BAR_ARRIVE)
        self._wait_at_least(_BAR_ARRIVE, self._rounds["bar"] * comm.size)

    def bcast(self, comm, buf, root=0):
        arr = np.ascontiguousarray(staged(buf))
        if self._seg is None or arr.nbytes > self._slot:
            return self._fallback.bcast(comm, arr, root)
        self._rounds["bc"] += 1
        rnd, n = self._rounds["bc"], comm.size
        if comm.rank == root:
            # previous round's readers must be done before overwriting
            self._wait_at_least(_BC_READERS, (rnd - 1) * (n - 1))
            self._bc_buf()[:arr.nbytes] = arr.view(np.uint8).reshape(-1)
            self._native.atomic_store_u64(self._addr + _BC_GEN, rnd)
            return arr
        self._wait_at_least(_BC_GEN, rnd)
        out = np.empty_like(arr)
        out.view(np.uint8).reshape(-1)[:] = self._bc_buf()[:arr.nbytes]
        self._bump(_BC_READERS)
        return out

    def allreduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM):
        arr = np.ascontiguousarray(staged(sendbuf))
        if self._seg is None or arr.nbytes > self._slot:
            return self._fallback.allreduce(comm, arr, op)
        self._rounds["ar"] += 1
        rnd, n = self._rounds["ar"], comm.size
        # everyone from the previous round must have finished reading the
        # slots before this round's writes
        self._wait_at_least(_AR_DONE, (rnd - 1) * n)
        me = self._slot_buf(comm.rank)
        me[:arr.nbytes] = arr.view(np.uint8).reshape(-1)
        self._bump(_AR_ARRIVE)
        self._wait_at_least(_AR_ARRIVE, rnd * n)
        # fold in rank order (non-commutative safe), each rank locally —
        # the coll/sm tradeoff: n-fold small compute for zero messages
        acc = np.array(self._slot_buf(n - 1)[:arr.nbytes]
                       .view(arr.dtype), copy=True)
        for r in range(n - 2, -1, -1):
            contrib = np.array(self._slot_buf(r)[:arr.nbytes]
                               .view(arr.dtype), copy=True)
            op(contrib, acc)
        self._bump(_AR_DONE)
        return acc.reshape(arr.shape)

    def reduce(self, comm, sendbuf, op: op_mod.Op = op_mod.SUM, root=0):
        out = self.allreduce(comm, sendbuf, op)
        return out if comm.rank == root else None


class SmCollComponent(Component):
    name = "sm_coll"
    priority = 35

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=35,
            help="Selection priority of coll/sm (mapped-segment colls)")
        self.slot_var = self.register_var(
            "slot_size", vtype=VarType.SIZE, default="2m",
            help="Per-rank shared slot size; larger payloads fall through "
                 "to the next coll module (measured crossover vs the "
                 "tuned ring ~2-4MB on the oversubscribed host path)")

    def comm_query(self, comm):
        rte = comm.rte
        if rte is None or rte.is_device_world:
            return None
        if comm.size < 2 or comm.is_inter:
            return None
        if getattr(rte, "client", None) is None:
            return None
        try:
            from ompi_tpu_torch import native

            if not native.available():
                return None
            my_node = rte.node_of(rte.my_world_rank)
            if my_node is None:
                return None
            for w in comm.group.world_ranks:
                if rte.node_of(w) != my_node:
                    return None
        except Exception:
            return None
        return self._prio.value, SmCollModule(self)


COMPONENT = SmCollComponent()

register_help(
    "help-coll-sm", "no-segment",
    "coll/sm on {comm} could not create/attach its shared segment "
    "({error}); mapped-segment collectives are disabled for this "
    "communicator and the next coll module serves everything.")
register_help(
    "help-coll-sm", "no-fallback",
    "coll/sm on {comm}: no other selected coll module provides the "
    "above-slot collectives, so payloads larger than slot_size use the "
    "built-in basic algorithms even if coll/basic was excluded.")
