"""ProcRte — the multi-process RTE (one MPI rank per OS process).

Copy of ``ompi_tpu/rte/proc.py``: the classic Open MPI process model.
``tpurun`` launches N processes, each connecting back to the coordination
service for identity, modex and fences (the ``PMIx_Init`` path of
``ompi_rte.c:528-568``).  The rank's device is the card unless the caller
names another (``device="cpu"``); with no card and no explicit device,
construction raises, as the device world's does.  Tensors a rank hands to
point-to-point or to a host collective are staged through
``torch_acc.to_host``.  Node identity for the hierarchy (coll/han): the
``node`` modex key, from ``OTPU_NODE_ID`` (``tpurun --fake-nodes``) or
else the hostname, read back through the cached ``node_of``;
``split_type("shared")``'s colour is a crc32 of it (``locality_color``,
stable across processes, unlike ``hash()``).  Each rank also publishes the
``device`` modex key, its device's name (``cuda:0``, ``cpu``), which the
reference has no counterpart of, and the ``boot`` key, a token that names
this boot of the process (``boot``): a key a peer reads after the init
fence (coll/sm's segment) is qualified by it, so after a re-init in one job
no peer reads the previous boot's value.  The reference has neither.

dpm's job identity (``proc.py:44-101``): a spawned job has its own
COMM_WORLD of GLOBAL ranks the coordination service allocated
(``OTPU_JOB``, ``OTPU_JOB_RANKS``), its parent's ranks and bridge CID
(``OTPU_PARENT_RANKS``, ``OTPU_PARENT_CID``), announces itself with the
``__spawn_join__:<job>`` key as soon as its coordination connection is up,
and scopes its fence ids by job with explicit membership; the primary job
is job "0" with ranks 0..nprocs-1.  ``chaos.install(rank=...)`` arms
fault injection before the first coordination RPC (``proc.py:39-43``), so
a chaos spec covers the wire-up fences too; it is a no-op with
``otpu_chaos_spec`` empty.

The multi-process device world (``proc.py:22-33``): when the instance
boots ``torch.distributed`` over the job's processes (``tpurun
--device-world``), it sets ``device_world_booted``, the process group
(``process_group``), and the global and local virtual-rank lists: the job
of P processes with K virtual ranks each spans ``global_ranks`` = 0..P·K-1,
of which this process holds the contiguous block ``local_ranks``.
``device_world_process(world_rank)`` is a world rank's index in the
process group (its job-local position, the ``rank`` it booted with).  Not
copied: the ``hostname`` key.
"""
from __future__ import annotations

import itertools
import os
import socket
from typing import Any, Optional

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.rte.base import Rte
from ompi_tpu_torch.rte.coord import CoordClient

#: this process's boots: with the pid, a token no earlier boot had
_boots = itertools.count(1)


class ProcRte(Rte):
    is_device_world = False

    #: the multi-process device world (set by the instance when it boots
    #: torch.distributed): the process group every member of the job
    #: joined, and the global and this process's virtual ranks
    device_world_booted = False
    process_group = None
    global_ranks = None
    local_ranks = None

    def device_world_process(self, world_rank: int) -> int:
        """The process-group rank of a world rank: its job-local
        position, the ``rank`` passed to ``init_process_group``."""
        return self.job_ranks.index(int(world_rank))

    def __init__(self, device=None) -> None:
        self.device = cudaenv.resolve_device(device)
        self.my_world_rank = int(os.environ["OTPU_RANK"])
        self.world_size = int(os.environ["OTPU_NPROCS"])
        # arm deterministic fault injection BEFORE the first coord RPC: a
        # chaos spec must cover the wire-up fences too (no-op when
        # otpu_chaos_spec is empty)
        from ompi_tpu_torch.ft import chaos

        chaos.install(rank=self.my_world_rank)
        # dpm job identity: a spawned job's COMM_WORLD is built from the
        # GLOBAL ranks the coordination service allocated
        self.job = os.environ.get("OTPU_JOB", "0")
        jr = os.environ.get("OTPU_JOB_RANKS", "")
        self.job_ranks = ([int(x) for x in jr.split(",")] if jr
                          else list(range(self.world_size)))
        pr = os.environ.get("OTPU_PARENT_RANKS", "")
        self.parent_ranks = [int(x) for x in pr.split(",")] if pr else None
        self.parent_cid = int(os.environ.get("OTPU_PARENT_CID", "-1"))
        self.client = CoordClient()
        # node identity for the hierarchy (coll/han): hostname by default,
        # OTPU_NODE_ID when the launcher partitions ranks into fake nodes
        # (tpurun --fake-nodes)
        self._node = os.environ.get("OTPU_NODE_ID", socket.gethostname())
        self.modex_put("node", self._node)
        # the device this rank's world binds to, readable by any peer (a
        # fleet checks that an autoscaled worker came up on the card)
        self.modex_put("device", str(self.device))
        # published before the init fence, so every peer past that fence
        # reads this boot's token (never a re-init's predecessor's)
        self.boot = f"{os.getpid()}b{next(_boots)}"
        self.modex_put("boot", self.boot)
        if self.job != "0":
            # dpm join handshake: a spawned rank announces that it reached
            # the runtime as soon as its coordination connection is up, so
            # the parent's spawn tells "children booting" from "a child died
            # during join" (ERR_SPAWN)
            self.modex_put(f"__spawn_join__:{self.job}", 1)
        self._node_cache: dict = {}
        self._fence_counter = 0

    def device_of(self, world_rank: int):
        return self.device if world_rank == self.my_world_rank else None

    def modex_put(self, key: str, value: Any) -> None:
        self.client.put(self.my_world_rank, key, value)

    def modex_get(self, rank: int, key: str, wait: bool = True) -> Any:
        return self.client.get(rank, key, wait=wait)

    def fence(self) -> None:
        self._fence_counter += 1
        # job-scoped fence ids with explicit membership: a spawned job's
        # fences never collide with the primary job's
        self.client.fence(f"{self.job}:f{self._fence_counter}",
                          rank=self.my_world_rank, expect=self.job_ranks)

    def fence_final(self, timeout: Optional[float] = None) -> None:
        """Pre-teardown synchronisation (ompi_mpi_finalize's barrier).

        One-shot semantics on a DEDICATED short-timeout connection: a peer
        that exited without fencing costs at most
        ``otpu_coord_final_timeout`` seconds and must not desynchronise
        the shared client's request/reply stream."""
        from ompi_tpu_torch.rte.coord import _final_timeout_var

        if timeout is None:
            timeout = float(_final_timeout_var.value)
        c = CoordClient(timeout=timeout, retries=0)
        try:
            c.fence_oneshot(f"{self.job}:final", rank=self.my_world_rank,
                            expect=self.job_ranks)
        finally:
            try:
                c.close()
            except Exception:
                pass

    def node_of(self, world_rank: int):
        """Cached node identity of a peer (published at its init, before
        the init fence); None while a peer's key is not readable."""
        if world_rank == self.my_world_rank:
            return self._node
        if world_rank not in self._node_cache:
            try:
                val = self.modex_get(world_rank, "node", wait=False)
            except Exception:
                return None
            if val is None:
                return None     # not cached: may appear later
            self._node_cache[world_rank] = val
        return self._node_cache[world_rank]

    def locality_color(self, split_type: str) -> int:
        """'shared' means the same node.  A crc32 of the node identity:
        builtin ``hash()`` is salted per process, which would give the
        ranks of one node different colours."""
        import zlib

        return zlib.crc32(self._node.encode()) % (1 << 30)

    def event_notify(self, event: str, payload: Any) -> None:
        self.client.event_publish(event, payload)

    def event_poll(self):
        return self.client.event_poll()

    def finalize(self) -> None:
        self.client.close()
