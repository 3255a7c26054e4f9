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
else the hostname, read back through the cached ``node_of``.  Not copied:
dpm's job identity (spawned jobs, parent ranks), ``event_poll``, the
``hostname`` key and
``split_type``'s colors (the instance layer), the chaos hook and the
multi-process device world.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Optional

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.rte.base import Rte
from ompi_tpu_torch.rte.coord import CoordClient


class ProcRte(Rte):
    is_device_world = False

    def __init__(self, device=None) -> None:
        self.device = cudaenv.resolve_device(device)
        self.my_world_rank = int(os.environ["OTPU_RANK"])
        self.world_size = int(os.environ["OTPU_NPROCS"])
        self.job_ranks = list(range(self.world_size))
        self.client = CoordClient()
        # node identity for the hierarchy (coll/han): hostname by default,
        # OTPU_NODE_ID when the launcher partitions ranks into fake nodes
        # (tpurun --fake-nodes)
        self._node = os.environ.get("OTPU_NODE_ID", socket.gethostname())
        self.modex_put("node", self._node)
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
        self.client.fence(f"0:f{self._fence_counter}",
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
            c.fence_oneshot("0:final", rank=self.my_world_rank,
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

    def event_notify(self, event: str, payload: Any) -> None:
        self.client.event_publish(event, payload)

    def finalize(self) -> None:
        self.client.close()
