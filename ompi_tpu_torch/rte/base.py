"""RTE adapters: the process-model abstraction under the runtime.

Port of ``ompi_tpu/rte/base.py`` (the PMIx client surface of the
reference, ``ompi/runtime/ompi_rte.c``): an Rte provides identity
(rank/size), the wire-up KV space, barriers outside MPI and the device that
the device-collective components compute on.  The multi-process model is
``rte/proc.py``'s ``ProcRte``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Optional

from ompi_tpu_torch.base import cudaenv


class Rte:
    """Interface. ``my_world_rank``/``world_size`` are process identity."""

    my_world_rank: int = 0
    world_size: int = 1
    is_device_world: bool = False

    def modex_put(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def modex_get(self, rank: int, key: str, wait: bool = True) -> Any:
        """Fetch a peer's modexed value; ``wait=False`` returns None
        instead of blocking when the key hasn't been published yet."""
        raise NotImplementedError

    def fence(self) -> None:
        """Out-of-band barrier + modex publication (``PMIx_Fence``)."""
        raise NotImplementedError

    def locality_color(self, split_type: str) -> int:
        """``split_type``'s colour of this process: one host (the device
        world's one card) gives every rank the same."""
        return 0

    def node_of(self, world_rank: int) -> Optional[Any]:
        """Node identity of a peer (None if unknown) — the locality lookup
        coll/han and ``cart_create(reorder=True)`` read."""
        return None

    def event_notify(self, event: str, payload: Any) -> None:
        pass

    def finalize(self) -> None:
        pass

    def device_of(self, world_rank: int):
        return None


class DeviceWorldRte(Rte):
    """SPMD world in one process: N virtual ranks on one device.

    The JAX package's device world is a 1-D mesh whose ranks are devices;
    on one real chip that is a world of one rank.  Here the world holds N
    virtual ranks as the rows of one tensor on one device: ``x[i]`` is rank
    i's buffer.  N is ``otpu_rte_virtual_ranks`` (default 8, the size of the
    JAX package's 8-device CPU test mesh).  The device is the card unless
    the caller names another (``device="cpu"`` runs the plain versions of
    the kernels); with no card and no explicit device, construction raises.
    """

    is_device_world = True

    def __init__(self, device=None, world_size: Optional[int] = None) -> None:
        self.device = cudaenv.resolve_device(device)
        self.world_size = cudaenv.virtual_ranks() if world_size is None \
            else int(world_size)
        self.my_world_rank = 0  # the conductor acts for every rank
        self._kv: dict[tuple[int, str], Any] = {}
        self._lock = threading.Lock()

    def device_of(self, world_rank: int):
        return self.device

    def modex_put(self, key: str, value: Any, rank: Optional[int] = None) -> None:
        with self._lock:
            self._kv[(self.my_world_rank if rank is None else rank, key)] = value

    def modex_get(self, rank: int, key: str, wait: bool = True) -> Any:
        with self._lock:
            return self._kv.get((rank, key))

    def fence(self) -> None:
        pass  # single process: nothing to synchronize out-of-band


class SingletonRte(Rte):
    """Size-1 world with no devices (pure host usage); no device collective
    component serves it."""

    def __init__(self) -> None:
        self._kv: dict[tuple[int, str], Any] = {}

    def modex_put(self, key: str, value: Any) -> None:
        self._kv[(0, key)] = value

    def modex_get(self, rank: int, key: str, wait: bool = True) -> Any:
        return self._kv.get((rank, key))

    def fence(self) -> None:
        pass


def detect(device=None) -> Rte:
    """Pick the RTE for this process (``ompi_rte_init`` equivalent).

    Launched under ``tpurun`` (``OTPU_RANK``/``OTPU_NPROCS`` in the
    environment): the multi-process ``ProcRte``.  Otherwise the device
    world.  Either binds to ``device`` (default: the card).  Unlike the JAX
    package it does not fall back to a singleton when the device is
    missing: it raises."""
    if "OTPU_RANK" in os.environ and "OTPU_NPROCS" in os.environ:
        from ompi_tpu_torch.rte.proc import ProcRte

        return ProcRte(device)
    return DeviceWorldRte(device)
