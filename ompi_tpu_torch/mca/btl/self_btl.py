"""btl/self — in-process loopback transport.

Copy of ``ompi_tpu/mca/btl/self_btl.py`` (after the reference's
``opal/mca/btl/self/``), widened for the device world: every rank living in
this process (all of them in the device world; just my own rank in the
multi-process world) is self-reachable, so a one-process N-rank world runs
the whole pml matching path, as ``mpirun -n N --oversubscribe`` exercises
btl/self and sm on one node.
"""
from __future__ import annotations

from typing import Optional

from ompi_tpu_torch.base.containers import Fifo
from ompi_tpu_torch.mca.btl.base import Btl, Endpoint, Frag


class SelfBtl(Btl):
    name = "self"
    priority = 80
    eager_limit = 1 << 62      # in-process: everything is eager
    rndv_eager_limit = 1 << 62
    max_send_size = 1 << 62
    latency = 0                # best possible — bml orders by latency
    bandwidth = 1 << 30

    def __init__(self) -> None:
        super().__init__()
        self._pending = Fifo()

    def register_vars(self, fw) -> None:
        from ompi_tpu_torch.base.var import VarType

        self._eager_var = self.register_var(
            "eager_limit", vtype=VarType.SIZE, default=self.eager_limit,
            help="Maximum eager message size for btl/self")

    def reachable(self, world_rank: int, rte) -> Optional[Endpoint]:
        if rte.is_device_world or world_rank == rte.my_world_rank:
            return Endpoint(self, world_rank)
        return None

    def send(self, ep: Endpoint, frag: Frag) -> None:
        # queue + drain from progress: preserves the asynchronous contract
        # (a blocking recv posted later must still match), while keeping
        # same-call-stack latency low via immediate drain when possible
        self._pending.push(frag)
        self.progress()

    def progress(self) -> int:
        n = 0
        while True:
            frag = self._pending.pop()
            if frag is None:
                break
            if self._recv_cb is not None:
                self._recv_cb(frag)
                n += 1
        return n


COMPONENT = SelfBtl()
