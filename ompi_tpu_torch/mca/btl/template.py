"""btl/template — the teaching skeleton for new transports.

The port's copy of the JAX package's btl/template, itself a re-design
of Open MPI's ``opal/mca/btl/template/`` (1,320 lines of commented
stubs): a minimal but RUNNABLE btl showing exactly what a
transport must provide — reachability, eager/max limits, ordered frag
delivery, progress-driven receive — so a new DCN transport (RDMA verbs,
gRPC, cloud object relay …) starts from a working example instead of
btl/tcp's full machinery.

Disabled by default (priority -1, like the reference's template which is
never selected); ``--mca btl_template_enable 1`` turns it into a working
intra-process loopback so framework-level tests can exercise bml/pml
against a third transport.
"""
from __future__ import annotations

from ompi_tpu_torch.base.containers import Fifo
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.btl.base import Btl, Endpoint, Frag


class TemplateBtl(Btl):
    # 1. identity + selection: bml orders by latency/bandwidth; negative
    #    priority keeps the template out of real jobs
    name = "template"
    priority = -1
    latency = 1000
    bandwidth = 1

    # 2. protocol limits: pml picks eager vs rendezvous from these
    eager_limit = 4 * 1024
    rndv_eager_limit = 4 * 1024
    max_send_size = 16 * 1024

    def __init__(self) -> None:
        super().__init__()
        self._rte = None
        self._inbox: Fifo = Fifo()

    def register_vars(self, fw) -> None:
        self._enable = self.register_var(
            "enable", vtype=VarType.BOOL, default=False,
            help="Enable the template btl (loopback; testing only)")

    # 3. lifecycle: open() gates availability, setup() binds the RTE,
    #    close() releases resources
    def open(self) -> bool:
        return bool(self._enable.value)

    def setup(self, rte) -> bool:
        self._rte = rte
        return True

    def close(self) -> None:
        self._inbox = Fifo()

    # 4. wiring: which peers can this transport reach?  (A real transport
    #    checks the peer's modexed address; loopback reaches only self-
    #    rank messages the pml would otherwise give btl/self.)
    def reachable(self, world_rank: int, rte):
        if world_rank != rte.my_world_rank:
            return None
        return Endpoint(self, world_rank)

    # 5. send path: enqueue bytes toward the peer.  A real transport
    #    writes a NIC ring / socket here; ordering per (src, dst) is the
    #    btl contract (pml's seq matching relies on it).
    def send(self, ep: Endpoint, frag: Frag) -> None:
        self._inbox.push(frag)

    # 6. progress: drain receives and hand frags to the pml callback.
    #    Called from the global progress engine; must never block.
    def progress(self) -> int:
        made = 0
        while True:
            frag = self._inbox.pop()
            if frag is None:
                break
            self._recv_cb(frag)
            made += 1
        return made


COMPONENT = TemplateBtl()
