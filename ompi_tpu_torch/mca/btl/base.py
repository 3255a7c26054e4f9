"""BTL interface: fragments, endpoints, module contract.

Copy of ``ompi_tpu/mca/btl/base.py`` (after the module struct of the
reference's ``opal/mca/btl/btl.h:1158``: ``btl_send`` active messages)
with the descriptor machinery collapsed to a :class:`Frag` dataclass, which
carries coll/quant's wire codec stamp (``qcodec``), and the ``rdma`` flag
of the one-sided RMA triple (``prepare_src``/``get``/``put``), which
btl/sm offers and pml/ob1's RGET rung reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ompi_tpu_torch.base.mca import Component


def owned_bytes(payload) -> bytes:
    """Owned bytes of any bytes-like payload (ndarray views included) —
    the buffered-descriptor side of the send-in-place vs copy split."""
    import numpy as np

    return payload.tobytes() if isinstance(payload, np.ndarray) \
        else bytes(payload)

# fragment kinds (pml protocol headers ride in ``kind`` + ``meta``)
MATCH = "match"          # eager: full payload, match on arrival
RNDV = "rndv"            # rendezvous first fragment: header + head of data
ACK = "ack"              # receiver matched an rndv: pull the rest
FRAG = "frag"            # rndv continuation fragment
RGET = "rget"            # RDMA-get protocol: sender exposes, receiver pulls
CTL = "ctl"              # control (FT heartbeats, monitoring, osc)


@dataclass
class Frag:
    """One wire fragment. ``data`` is bytes-like; ``meta`` is a small dict
    that must stay picklable (it crosses process boundaries on tcp/sm).

    ``borrowed`` marks ``data`` as a zero-copy view of the SENDER's user
    buffer: valid only within the btl.send call (the wire/ring write is
    the copy).  Anything that outlives the call — queueing, in-process
    loopback delivery — must take ownership first (``own_data``)."""

    cid: int
    src: int              # world rank of sender
    dst: int              # world rank of receiver
    tag: int
    seq: int
    kind: str = MATCH
    data: bytes = b""
    total_len: int = 0    # full message length (rndv)
    offset: int = 0       # stream offset of this fragment (FRAG)
    meta: dict = field(default_factory=dict)
    borrowed: bool = False
    #: coll/quant wire codec this payload may travel under (stamped by the
    #: pml, which still knows the dtype; btl/tcp's codec stage encodes
    #: eligible frames and its receive parse decodes them back to the
    #: ORIGINAL bytes, so total_len/offset stay in raw-stream units).
    #: None = raw bytes; transports without a codec stage ignore it.
    qcodec: "Optional[str]" = None

    def own_data(self) -> None:
        """Replace a borrowed view with an owned copy (idempotent)."""
        if self.borrowed:
            import numpy as np

            self.data = np.array(self.data, copy=True)
            self.borrowed = False


@dataclass
class Endpoint:
    """Per-peer connection state for one BTL."""

    btl: "Btl"
    world_rank: int
    addr: Any = None


class Btl(Component):
    """Base BTL module/component (collapsed, like coll components)."""

    # perf limits (btl.h:1162-1180); subclasses override
    eager_limit: int = 64 * 1024
    rndv_eager_limit: int = 64 * 1024
    max_send_size: int = 128 * 1024
    latency: int = 100        # ordering key for bml (btl.h btl_latency)
    bandwidth: int = 100

    def __init__(self) -> None:
        super().__init__()
        self._recv_cb: Optional[Callable[[Frag], None]] = None

    def set_recv_callback(self, cb: Callable[[Frag], None]) -> None:
        """The pml registers its frag-delivery callback here."""
        self._recv_cb = cb

    def reachable(self, world_rank: int, rte) -> Optional[Endpoint]:
        """Return an endpoint if this BTL can reach the peer, else None."""
        return None

    #: True when this BTL implements the one-sided prepare_src/get/put
    #: RMA triple (``btl.h:949`` btl_put / ``:987`` btl_get); pml/ob1's
    #: RGET protocol engages only on rdma-capable transports and falls
    #: back to pull-streaming emulation elsewhere
    rdma = False

    def send(self, ep: Endpoint, frag: Frag) -> None:
        raise NotImplementedError

    def progress(self) -> int:
        return 0
