"""bml — BTL multiplexer (``ompi/mca/bml/`` r2): builds per-peer endpoint
lists of usable BTLs ordered by latency/bandwidth.  Copy of
``ompi_tpu/mca/bml/__init__.py`` without ``resolve_bml``, which walks the
monitoring and vprotocol pml wrappers the port does not have."""
from ompi_tpu_torch.mca.bml.r2 import Bml  # noqa: F401
