"""bml — BTL multiplexer (``ompi/mca/bml/`` r2): builds per-peer endpoint
lists of usable BTLs ordered by latency/bandwidth.  Copy of
``ompi_tpu/mca/bml/__init__.py``: ``resolve_bml`` walks the pml wrappers
(pml/monitoring's) to the bml the FT carriers send their CTL frames over."""
from ompi_tpu_torch.mca.bml.r2 import Bml  # noqa: F401


def resolve_bml(pml):
    """The bml behind a (possibly wrapped) pml module, or None.

    Interposition wrappers chain via ``_inner``; this is the one place that
    knows how to walk them."""
    inner = pml
    while inner is not None and not hasattr(inner, "bml"):
        inner = getattr(inner, "_inner", None)
    return getattr(inner, "bml", None) if inner is not None else None
