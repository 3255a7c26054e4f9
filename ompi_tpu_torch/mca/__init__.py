"""MCA component frameworks (plugin points).

Each subpackage is one framework (``coll``, ``op``, ``pml``, ``btl``,
``threads``); each module inside exports a ``COMPONENT`` object discovered
by ``ompi_tpu_torch.base.mca.Framework.discover``.  ``bml`` is the btl
multiplexer pml/ob1 builds its endpoints with; ``accelerator`` holds the
device-residency and staging helpers and no component yet; ``topo`` holds
the topology objects ``Comm``'s constructors attach (no component).
"""
