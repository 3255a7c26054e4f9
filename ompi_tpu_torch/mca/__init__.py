"""MCA component frameworks (plugin points).

Each subpackage is one framework (``coll``, ``op``); each module inside
exports a ``COMPONENT`` object discovered by
``ompi_tpu_torch.base.mca.Framework.discover``.  ``accelerator`` holds the
device-residency helpers and no component yet.
"""
