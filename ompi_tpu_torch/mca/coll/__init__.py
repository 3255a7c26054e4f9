"""coll — collectives framework (``ompi/mca/coll/``).

Components compete per communicator by priority; each fills the slots of
the per-comm vtable it implements.  Components: ``builtin`` (torch
reductions over the rank axis), ``ring`` (hand-written ring kernels),
``conductor`` (host-buffer collectives of the device world), ``basic``
(host collectives of the multi-process world over point-to-point),
``self_coll`` (size-1 comms), and the config homes ``quant`` and
``tuned``.
"""
