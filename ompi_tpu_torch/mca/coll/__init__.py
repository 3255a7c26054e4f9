"""coll — collectives framework (``ompi/mca/coll/``).

Components compete per communicator by priority; each fills the slots of
the per-comm vtable it implements.  Components: ``builtin`` (torch
reductions over the rank axis) and ``ring`` (hand-written ring kernels).
"""
