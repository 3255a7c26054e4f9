"""coll — collectives framework (``ompi/mca/coll/``).

Components compete per communicator by priority; each fills the slots of
the per-comm vtable it implements, the highest priority winning per slot.
Components: ``builtin`` (torch reductions over the rank axis), ``ring``
(hand-written ring kernels), ``conductor`` (host-buffer collectives of the
device world) and ``self_coll`` (size-1 comms) serve the device world; a
multi-process communicator (``tpurun``) takes the reference's vote: ``sync``
50 (off unless its barrier count is set), ``han`` 40 (hierarchical, across
nodes), ``sm_coll`` 35 (a mapped segment on single-node comms, with the
native core), ``tuned`` 30 (the decision ladder over ``algorithms``' menus),
``ftagree`` 30 (the fault-tolerant ``agree``),
``adapt`` 28 (off by default), ``libnbc`` 25 (the ``i*`` schedules) and
``basic`` 10 (linear, over point-to-point); an intercommunicator takes
``inter`` 45 (the two-group protocol over its local comm) in place of the
intracomm modules; ``demo`` interposes when its priority is raised.  ``quant`` is a config home (the codec and its ladder),
as ``tuned`` is for the device cells.
"""
