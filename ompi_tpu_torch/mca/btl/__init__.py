"""btl — Byte Transfer Layer framework (``opal/mca/btl/``).

The lowest transport layer: active-message send and RDMA put/get
(``btl.h:878,949,987``), with eager/rendezvous/max-send size limits
(``btl.h:1162-1180``).  Components: ``self`` (in-process loopback, which in
the device world reaches every rank), ``sm`` (shared memory between the
processes of one node) and ``tcp`` (sockets, between nodes; ``--mca btl
tcp,self`` makes it carry every peer).
"""
