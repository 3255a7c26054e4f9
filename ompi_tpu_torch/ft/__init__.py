"""ULFM fault tolerance (``ompi/communicator/ft/`` and
``ompi/mpiext/ftmpi/``): failure state, heartbeat detector, propagation,
revoke, shrink and agreement.  Copy of ``ompi_tpu/ft/`` less ``chaos.py``
(fault injection, with the flight recorder)."""
