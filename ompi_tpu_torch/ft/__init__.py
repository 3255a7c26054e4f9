"""ULFM fault tolerance (``ompi/communicator/ft/`` and
``ompi/mpiext/ftmpi/``): failure state, heartbeat detector, propagation,
revoke, shrink and agreement, and seeded fault injection (``chaos.py``).
Copy of ``ompi_tpu/ft/``."""
