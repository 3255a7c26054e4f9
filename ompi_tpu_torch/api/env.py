"""Environment inquiry functions (``ompi/mpi/c/wtime.c``, ``get_version.c``,
``get_processor_name.c``, ``alloc_mem.c`` family).

Copy of ``ompi_tpu/api/env.py``.  ``alloc_mem`` returns host memory (a
numpy byte buffer), as the reference's does: the card's memory is torch's
to allocate.  Not copied yet: ``pcontrol``, ``get_affinity`` and
``query_accelerator_support``, which no ported module reads.
"""
from __future__ import annotations

import socket
import time

import numpy as np

VERSION = (4, 0)              # MPI standard level the API tracks


def wtime() -> float:
    """``MPI_Wtime``: monotonic wall clock in seconds."""
    return time.perf_counter()


def wtick() -> float:
    """``MPI_Wtick``: the clock's resolution."""
    return time.get_clock_info("perf_counter").resolution


def get_processor_name() -> str:
    """``MPI_Get_processor_name``."""
    return socket.gethostname()


def get_version() -> tuple:
    """``MPI_Get_version``: (version, subversion) of the MPI level."""
    return VERSION


def get_library_version() -> str:
    """``MPI_Get_library_version``."""
    import ompi_tpu_torch

    return f"ompi_tpu_torch {ompi_tpu_torch.__version__} (PyTorch/CUDA, " \
           f"MPI-{VERSION[0]}.{VERSION[1]} API surface)"


def alloc_mem(nbytes: int, info=None) -> np.ndarray:
    """``MPI_Alloc_mem``: a host byte buffer suitable for RMA and sends."""
    return np.zeros(int(nbytes), np.uint8)


def free_mem(buf) -> None:
    """``MPI_Free_mem`` (the GC owns it; exists for API parity)."""
