"""Environment inquiry functions (``ompi/mpi/c/wtime.c``, ``get_version.c``,
``get_processor_name.c``, ``alloc_mem.c`` family).

Copy of ``ompi_tpu/api/env.py``.  ``alloc_mem`` returns host memory (a
numpy byte buffer), as the reference's does: the card's memory is torch's
to allocate.  ``query_accelerator_support`` is ``MPIX_Query_cuda_support``
itself here: the device world's device is a CUDA card or it is not.
"""
from __future__ import annotations

import os
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


_pcontrol_level = 1


def pcontrol(level: int = 1, *args) -> None:
    """``MPI_Pcontrol``: profiling-level hint.  The Python-layer tracers
    (monitoring components, PERUSE subscribers) are toggled by their own
    MCA vars; this records the application's requested level for them to
    consult (``ompi/mpi/c/pcontrol.c`` is likewise a no-op hook)."""
    global _pcontrol_level
    _pcontrol_level = int(level)


def pcontrol_level() -> int:
    return _pcontrol_level


def get_affinity() -> list:
    """``MPIX_Get_affinity`` (mpiext/affinity): the CPU set this process
    is bound to (empty when unbound / unsupported)."""
    try:
        return sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return []


def query_accelerator_support() -> bool:
    """``MPIX_Query_cuda_support``: True when this process's initialized
    device world is bound to a CUDA device (device-buffer collectives
    select).  False before ``init``, in a world bound to ``device="cpu"``
    and in a world that is not a device world.  Like the reference macro, it reports what is configured and never
    initializes anything as a side effect of the query."""
    from ompi_tpu_torch.runtime import init as rt

    world = rt.get_world_if_initialized()
    if world is None or world.rte is None or not world.rte.is_device_world:
        return False
    device = getattr(world.rte, "device", None)
    return getattr(device, "type", None) == "cuda"
