"""MPI_Status equivalent (``ompi/include/mpi.h.in`` MPI_Status +
``ompi/mpi/c`` get_count/get_elements semantics).  Copy of
``ompi_tpu/api/status.py``."""
from __future__ import annotations

from dataclasses import dataclass

from ompi_tpu_torch.api.errors import ErrorClass

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2
ROOT = -4          # intercomm collective root sentinel (MPI_ROOT)
UNDEFINED = -32766


@dataclass
class Status:
    source: int = UNDEFINED
    tag: int = UNDEFINED
    error: ErrorClass = ErrorClass.SUCCESS
    _nbytes: int = 0
    _cancelled: bool = False

    def get_count(self, datatype) -> int:
        """Number of whole datatype elements received (UNDEFINED if partial)."""
        if datatype.size == 0:
            return 0 if self._nbytes == 0 else UNDEFINED
        n, rem = divmod(self._nbytes, datatype.size)
        return n if rem == 0 else UNDEFINED

    def get_elements(self, datatype) -> int:
        """Number of completed elementary items received."""
        return datatype.element_count(self._nbytes)

    def is_cancelled(self) -> bool:
        return self._cancelled

    def set_cancelled(self, flag: bool) -> None:
        self._cancelled = flag

    def set_elements(self, datatype, count: int) -> None:
        self._nbytes = count * datatype.size
