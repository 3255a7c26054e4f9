"""MPI_Status equivalent.

Copy of ``ompi_tpu/api/status.py`` without ``get_count``/``get_elements``,
which need the datatype engine of the host tier (not ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass

from ompi_tpu_torch.api.errors import ErrorClass

UNDEFINED = -32766


@dataclass
class Status:
    source: int = UNDEFINED
    tag: int = UNDEFINED
    error: ErrorClass = ErrorClass.SUCCESS
    _nbytes: int = 0
    _cancelled: bool = False

    def is_cancelled(self) -> bool:
        return self._cancelled

    def set_cancelled(self, flag: bool) -> None:
        self._cancelled = flag
