"""MPI_Info equivalent (``ompi/info/info.c`` — ordered key/value hints with
dup and subscriber semantics collapsed to plain get/set).

Copy of ``ompi_tpu/api/info.py``: a communicator's hints, among them the
accuracy budget that arms coll/quant (``otpu_quant_budget``)."""
from __future__ import annotations

from typing import Optional


class Info:
    MAX_KEY = 255
    MAX_VAL = 1024

    def __init__(self, items: Optional[dict] = None):
        self._d: dict[str, str] = dict(items or {})

    def set(self, key: str, value: str) -> None:
        if not 0 < len(key) <= self.MAX_KEY:
            raise ValueError("invalid info key")
        if len(str(value)) > self.MAX_VAL:
            raise ValueError("info value too long")
        self._d[key] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._d.get(key, default)

    def delete(self, key: str) -> None:
        if key not in self._d:
            raise KeyError(key)
        del self._d[key]

    def get_nkeys(self) -> int:
        return len(self._d)

    def get_nthkey(self, n: int) -> str:
        return list(self._d)[n]

    def dup(self) -> "Info":
        return Info(self._d)

    def items(self):
        return self._d.items()

    def __contains__(self, key: str) -> bool:
        return key in self._d


INFO_NULL = Info()
