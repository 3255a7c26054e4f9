"""Container classes used across the host tier.

Copy of the part of ``ompi_tpu/base/containers.py`` that the port's host
tier uses (the reference's ``opal/class/`` containers): ``Fifo`` (btl
queues), ``PointerArray`` (attribute keyvals) and ``Bitmap`` (the CID
space) and ``IntervalTree`` (the accelerator's registration cache).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Iterator, Optional


class Fifo:
    """Thread-safe FIFO (``opal/class/opal_fifo.h`` analog)."""

    def __init__(self) -> None:
        self._q: deque = deque()
        self._lock = threading.Lock()

    def push(self, item: Any) -> None:
        with self._lock:
            self._q.append(item)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class PointerArray:
    """Growable id -> object table with index reuse.

    Reference ``opal/class/opal_pointer_array.h``; used for request ids,
    attribute keyvals, CID allocation and the like.
    """

    def __init__(self, lowest_free: int = 0) -> None:
        self._items: list = []
        self._free: list[int] = []
        self._lowest = lowest_free
        self._lock = threading.Lock()
        for _ in range(lowest_free):
            self._items.append(None)

    def add(self, item: Any) -> int:
        with self._lock:
            if self._free:
                idx = self._free.pop()
                self._items[idx] = item
            else:
                idx = len(self._items)
                self._items.append(item)
            return idx

    def set(self, idx: int, item: Any) -> None:
        with self._lock:
            while len(self._items) <= idx:
                self._items.append(None)
            self._items[idx] = item
            if idx in self._free:
                self._free.remove(idx)

    def get(self, idx: int) -> Any:
        with self._lock:
            return self._items[idx] if 0 <= idx < len(self._items) else None

    def remove(self, idx: int) -> Any:
        with self._lock:
            if not (0 <= idx < len(self._items)) or self._items[idx] is None:
                return None
            item, self._items[idx] = self._items[idx], None
            if idx >= self._lowest:
                self._free.append(idx)
            return item

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        with self._lock:
            snap = list(enumerate(self._items))
        return ((i, x) for i, x in snap if x is not None)

    def __len__(self) -> int:
        return sum(1 for x in self._items if x is not None)


class Bitmap:
    """Dynamic bitmap (``opal/class/opal_bitmap.h`` analog)."""

    def __init__(self, size: int = 0) -> None:
        self._bits = 0
        self._size = size

    def set(self, bit: int) -> None:
        self._bits |= 1 << bit
        self._size = max(self._size, bit + 1)

    def clear(self, bit: int) -> None:
        self._bits &= ~(1 << bit)

    def is_set(self, bit: int) -> bool:
        return bool(self._bits >> bit & 1)

    def set_all(self) -> None:
        self._bits = (1 << self._size) - 1

    def clear_all(self) -> None:
        self._bits = 0

    def find_and_set_first_unset(self) -> int:
        i = 0
        while self.is_set(i):
            i += 1
        self.set(i)
        return i

    @property
    def size(self) -> int:
        return self._size

    def popcount(self) -> int:
        return bin(self._bits).count("1")

    def __iter__(self) -> Iterator[int]:
        b, i = self._bits, 0
        while b:
            if b & 1:
                yield i
            b >>= 1
            i += 1


class IntervalTree:
    """Interval -> value map with stabbing and overlap queries.

    Reference ``opal/class/opal_interval_tree.h`` (an augmented RB tree used
    by the registration cache).  A sorted list of ``(low, high, value)``, as
    in ``ompi_tpu/base/containers.py:234``: adequate for registration-cache
    sizes.
    """

    def __init__(self) -> None:
        self._iv: list[tuple[int, int, Any]] = []
        self._lock = threading.RLock()

    def insert(self, low: int, high: int, value: Any) -> None:
        import bisect

        with self._lock:
            bisect.insort(self._iv, (low, high, value),
                          key=lambda t: (t[0], t[1]))

    def delete(self, low: int, high: int, value: Any = None) -> bool:
        with self._lock:
            for i, (lo, hi, v) in enumerate(self._iv):
                if lo == low and hi == high and (value is None or v is value):
                    del self._iv[i]
                    return True
        return False

    def find_overlapping(self, low: int, high: int) -> list[tuple[int, int, Any]]:
        with self._lock:
            return [(lo, hi, v) for lo, hi, v in self._iv
                    if lo < high and low < hi]

    def find_containing(self, low: int, high: int) -> Optional[tuple[int, int, Any]]:
        """Smallest interval fully containing [low, high)."""
        best = None
        with self._lock:
            for lo, hi, v in self._iv:
                if lo <= low and high <= hi:
                    if best is None or (hi - lo) < (best[1] - best[0]):
                        best = (lo, hi, v)
        return best

    def __len__(self) -> int:
        return len(self._iv)

    def __iter__(self):
        with self._lock:
            return iter(list(self._iv))
