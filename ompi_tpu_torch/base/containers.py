"""Container classes used across the framework.

Copy of ``ompi_tpu/base/containers.py`` (the reference's ``opal/class/``
containers): ``Fifo`` (btl queues), ``Lifo``, ``PointerArray`` (attribute
keyvals), ``Bitmap`` (the CID space), ``RingBuffer``, ``Hotel`` (a timeout
pool swept from the progress loop), ``IntervalTree`` (the accelerator's
registration cache) and ``Graph`` (a small weighted digraph).  Python's
object model replaces ``opal_object_t``'s refcounting; the hot
cross-process paths have native C++ twins in ``ompi_tpu_torch.native``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional


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


class Lifo:
    """Thread-safe LIFO (``opal/class/opal_lifo.h`` analog)."""

    def __init__(self) -> None:
        self._q: list = []
        self._lock = threading.Lock()

    def push(self, item: Any) -> None:
        with self._lock:
            self._q.append(item)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._q.pop() if self._q else None

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


class RingBuffer:
    """Fixed-capacity overwriting ring (``opal/class/opal_ring_buffer.h``)."""

    def __init__(self, capacity: int) -> None:
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def push(self, item: Any) -> None:
        with self._lock:
            self._buf.append(item)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._buf.popleft() if self._buf else None

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)


class Hotel:
    """Timeout pool: check in an occupant, get a room; eviction on timeout.

    Reference ``opal/class/opal_hotel.h`` — used for operations that need a
    bounded wait with a callback on expiry (e.g. rendezvous timeouts).
    Eviction is polled via :meth:`sweep` from the progress loop rather than a
    libevent timer.
    """

    def __init__(self, num_rooms: int, eviction_s: float,
                 on_evict: Callable[[int, Any], None]) -> None:
        self._rooms: dict[int, tuple[Any, float]] = {}
        self._free = list(range(num_rooms - 1, -1, -1))
        self._eviction_s = eviction_s
        self._on_evict = on_evict
        self._lock = threading.Lock()

    def checkin(self, occupant: Any) -> int:
        with self._lock:
            if not self._free:
                return -1
            room = self._free.pop()
            self._rooms[room] = (occupant, time.monotonic() + self._eviction_s)
            return room

    def checkout(self, room: int) -> Optional[Any]:
        with self._lock:
            entry = self._rooms.pop(room, None)
            if entry is None:
                return None
            self._free.append(room)
            return entry[0]

    def sweep(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        evicted = []
        with self._lock:
            for room, (occ, deadline) in list(self._rooms.items()):
                if now >= deadline:
                    del self._rooms[room]
                    self._free.append(room)
                    evicted.append((room, occ))
        for room, occ in evicted:
            self._on_evict(room, occ)
        return len(evicted)

    def __len__(self) -> int:
        return len(self._rooms)


class IntervalTree:
    """Interval -> value map with stabbing and overlap queries.

    Reference ``opal/class/opal_interval_tree.h`` (an augmented RB tree used
    by the registration cache).  This implementation keeps a sorted list of
    ``(low, high, value)`` — adequate for registration-cache sizes and kept
    simple deliberately; the native core provides the scaled variant.
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


class Graph:
    """Small weighted digraph (``opal/class/opal_graph.h`` analog).

    Used by topology reordering (treematch equivalent) and the reachability
    framework's bipartite matching.
    """

    def __init__(self) -> None:
        self.adj: dict[Any, dict[Any, float]] = {}

    def add_vertex(self, v: Any) -> None:
        self.adj.setdefault(v, {})

    def add_edge(self, u: Any, v: Any, weight: float = 1.0) -> None:
        self.add_vertex(u)
        self.add_vertex(v)
        self.adj[u][v] = weight

    def neighbors(self, v: Any) -> dict[Any, float]:
        return self.adj.get(v, {})

    def vertices(self) -> Iterable[Any]:
        return self.adj.keys()

    def shortest_path(self, src: Any, dst: Any) -> Optional[list]:
        """Dijkstra (reference uses it for reachability scoring)."""
        import heapq
        dist = {src: 0.0}
        prev: dict[Any, Any] = {}
        heap = [(0.0, 0, src)]
        tie = 0
        while heap:
            d, _, u = heapq.heappop(heap)
            if u == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            if d > dist.get(u, float("inf")):
                continue
            for v, w in self.adj.get(u, {}).items():
                nd = d + w
                if nd < dist.get(v, float("inf")):
                    dist[v] = nd
                    prev[v] = u
                    tie += 1
                    heapq.heappush(heap, (nd, tie, v))
        return None
