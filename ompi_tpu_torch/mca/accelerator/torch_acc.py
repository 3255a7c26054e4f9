"""accelerator/torch — device residency, staging, and the host staging pool.

Port of ``ompi_tpu/mca/accelerator/jax_acc.py``: ``is_device_array`` tells
the coll decision path (coll/conductor) whether a buffer is a device
buffer, which goes to the device collective slots (``*_array``), or a host
buffer, which the conductor folds with numpy; ``to_host``/``from_host``
stage across.  As in the reference, where any ``jax.Array`` counts,
CPU-backed ones included, any ``torch.Tensor`` counts, whatever its device:
the CPU lane takes the same route as the card.

The host tier meets a tensor at the entry of point-to-point (``as_buffer``)
and of every host collective module (coll/basic, coll/tuned, coll/libnbc,
coll/han, coll/adapt, coll/quant's blockq), each of which stages it once
through ``to_host`` (a D2H copy on the card into pageable host memory, the
copy ``Tensor.cpu()`` makes), as the reference's ``np.asarray`` stages a
``jax.Array``.

The **staging pool** is the ``rcache/grdma`` reuse analog
(``opal/mca/rcache/grdma/rcache_grdma.c``): repeated host-path collectives
reuse warmed host buffers instead of allocating fresh ones, whose pages a
first touch faults in on every call.  Its one caller is coll/algorithms'
ring allreduce (its receive scratch).  Buffers are host numpy, size-classed
raw ``uint8`` owners handed out as shaped views.  Vars:
``otpu_accelerator_torch_staging_pool`` and
``otpu_accelerator_torch_staging_pool_bytes`` (the reference's
``otpu_accelerator_jax_*``).

The pool's observability is the reference's (``jax_acc.py:35``,
``:184-232``, ``:281``, ``:326-328``): each checkout is a ``staging_hit``
or ``staging_miss`` span of category ``staging`` with its log2 histogram
and the ``send.staging`` stage, ``release`` fails loudly under
``OTPU_SANITIZE`` on a non-contiguous buffer or a double release, and
:meth:`_StagingPool.stats` is the ``staging`` telemetry source.  Not
ported yet: the framework's component (``JaxAcceleratorComponent``).

The **registration cache** (``register``/``deregister``/``lookup``,
``jax_acc.py:365-379``) keeps an interval tree of exposed host regions for
the RMA path (the rcache's bookkeeping).  A region is keyed by its numpy
address, as in the reference, which registers only host memory: a card
tensor gets no key.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.containers import IntervalTree
from ompi_tpu_torch.base.output import register_help, show_help
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime import profile, sanitizer, spc, trace
from ompi_tpu_torch.runtime.hotpath import hot_path

_rcache = IntervalTree()

# module-level vars: this framework's component is consumed by direct
# import, not framework selection
_pool_var = registry.register(
    "accelerator", "torch", "staging_pool", vtype=VarType.BOOL, default=True,
    help="Reuse host staging buffers across collective calls "
         "(rcache/grdma-style LRU); 0 allocates fresh per call")
_pool_bytes_var = registry.register(
    "accelerator", "torch", "staging_pool_bytes", vtype=VarType.SIZE,
    default="64m",
    help="Total bytes of idle staging buffers kept for reuse before "
         "LRU eviction")


#: smallest size class kept (below this an np.empty is cheaper than the
#: pool bookkeeping)
_MIN_CLASS = 256


class _StagingPool:
    """Size-class binned pool of reusable host staging buffers.

    Free memory is held as raw 1-D uint8 OWNER arrays binned by
    power-of-two size class; ``acquire`` pops the most-recently-released
    buffer of the class (warm pages first, O(1)) and returns it shaped as a
    (shape, dtype) view, ``release`` maps the view back to its raw class
    buffer in O(1) through the checkout table.  Contents are undefined,
    like ``np.empty``, and nothing touches the buffer on acquire: warmth is
    the whole point.  Eviction retires ONE cold buffer at a time from the
    least-recently-used class, never the hot class at the deque's end.

    Unless explicitly overridden (tests), enablement and capacity follow
    the MCA vars.
    """

    #: lock-discipline contract: every pool structure, including the
    #: checkout table the double-release guard scans, mutates only under
    #: the pool lock.  A checkout registered outside the lock let a
    #: concurrent double release of the same adopted owner pass the guard
    #: (its bytes looked neither free nor checked out) and repool memory
    #: in use.  The lock is an RLock because the weakref purge callback
    #: can fire from GC while the owning thread already holds it.
    _guarded_by = {"_free": "_lock", "_out": "_lock", "_adopted": "_lock",
                   "_bytes": "_lock", "hits": "_lock", "misses": "_lock"}

    def __init__(self, max_bytes: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        self._lock = threading.RLock()
        # size class -> deque of raw uint8 owner arrays (LIFO: the back is
        # the most recently released = warmest pages)
        self._free: OrderedDict[int, deque] = OrderedDict()
        # id(view handed out) -> (weakref(view), raw owner): release() maps
        # the caller's array back to pool memory without walking .base
        # chains; the weakref both guards against id() reuse and purges the
        # entry if the view dies unreleased
        self._out: dict[int, tuple] = {}
        # id(owner) of adopted foreign buffers currently in _free: a double
        # release of the same owner array would otherwise repool two
        # aliases of one memory block.  The pooled view keeps the owner
        # alive, so the id stays valid while it is in this set.
        self._adopted: set[int] = set()
        self._bytes = 0
        self._max_bytes = max_bytes
        self._enabled = enabled
        self.hits = 0
        self.misses = 0
        self._warned_noncontig = False

    @property
    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        return bool(_pool_var.value)

    @enabled.setter
    def enabled(self, v) -> None:
        self._enabled = bool(v) if v is not None else None

    @property
    def max_bytes(self) -> int:
        if self._max_bytes is not None:
            return self._max_bytes
        return int(_pool_bytes_var.value)

    @max_bytes.setter
    def max_bytes(self, v) -> None:
        self._max_bytes = int(v) if v is not None else None

    @staticmethod
    def _class_of(nbytes: int) -> int:
        if nbytes <= _MIN_CLASS:
            return _MIN_CLASS
        return 1 << (int(nbytes) - 1).bit_length()

    def _checkout(self, raw: np.ndarray, shape, dtype) -> np.ndarray:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize \
            if shape else np.dtype(dtype).itemsize
        view = raw[:nbytes].view(dtype).reshape(shape)
        token = id(view)
        with self._lock:
            # visible BEFORE the pool lock is ever released with raw popped
            # from its free bin: release()'s double-release guard scans _out
            # under the lock
            self._out[token] = (
                weakref.ref(view, lambda _r, t=token: self._purge(t)),
                raw)
        return view

    def _purge(self, token: int) -> None:
        """Weakref callback: a checked-out view died unreleased."""
        with self._lock:
            self._out.pop(token, None)

    @hot_path
    def acquire(self, shape, dtype) -> np.ndarray:
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        if not self.enabled:
            return np.empty(shape, dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize if shape \
            else dtype.itemsize
        cls = self._class_of(nbytes)
        t0 = time.perf_counter_ns() \
            if (trace.enabled or profile.enabled) else 0
        out = None
        with self._lock:
            dq = self._free.get(cls)
            if dq:
                raw = dq.pop()          # back = warmest
                if not dq:
                    del self._free[cls]
                else:
                    self._free.move_to_end(cls)
                if raw.base is not None:        # adopted foreign owner
                    self._adopted.discard(id(raw.base))
                self._bytes -= raw.nbytes
                self.hits += 1
                # checkout registration in the SAME critical section as the
                # free-bin pop (the RLock re-enters in _checkout): a popped
                # owner must never be observable as neither free nor
                # checked out
                out = self._checkout(raw, shape, dtype)
            else:
                self.misses += 1
        hit = out is not None
        if hit:
            spc.record("fastpath_staging_hits")
        else:
            spc.record("fastpath_staging_misses")
            # fresh allocation OUTSIDE the lock (first-touch page faults
            # are the expensive part); the owner was never pooled, so
            # nothing can race its checkout registration
            out = self._checkout(np.empty(cls, np.uint8), shape, dtype)
        if trace.enabled:
            name = "staging_hit" if hit else "staging_miss"
            trace.span(name, "staging", t0, args={"nbytes": nbytes})
            trace.hist_record(name, nbytes, time.perf_counter_ns() - t0)
        if profile.enabled:
            profile.stage_span("send.staging", t0)
        return out

    @hot_path
    def release(self, buf: np.ndarray) -> None:
        if not self.enabled:
            return
        if not buf.flags.c_contiguous:
            if sanitizer.enabled:
                sanitizer.fail(
                    "non-C-contiguous buffer released to the staging "
                    f"pool (shape {tuple(buf.shape)}, dtype {buf.dtype})"
                    " — layout bug in the caller")
            # a transformed checkout points at a layout bug in the caller:
            # warn once per pool, pool nothing
            if not self._warned_noncontig:
                self._warned_noncontig = True
                show_help("help-accel-staging", "non-contiguous-release",
                          shape=tuple(buf.shape), dtype=str(buf.dtype))
            return
        with self._lock:
            self._release_locked(buf)

    def _release_locked(self, buf: np.ndarray) -> None:
        entry = self._out.pop(id(buf), None)
        if entry is not None and entry[0]() is buf:
            raw = entry[1]              # pool view: repool its raw owner
        elif buf.base is not None:
            return   # foreign view (or a pool sub-view): the base owns the
                     # memory; pooling it would alias the caller
        else:
            # foreign owner (a caller's np.empty handed back): adopt it as a
            # flat byte view; the view's .base keeps it alive
            raw = buf.reshape(-1).view(np.uint8)
            if raw.nbytes < _MIN_CLASS:
                return
        # binned at the FLOOR class so every buffer in a bin covers every
        # request mapped there (requests bin at the ceiling): an adopted
        # odd-size raw must never ride into its ceiling class
        cls = 1 << (int(raw.nbytes).bit_length() - 1)
        if raw.nbytes > self.max_bytes:
            return   # could never be retained; pushing it through the LRU
                     # would flush every warm buffer first
        if raw.base is not None and (
                id(raw.base) in self._adopted
                or any(e[1].base is raw.base
                       for e in list(self._out.values()))):
            # double release: the owner is already in a free bin, or its
            # bytes are checked out right now; repooling would alias two
            # later acquires.  Both checks run under the pool lock.
            if sanitizer.enabled:
                sanitizer.fail(
                    "double release of a staging owner buffer "
                    f"({raw.nbytes} bytes): already pooled or checked out "
                    "— repooling would alias two later acquires")
            return
        dq = self._free.get(cls)
        if dq is None:
            dq = self._free[cls] = deque()
        dq.append(raw)
        if raw.base is not None:            # adopted foreign owner
            self._adopted.add(id(raw.base))
        self._free.move_to_end(cls)
        self._bytes += raw.nbytes
        # evict ONE cold buffer at a time from the least-recently-used
        # class, never the hot class just touched
        while self._bytes > self.max_bytes and self._free:
            cold_cls, cold = next(iter(self._free.items()))
            victim = cold.popleft()      # front = coldest
            if victim.base is not None:
                self._adopted.discard(id(victim.base))
            self._bytes -= victim.nbytes
            if not cold:
                del self._free[cold_cls]

    def clear(self) -> None:
        with self._lock:
            self._free.clear()
            self._out.clear()
            self._adopted.clear()
            self._bytes = 0
            self.hits = self.misses = 0

    def stats(self) -> dict:
        """Occupancy snapshot: pooled bytes, outstanding checkouts,
        lifetime hit/miss counts."""
        with self._lock:
            return {"bytes": self._bytes, "out": len(self._out),
                    "hits": self.hits, "misses": self.misses}


staging = _StagingPool()

# staging-pool occupancy for otpu_top (sampler-thread-only provider)
from ompi_tpu_torch.runtime import telemetry as _telemetry  # noqa: E402

_telemetry.register_source("staging", staging.stats)


def staging_acquire(shape, dtype) -> np.ndarray:
    """Checkout a host staging buffer (contents undefined)."""
    return staging.acquire(shape, dtype)


def staging_release(buf: np.ndarray) -> None:
    """Return a buffer checked out with :func:`staging_acquire`."""
    staging.release(buf)


def is_device_array(x: Any) -> bool:
    """True if ``x`` is a torch tensor (on any device)."""
    return isinstance(x, torch.Tensor)


def to_host(x) -> np.ndarray:
    """Stage a device buffer to host memory (D2H); bfloat16 comes back as
    ml_dtypes.bfloat16, as the JAX package returns it."""
    if isinstance(x, torch.Tensor):
        return cudaenv.to_numpy(x)
    return np.asarray(x)


def from_host(arr, device=None) -> torch.Tensor:
    """Stage host memory to ``device`` (H2D; default: the card)."""
    return cudaenv.make_world_array(arr, cudaenv.resolve_device(device))


register_help(
    "help-accel-staging", "non-contiguous-release",
    "A non-C-contiguous buffer (shape {shape}, dtype {dtype}) was "
    "released to the staging pool and cannot be repooled: staging "
    "checkouts are contiguous, so a transformed (transposed/strided) "
    "array points at a layout bug in the caller.  The buffer is "
    "dropped; this warning is shown once.")


def register(buf: np.ndarray, key: Any = None):
    """Expose a host region (RMA window registration)."""
    addr = buf.__array_interface__["data"][0]
    _rcache.insert(addr, addr + buf.nbytes, key or buf)
    return addr


def deregister(buf: np.ndarray) -> None:
    addr = buf.__array_interface__["data"][0]
    _rcache.delete(addr, addr + buf.nbytes)


def lookup(addr: int, nbytes: int):
    hit = _rcache.find_containing(addr, addr + nbytes)
    return None if hit is None else hit[2]
