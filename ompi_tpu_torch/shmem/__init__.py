"""OpenSHMEM-style PGAS layer over the osc windows.

Copy of ``ompi_tpu/shmem/__init__.py`` with its imports re-pointed: the same
allocator (its offsets are the reference's for the same sequence of allocs
and frees), verbs, contexts, active sets and collectives.  The symmetric
heap is a host window (``Win.create`` of ``uint8``, ``byte_addressed``):
``SymArray.local`` is a numpy view of ``win.local``, never a device tensor,
so the layer launches no kernel.  :func:`init` joins the world that
``ompi_tpu_torch.init`` boots (on the card unless the caller first called
``ompi_tpu_torch.init(device="cpu")``).

The design follows OpenSHMEM (spml put/get transport, memheap symmetric
allocator, scoll collectives, atomic framework) over this framework's own
layers, the way OSHMEM rides OMPI internals:

- **memheap** (``oshmem/mca/memheap/``): one symmetric heap per PE — a
  byte-typed osc window of identical size everywhere, with a collective
  first-fit allocator, so any symmetric object has the same offset on
  every PE (the property all of SHMEM rests on).
- **spml** (``oshmem/mca/spml/spml.h:60``): put/get/atomics lower onto the
  osc module (active-message or, in the device world, direct local copy).
- **scoll** (``oshmem/mca/scoll/mpi``): barrier/broadcast/collect/
  reductions reuse the coll framework through COMM_WORLD, exactly as
  OSHMEM's scoll/mpi component delegates to MPI collectives.

Usage::

    import ompi_tpu_torch.shmem as shmem
    shmem.init()        # after ompi_tpu_torch.init(device="cpu") off the card
    x = shmem.array(8, np.float64)        # symmetric allocation
    x.local[:] = shmem.my_pe()
    shmem.barrier_all()
    row = shmem.get(x, 8, pe=(shmem.my_pe() + 1) % shmem.n_pes())
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.var import VarType, registry

_heap_var = registry.register(
    "shmem", None, "heap_size", vtype=VarType.SIZE, default="16m",
    help="Symmetric heap size per PE (SHMEM_SYMMETRIC_SIZE analog)")

_lock = threading.Lock()
_ctx: Optional["_Shmem"] = None


class SymArray:
    """A symmetric allocation: same heap offset on every PE.

    ``local`` is this PE's view; remote access goes through put/get/
    atomics with this object as the address.
    """

    __slots__ = ("offset", "nbytes", "dtype", "count", "local")

    def __init__(self, offset: int, nbytes: int, dtype, count: int,
                 local: np.ndarray) -> None:
        self.offset = offset
        self.nbytes = nbytes
        self.dtype = np.dtype(dtype)
        self.count = count
        self.local = local

    def byte_offset(self, index: int = 0) -> int:
        return self.offset + index * self.dtype.itemsize


class _Shmem:
    def __init__(self, heap_bytes: int) -> None:
        import ompi_tpu_torch
        from ompi_tpu_torch.api.win import Win

        self.world = ompi_tpu_torch.init()
        self.heap_bytes = heap_bytes
        self.win = Win.create(self.world, size=heap_bytes, dtype=np.uint8,
                              name="shmem_heap")
        self.win.byte_addressed = True   # offsets are bytes; RMA is typed
        # first-fit free list of (offset, size) — collective symmetric
        # calls keep it identical on every PE (memheap invariant)
        self.free_list: list[tuple[int, int]] = [(0, heap_bytes)]
        # (PE_start, logPE_stride, PE_size) -> sub-communicator cache
        self.active_sets: dict = {}

    # -- memheap allocator ----------------------------------------------
    def alloc(self, nbytes: int, align: int = 16) -> int:
        for i, (off, size) in enumerate(self.free_list):
            start = (off + align - 1) & ~(align - 1)
            used = start - off + nbytes
            if used <= size:
                rest = []
                if start > off:
                    rest.append((off, start - off))
                if size > used:
                    rest.append((start + nbytes, size - (used)))
                self.free_list[i:i + 1] = rest
                return start
        raise MpiError(ErrorClass.ERR_NO_MEM
                       if hasattr(ErrorClass, "ERR_NO_MEM")
                       else ErrorClass.ERR_OTHER,
                       f"symmetric heap exhausted ({nbytes} bytes)")

    def release(self, off: int, nbytes: int) -> None:
        self.free_list.append((off, nbytes))
        # coalesce adjacent runs
        self.free_list.sort()
        merged = []
        for o, s in self.free_list:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((o, s))
        self.free_list = [tuple(t) for t in merged]


def _get() -> _Shmem:
    if _ctx is None:
        raise MpiError(ErrorClass.ERR_OTHER, "shmem.init() not called")
    return _ctx


# -- setup / teardown ---------------------------------------------------

def init(heap_size: Optional[int] = None):
    """``shmem_init``: collective; sets up the symmetric heap."""
    global _ctx
    with _lock:
        if _ctx is None:
            _ctx = _Shmem(int(heap_size or _heap_var.value))
    return _ctx


def finalize() -> None:
    global _ctx
    with _lock:
        if _ctx is not None:
            _ctx.win.free()
            _ctx = None


def my_pe() -> int:
    return _get().world.rank


def n_pes() -> int:
    return _get().world.size


# -- symmetric allocation ------------------------------------------------

def array(count: int, dtype=np.float64, align_bytes: int = 16) -> SymArray:
    """``shmem_malloc``: collective; identical offset on every PE."""
    ctx = _get()
    dt = np.dtype(dtype)
    nbytes = count * dt.itemsize
    off = ctx.alloc(nbytes, align=max(16, int(align_bytes)))
    local = ctx.win.local[off:off + nbytes].view(dt)
    return SymArray(off, nbytes, dt, count, local)


def free(sym: SymArray) -> None:
    """``shmem_free``: collective."""
    _get().release(sym.offset, sym.nbytes)


# -- spml: put / get ------------------------------------------------------

def put(sym: SymArray, value, pe: int, index: int = 0) -> None:
    """``shmem_put``: write ``value`` into ``sym`` on PE ``pe``."""
    ctx = _get()
    arr = np.ascontiguousarray(value, dtype=sym.dtype)
    ctx.win.put(arr.view(np.uint8).reshape(-1), pe, sym.byte_offset(index))


def get(sym: SymArray, count: int, pe: int, index: int = 0) -> np.ndarray:
    """``shmem_get``: read ``count`` elements of ``sym`` from PE ``pe``."""
    ctx = _get()
    raw = ctx.win.get(count * sym.dtype.itemsize, pe,
                      sym.byte_offset(index))
    return np.asarray(raw).view(sym.dtype)


def p(sym: SymArray, value, pe: int, index: int = 0) -> None:
    """``shmem_p``: single-element put."""
    put(sym, np.asarray([value], dtype=sym.dtype), pe, index)


def g(sym: SymArray, pe: int, index: int = 0):
    """``shmem_g``: single-element get."""
    return get(sym, 1, pe, index)[0]


# -- atomics --------------------------------------------------------------

def atomic_add(sym: SymArray, value, pe: int, index: int = 0) -> None:
    _atomic_op(sym, value, pe, index, op_mod.SUM)


def atomic_fetch_add(sym: SymArray, value, pe: int, index: int = 0):
    return _atomic_fetch_op(sym, value, pe, index, op_mod.SUM)


def atomic_inc(sym: SymArray, pe: int, index: int = 0) -> None:
    atomic_add(sym, 1, pe, index)


def atomic_fetch(sym: SymArray, pe: int, index: int = 0):
    return atomic_fetch_add(sym, 0, pe, index)


def atomic_swap(sym: SymArray, value, pe: int, index: int = 0):
    return _atomic_fetch_op(sym, value, pe, index, op_mod.REPLACE)


def atomic_compare_swap(sym: SymArray, cond, value, pe: int,
                        index: int = 0):
    ctx = _get()
    return ctx.win.compare_and_swap(
        np.asarray(value, dtype=sym.dtype)[()],
        np.asarray(cond, dtype=sym.dtype)[()], pe, sym.byte_offset(index))


# -- ordering / sync ------------------------------------------------------

def fence() -> None:
    """``shmem_fence``: order my puts per target (flush_all here)."""
    _get().win.flush_all()


def quiet() -> None:
    """``shmem_quiet``: complete all my outstanding puts everywhere."""
    _get().win.flush_all()


def barrier_all() -> None:
    """``shmem_barrier_all``: quiet + world barrier."""
    quiet()
    _get().world.barrier()


def _active_set_comm(pe_start: int, log_pe_stride: int, pe_size: int):
    """Sub-communicator for a (PE_start, logPE_stride, PE_size) active
    set — the classic SHMEM subset triple (``shmem_barrier.c``).

    Built with ``Comm.create_group`` (non-collective over the world):
    ONLY active-set PEs participate, exactly the OpenSHMEM contract —
    the rest of the job may never call shmem_barrier at all.  Cached
    per triple (OSHMEM's ``oshmem/proc/proc_group_cache.c``
    plays the same role)."""
    ctx = _get()
    key = (pe_start, log_pe_stride, pe_size)
    if key not in ctx.active_sets:   # None (non-member) is a valid
        from ompi_tpu_torch.api.group import Group   # cached value

        stride = 1 << log_pe_stride
        members = [pe_start + i * stride for i in range(pe_size)]
        ctx.active_sets[key] = ctx.world.create_group(Group(members))
    return ctx.active_sets[key]


def _is_world_set(pe_start: int, log_pe_stride: int,
                  pe_size: int) -> bool:
    return pe_start == 0 and log_pe_stride == 0 and pe_size == n_pes()


def barrier(pe_start: int = 0, log_pe_stride: int = 0,
            pe_size: int = None) -> None:
    """``shmem_barrier``: quiet + barrier over the active set (only
    active-set PEs call — Comm.create_group keeps it non-collective
    over the rest of the job)."""
    if pe_size is None:
        pe_size = n_pes()
    quiet()
    if _is_world_set(pe_start, log_pe_stride, pe_size):
        _get().world.barrier()     # no duplicate world comm
        return
    comm = _active_set_comm(pe_start, log_pe_stride, pe_size)
    if comm is not None:
        comm.barrier()


def sync_all() -> None:
    """``shmem_sync_all``: barrier WITHOUT remote-memory completion
    (no quiet — PE arrival only)."""
    _get().world.barrier()


def sync(pe_start: int = 0, log_pe_stride: int = 0,
         pe_size: int = None) -> None:
    """``shmem_sync``: active-set arrival barrier, no quiet."""
    if pe_size is None:
        pe_size = n_pes()
    if _is_world_set(pe_start, log_pe_stride, pe_size):
        _get().world.barrier()
        return
    comm = _active_set_comm(pe_start, log_pe_stride, pe_size)
    if comm is not None:
        comm.barrier()


def info_get_version() -> tuple:
    """``shmem_info_get_version``: OpenSHMEM spec (major, minor)."""
    return (1, 4)


def info_get_name() -> str:
    """``shmem_info_get_name``: vendor string."""
    return "ompi_tpu_torch-shmem"


def set_cache_inv() -> None:
    """``shmem_set_cache_inv``: deprecated cache control — a no-op on
    cache-coherent hardware, exactly as OSHMEM implements it
    (``oshmem/shmem/c/shmem_set_cache_inv.c``)."""


def set_cache_line_inv(addr=None) -> None:
    """Deprecated; no-op (coherent memory)."""


def clear_cache_inv() -> None:
    """Deprecated; no-op (coherent memory)."""


def clear_cache_line_inv(addr=None) -> None:
    """Deprecated; no-op (coherent memory)."""


def udcflush() -> None:
    """Deprecated; no-op (coherent memory)."""


def udcflush_line(addr=None) -> None:
    """Deprecated; no-op (coherent memory)."""


# -- scoll: collectives over the comm layer (scoll/mpi) ------------------

def broadcast(sym: SymArray, root: int = 0) -> None:
    """``shmem_broadcast``: root's content lands in every PE's ``sym``."""
    ctx = _get()
    out = ctx.world.bcast(np.array(sym.local, copy=True), root=root)
    sym.local[:] = np.asarray(out).reshape(sym.local.shape)


def collect(sym: SymArray) -> np.ndarray:
    """``shmem_collect``: concatenation of every PE's ``sym``."""
    ctx = _get()
    out = np.asarray(ctx.world.allgather(np.array(sym.local, copy=True)))
    return out.reshape(-1).view(sym.dtype)


def sum_to_all(sym: SymArray) -> None:
    """``shmem_sum_to_all`` (wor): allreduce-SUM into ``sym`` everywhere."""
    _reduce_to_all(sym, op_mod.SUM)


def max_to_all(sym: SymArray) -> None:
    _reduce_to_all(sym, op_mod.MAX)


def min_to_all(sym: SymArray) -> None:
    _reduce_to_all(sym, op_mod.MIN)


def _reduce_to_all(sym: SymArray, op) -> None:
    ctx = _get()
    out = ctx.world.allreduce(np.array(sym.local, copy=True), op)
    sym.local[:] = np.asarray(out).reshape(sym.local.shape)


def prod_to_all(sym: SymArray) -> None:
    _reduce_to_all(sym, op_mod.PROD)


def and_to_all(sym: SymArray) -> None:
    _reduce_to_all(sym, op_mod.BAND)


def or_to_all(sym: SymArray) -> None:
    _reduce_to_all(sym, op_mod.BOR)


def xor_to_all(sym: SymArray) -> None:
    _reduce_to_all(sym, op_mod.BXOR)


def fcollect(sym: SymArray) -> np.ndarray:
    """``shmem_fcollect``: fixed-size collect (same as collect here —
    symmetric allocations are same-sized by construction)."""
    return collect(sym)


def alltoall(sym: SymArray) -> np.ndarray:
    """``shmem_alltoall``: block i of my ``sym`` goes to PE i; returns
    the n_pes blocks received (also written back into ``sym.local``)."""
    ctx = _get()
    n = ctx.world.size
    if sym.count % n:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       f"alltoall needs count % n_pes == 0, got "
                       f"{sym.count} % {n}")
    out = ctx.world.alltoall(np.array(sym.local, copy=True).reshape(n, -1))
    flat = np.asarray(out).reshape(-1).view(sym.dtype)
    sym.local[:] = flat
    return flat


# -- strided / nonblocking put-get (shmem_iput/iget, *_nbi) ---------------

def iput(sym: SymArray, value, tst: int, sst: int, count: int,
         pe: int, index: int = 0) -> None:
    """``shmem_iput``: strided put — element i of ``value`` (stride sst)
    lands at target index ``index + i*tst`` (``index`` plays the role of
    OpenSHMEM's target-pointer arithmetic).

    Contiguous targets (tst == 1) go as ONE transfer; true strided
    targets must stay per-element — a bulk read-modify-write of the
    covering range would clobber concurrent writes to the gap elements.
    """
    src = np.ascontiguousarray(value, dtype=sym.dtype).reshape(-1)
    strided = src[::sst][:count] if sst > 1 else src[:count]
    if tst == 1:
        put(sym, strided, pe, index=index)
        return
    for i in range(count):
        p(sym, strided[i], pe, index=index + i * tst)


def iget(sym: SymArray, tst: int, sst: int, count: int,
         pe: int, index: int = 0) -> np.ndarray:
    """``shmem_iget``: strided get — returns ``count`` elements taken at
    source stride sst from base ``index`` (tst orders the local
    result).  One bulk get of the covering range + a local stride slice
    (reads have no gap-clobber hazard, so bulk is safe and ~count×
    fewer AM round trips)."""
    span = (count - 1) * sst + 1
    block = get(sym, span, pe, index=index)
    return np.ascontiguousarray(block[::sst][:count])


def put_nbi(sym: SymArray, value, pe: int, index: int = 0) -> None:
    """``shmem_put_nbi``: delivery is only guaranteed after quiet()."""
    put(sym, value, pe, index)


def get_nbi(sym: SymArray, count: int, pe: int, index: int = 0):
    """``shmem_get_nbi`` analog: here gets complete on return (the
    active-message spml has no split-phase read), which satisfies the
    spec's 'complete by quiet' contract trivially."""
    return get(sym, count, pe, index)


# -- point-to-point synchronization (shmem_wait_until / test) -------------

CMP_EQ = "=="
CMP_NE = "!="
CMP_GT = ">"
CMP_GE = ">="
CMP_LT = "<"
CMP_LE = "<="

_CMPS = {
    CMP_EQ: lambda a, b: a == b,
    CMP_NE: lambda a, b: a != b,
    CMP_GT: lambda a, b: a > b,
    CMP_GE: lambda a, b: a >= b,
    CMP_LT: lambda a, b: a < b,
    CMP_LE: lambda a, b: a <= b,
}


def test(sym: SymArray, cmp: str, value, index: int = 0) -> bool:
    """``shmem_test``: one non-blocking check of a local symmetric word."""
    from ompi_tpu_torch.runtime.progress import progress

    progress()        # let inbound AM puts land
    return bool(_CMPS[cmp](sym.local[index], sym.dtype.type(value)))


def wait_until(sym: SymArray, cmp: str, value, index: int = 0) -> None:
    """``shmem_wait_until``: spin (with progress) until the local word
    satisfies the comparison — the classic SHMEM point-to-point signal."""
    from ompi_tpu_torch.runtime.progress import progress

    fn = _CMPS[cmp]
    target = sym.dtype.type(value)
    while not fn(sym.local[index], target):
        progress()


# -- distributed locks (shmem_set_lock / test_lock / clear_lock) ----------
# OSHMEM implements these over remote atomics in the lock owner's
# symmetric word (oshmem/src/shmem_lock.c uses a ticket scheme); here:
# test-and-set via atomic CAS on PE 0's copy, MCS-free but fair enough
# for the API contract (mutual exclusion + eventual acquisition).

def set_lock(lock: SymArray, index: int = 0) -> None:
    """``shmem_set_lock``: acquire; spins with backoff on contention."""
    import time as _time

    me = my_pe() + 1          # 0 = unlocked; owner stored as pe+1
    delay = 1e-5
    while True:
        prev = atomic_compare_swap(lock, 0, me, pe=0, index=index)
        if prev == 0:
            return
        _time.sleep(delay)
        delay = min(delay * 2, 2e-3)


def test_lock(lock: SymArray, index: int = 0) -> bool:
    """``shmem_test_lock``: try-acquire; True if the lock was taken."""
    return bool(atomic_compare_swap(lock, 0, my_pe() + 1, pe=0,
                                    index=index) == 0)


def clear_lock(lock: SymArray, index: int = 0) -> None:
    """``shmem_clear_lock``: release (must hold it); quiets first so
    writes in the critical section are visible before the release."""
    quiet()
    prev = atomic_compare_swap(lock, my_pe() + 1, 0, pe=0, index=index)
    if prev != my_pe() + 1:
        raise MpiError(ErrorClass.ERR_RMA_SYNC,
                       f"clear_lock by non-owner (lock word {prev})")


# -- communication contexts (shmem_ctx_*, oshmem/include/shmem.h.in:207) --
#
# A context is an independent ordering/completion domain: quiet(ctx)
# completes only the operations issued ON that context, so independent
# streams (e.g. per-thread) never serialize against each other.  The
# active-message spml tracks per-context outstanding-put counts; the
# window flush is the completion point.

class Ctx:
    """``shmem_ctx_t``: an independent put/get/atomic issue stream."""

    #: shmem_ctx_create option bits (shmem.h.in)
    SERIALIZED = 1
    PRIVATE = 2
    NOSTORE = 4

    def __init__(self, options: int = 0) -> None:
        self.options = int(options)
        self._destroyed = False

    def _check(self) -> None:
        if self._destroyed:
            raise MpiError(ErrorClass.ERR_OTHER, "shmem ctx destroyed")

    # issue surface: same verbs, bound to this context's domain
    def put(self, sym, value, pe, index=0):
        self._check()
        return put(sym, value, pe, index)

    def get(self, sym, count, pe, index=0):
        self._check()
        return get(sym, count, pe, index)

    def p(self, sym, value, pe, index=0):
        self._check()
        return p(sym, value, pe, index)

    def g(self, sym, pe, index=0):
        self._check()
        return g(sym, pe, index)

    def atomic_add(self, sym, value, pe, index=0):
        self._check()
        return atomic_add(sym, value, pe, index)

    def atomic_fetch_add(self, sym, value, pe, index=0):
        self._check()
        return atomic_fetch_add(sym, value, pe, index)

    def atomic_compare_swap(self, sym, cond, value, pe, index=0):
        self._check()
        return atomic_compare_swap(sym, cond, value, pe, index)

    def fence(self) -> None:
        """Order THIS context's puts per target."""
        self._check()
        fence()

    def quiet(self) -> None:
        """Complete THIS context's outstanding operations.  The window
        flush completes at least this context's ops (completing more is
        spec-legal; contexts exist so callers need not wait on streams
        they did not issue — the API contract, not a perf split, in the
        active-message spml)."""
        self._check()
        quiet()

    def destroy(self) -> None:
        if not self._destroyed:
            self.quiet()
            self._destroyed = True


#: ``SHMEM_CTX_DEFAULT``
CTX_DEFAULT = Ctx()


def ctx_create(options: int = 0) -> Ctx:
    """``shmem_ctx_create`` (shmem.h.in:207)."""
    _get()
    return Ctx(options)


def ctx_destroy(ctx: Ctx) -> None:
    """``shmem_ctx_destroy``: implicit quiet, then invalidate."""
    ctx.destroy()


# -- bitwise / set atomics (shmem_atomic_{and,or,xor,set} + fetch) --------

def _atomic_op(sym: SymArray, value, pe: int, index: int, op) -> None:
    _get().win.accumulate(np.asarray([value], dtype=sym.dtype), pe,
                          sym.byte_offset(index), op)


def _atomic_fetch_op(sym: SymArray, value, pe: int, index: int, op):
    out = _get().win.get_accumulate(
        np.asarray([value], dtype=sym.dtype), pe, sym.byte_offset(index),
        op)
    a = np.asarray(out)
    return a.view(sym.dtype)[0] if a.dtype != sym.dtype else a[0]


def atomic_and(sym: SymArray, value, pe: int, index: int = 0) -> None:
    _atomic_op(sym, value, pe, index, op_mod.BAND)


def atomic_or(sym: SymArray, value, pe: int, index: int = 0) -> None:
    _atomic_op(sym, value, pe, index, op_mod.BOR)


def atomic_xor(sym: SymArray, value, pe: int, index: int = 0) -> None:
    _atomic_op(sym, value, pe, index, op_mod.BXOR)


def atomic_fetch_and(sym: SymArray, value, pe: int, index: int = 0):
    return _atomic_fetch_op(sym, value, pe, index, op_mod.BAND)


def atomic_fetch_or(sym: SymArray, value, pe: int, index: int = 0):
    return _atomic_fetch_op(sym, value, pe, index, op_mod.BOR)


def atomic_fetch_xor(sym: SymArray, value, pe: int, index: int = 0):
    return _atomic_fetch_op(sym, value, pe, index, op_mod.BXOR)


def atomic_set(sym: SymArray, value, pe: int, index: int = 0) -> None:
    """``shmem_atomic_set``: atomic store (REPLACE accumulate)."""
    _atomic_op(sym, value, pe, index, op_mod.REPLACE)


# -- strided alltoall (shmem_alltoalls32/64) ------------------------------

def alltoalls(sym: SymArray, dst: int, sst: int, nelems: int) -> np.ndarray:
    """``shmem_alltoalls``: strided alltoall — PE j takes elements
    ``[j*sst*nelems : +nelems*sst : sst]``... per the spec, element k of
    the block for PE j is read at ``sst*(j*nelems + k)`` and written at
    ``dst*(j*nelems + k)``.  Returns the received (contiguous) blocks and
    scatters them into ``sym.local`` at target stride ``dst``."""
    ctx = _get()
    n = ctx.world.size
    if dst < 1 or sst < 1 or nelems < 0:
        raise MpiError(ErrorClass.ERR_ARG,
                       f"alltoalls needs dst >= 1, sst >= 1, nelems >= 0 "
                       f"(got dst={dst}, sst={sst}, nelems={nelems})")
    need_src = sst * (n * nelems - 1) + 1
    need_dst = dst * (n * nelems - 1) + 1
    if max(need_src, need_dst) > sym.count:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       f"alltoalls needs {max(need_src, need_dst)} "
                       f"elements, symmetric array has {sym.count}")
    src = np.array(sym.local[: sst * n * nelems : sst], copy=True)
    out = ctx.world.alltoall(src.reshape(n, nelems))
    flat = np.asarray(out).reshape(-1).astype(sym.dtype, copy=False)
    sym.local[: dst * n * nelems : dst] = flat
    return flat


# -- accessibility probes (shmem.h.in:180-195) ----------------------------

def pe_accessible(pe: int) -> bool:
    """``shmem_pe_accessible``: a valid, live PE."""
    ctx = _get()
    if not 0 <= pe < ctx.world.size:
        return False
    from ompi_tpu_torch.ft import state as ft_state

    return not ft_state.is_failed(ctx.world.group.world_rank(pe))


def addr_accessible(sym: SymArray, pe: int) -> bool:
    """``shmem_addr_accessible``: symmetric address valid on that PE."""
    if not pe_accessible(pe):
        return False
    ctx = _get()
    return 0 <= sym.offset and sym.offset + sym.nbytes <= ctx.heap_bytes


def shmem_ptr(sym: SymArray, pe: int):
    """``shmem_ptr`` (shmem.h.in:195): a direct load/store view of the
    peer's symmetric object when its heap is locally mapped (same-host
    shared segments / the single-controller device world); None
    otherwise — NULL is always a legal return per the spec."""
    ctx = _get()
    if pe == ctx.world.rank:
        return sym.local
    try:
        base = ctx.win.shared_query(pe)
    except Exception:
        return None
    if base is None:
        return None
    raw = np.asarray(base).view(np.uint8)
    return raw[sym.offset:sym.offset + sym.nbytes].view(sym.dtype)


# -- allocation variants (shmem_calloc / align / realloc) -----------------

def calloc(count: int, dtype=np.float64) -> SymArray:
    """``shmem_calloc``: zero-initialized symmetric allocation."""
    sym = array(count, dtype)
    sym.local[:] = 0
    return sym


def align(alignment: int, count: int, dtype=np.float64) -> SymArray:
    """``shmem_align``: symmetric allocation at the given alignment."""
    return array(count, dtype, align_bytes=alignment)


def realloc(sym: SymArray, count: int) -> SymArray:
    """``shmem_realloc``: collective; preserves the common prefix."""
    new = array(count, sym.dtype)
    keep = min(count, sym.count)
    new.local[:keep] = sym.local[:keep]
    free(sym)
    return new


def global_exit(status: int = 0) -> None:
    """``shmem_global_exit``: terminate ALL PEs with ``status``."""
    ctx = _get()
    rte = ctx.world.rte
    try:
        abort = getattr(rte, "abort", None)
        if abort is not None:
            abort(int(status))
    finally:
        import os

        os._exit(int(status))


def reset_for_testing() -> None:
    global _ctx
    _ctx = None
