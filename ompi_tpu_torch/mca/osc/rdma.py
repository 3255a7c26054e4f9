"""osc/rdma — one-sided RMA over mapped shared-memory windows.

Copy of ``ompi_tpu/mca/osc/rdma.py`` (a redesign of the reference's
``ompi/mca/osc/rdma/``, which maps windows for direct BTL put/get and makes
locks and accumulate atomicity from remote atomic CAS,
``osc_rdma_accumulate.c:26-71``): every rank's exposure region is a
``multiprocessing.shared_memory`` segment that the peers of its node map
directly.  put/get are copies into the target's memory with NO target-side
agent (the one-sided property); locks and atomics are shared-memory
atomics of the port's native core (``ompi_tpu_torch.native``: exclusive
and shared lock words, fetch-add, CAS, loads and stores).

Segment layout::

    [ user_lock u64 | acc_lock u64 | post_epoch u64 | complete_cnt u64 ]
    [ data ... ]

``user_lock`` backs MPI_Win_lock/unlock (bit 63 exclusive, the low bits
shared readers); ``acc_lock`` serializes accumulates (the reference's
dedicated accumulate lock); the last two words drive PSCW without messages.
Segments are named ``otpt_w<coord>_<cid>_<rank>_<pid>``: the port's prefix
(btl/sm's ``NAME_PREFIX``) where the reference's is ``otpu_``.

Selected above osc/pt2pt when every member of the window's communicator
shares a node and the native core is built; otherwise pt2pt's
active-message path serves (the reference's RDMA-capable / AM-fallback
split).
"""
from __future__ import annotations

import os
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.btl.sm import NAME_PREFIX, _attach

_HDR = 32
_USER_LOCK = 0
_ACC_LOCK = 8
_POST_EPOCH = 16
_COMPLETE_CNT = 24


class _Seg:
    """One rank's mapped window segment (mine or a peer's)."""

    def __init__(self, shm: shared_memory.SharedMemory, dtype,
                 owner: bool) -> None:
        import ctypes

        self.shm = shm
        self.owner = owner
        self.dtype = np.dtype(dtype)
        self.addr = ctypes.addressof(ctypes.c_char.from_buffer(shm.buf))
        self.data = np.frombuffer(shm.buf, np.uint8, offset=_HDR)

    def typed(self) -> np.ndarray:
        n = self.data.nbytes // self.dtype.itemsize
        return self.data[:n * self.dtype.itemsize].view(self.dtype)


class RdmaModule:
    def __init__(self, component: "RdmaOscComponent") -> None:
        self._c = component
        self._segs: dict[int, _Seg] = {}     # comm rank -> mapped segment
        self._post_seen: dict[int, int] = {} # PSCW: last seen post epoch
        self._held: dict[int, str] = {}      # target -> held lock type
        self._start_group: Optional[list] = None
        self._post_group_size = 0

    # -- lifecycle -------------------------------------------------------
    def attach(self, win) -> None:
        from ompi_tpu_torch import native

        self._native = native
        rte = win.comm.rte
        size = win.local.nbytes
        tag = os.environ.get("OTPU_COORD", "l").replace(":", "_") \
            .replace(".", "_")
        name = (f"{NAME_PREFIX}_w{tag}_{win.comm.cid}_{win.comm.rank}_"
                f"{os.getpid() & 0xffff}")
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=_HDR + max(1, size))
        shm.buf[:_HDR] = b"\0" * _HDR
        shm.buf[_HDR:_HDR + size] = win.local.view(np.uint8).tobytes()
        seg = _Seg(shm, win.local.dtype, owner=True)
        self._segs[win.comm.rank] = seg
        # my exposure region IS the mapped data from now on: local loads/
        # stores and peers' RMA see one memory
        win.local = seg.typed()[:size // max(1, seg.dtype.itemsize)]
        rte.modex_put(f"osc_rdma_{win.comm.cid}", name)
        self._win = win

    def detach(self, win) -> None:
        # Win.free barriers before detach, so every peer is done.  close()
        # can fail while user views of the mapped data are still alive
        # (BufferError); the owner must unlink regardless so the segment
        # is reclaimed when the last mapping drops.
        for seg in self._segs.values():
            try:
                seg.data = None     # drop our export before close
                seg.shm.close()
            except BufferError:
                # user still holds views of the mapped data (win.local
                # escaped) — close is impossible until those die, and
                # retrying from SharedMemory.__del__ at interpreter
                # exit would only print "Exception ignored" noise.
                # Swallow ONLY the BufferError on later attempts (not
                # close itself): if the views die first, the __del__
                # retry still releases the fd/mapping instead of
                # leaking it until process exit.
                def _close_quietly(_orig=seg.shm.close):
                    try:
                        _orig()
                    except BufferError:
                        pass

                seg.shm.close = _close_quietly
            except Exception:
                pass
            if seg.owner:
                try:
                    seg.shm.unlink()
                except Exception:
                    pass
        self._segs.clear()

    def _seg(self, win, target: int) -> _Seg:
        seg = self._segs.get(target)
        if seg is None:
            name = win.comm.rte.modex_get(
                win.comm.world_rank(target), f"osc_rdma_{win.comm.cid}")
            seg = _Seg(_attach(name), win.local.dtype, owner=False)
            self._segs[target] = seg
        return seg

    def _view(self, win, target: int, arr_dtype, offset: int, nbytes: int):
        seg = self._seg(win, target)
        base = seg.typed()
        if win.byte_addressed and arr_dtype != base.dtype:
            return seg.data[offset:offset + nbytes].view(arr_dtype)
        count = nbytes // max(1, np.dtype(arr_dtype).itemsize)
        return base[offset:offset + count]

    # -- RMA ops (direct load/store: the one-sided property) -------------
    def put(self, win, arr, target: int, offset: int) -> None:
        view = self._view(win, target, arr.dtype, offset, arr.nbytes)
        view[:] = arr.astype(view.dtype, copy=False).reshape(view.shape)

    def get(self, win, count: int, target: int, offset: int) -> np.ndarray:
        seg = self._seg(win, target)
        base = seg.typed()
        return np.array(base[offset:offset + count], copy=True)

    def _acc_lock(self, seg: _Seg):
        addr = seg.addr + _ACC_LOCK
        while not self._native.lock_excl_try(addr):
            time.sleep(0)          # yield; holder is another process
        return addr

    def accumulate(self, win, arr, target: int, offset: int, op) -> None:
        seg = self._seg(win, target)
        addr = self._acc_lock(seg)
        try:
            view = self._view(win, target, arr.dtype, offset, arr.nbytes)
            op(arr.astype(view.dtype, copy=False)
               if not (win.byte_addressed and arr.dtype != seg.dtype)
               else arr, view)
        finally:
            self._native.lock_excl_release(addr)

    def get_accumulate(self, win, arr, target: int, offset: int,
                       op) -> np.ndarray:
        seg = self._seg(win, target)
        addr = self._acc_lock(seg)
        try:
            view = self._view(win, target, arr.dtype, offset, arr.nbytes)
            old = np.array(view, copy=True)
            op(arr.astype(view.dtype, copy=False)
               if not (win.byte_addressed and arr.dtype != seg.dtype)
               else arr, view)
            return old
        finally:
            self._native.lock_excl_release(addr)

    def compare_and_swap(self, win, value, compare, target: int,
                         offset: int):
        # always under the accumulate lock: MPI requires CAS to be atomic
        # WITH RESPECT TO concurrent accumulates, whose numpy read-modify-
        # write is only protected by that lock (a lock-free native CAS
        # here could land between another rank's read and write)
        seg = self._seg(win, target)
        value = np.asarray(value)
        addr = self._acc_lock(seg)
        try:
            view = self._view(win, target, value.dtype, offset,
                              value.dtype.itemsize)
            old = view[0]
            if old == compare:
                view[0] = value
            return old
        finally:
            self._native.lock_excl_release(addr)

    # -- synchronization --------------------------------------------------
    def fence(self, win) -> None:
        # loads/stores are synchronous in mapped memory; only order ranks
        win.comm.barrier()

    def flush(self, win, target: int) -> None:
        pass                       # direct stores: already complete

    def lock(self, win, target: int, lock_type: str) -> None:
        seg = self._seg(win, target)
        addr = seg.addr + _USER_LOCK
        try_fn = (self._native.lock_excl_try
                  if lock_type == "exclusive"
                  else self._native.lock_shared_try)
        while not try_fn(addr):
            time.sleep(0)
        self._held[target] = lock_type   # per-target: concurrent
        # distinct-target locks are legal MPI

    def unlock(self, win, target: int) -> None:
        seg = self._seg(win, target)
        addr = seg.addr + _USER_LOCK
        lock_type = self._held.pop(target, "exclusive")
        if lock_type == "exclusive":
            self._native.lock_excl_release(addr)
        else:
            self._native.lock_shared_release(addr)

    def sync(self, win) -> None:
        pass

    # -- PSCW via shared counters (no messages) ---------------------------
    def post(self, win, group) -> None:
        """Expose to the access group: bump my post epoch."""
        self._post_group_size = group.size
        seg = self._segs[win.comm.rank]
        cur = self._native.atomic_load_u64(seg.addr + _POST_EPOCH)
        self._native.atomic_store_u64(seg.addr + _POST_EPOCH, cur + 1)

    def start(self, win, group) -> None:
        """Open an access epoch: wait for each target's post."""
        self._start_group = [win.comm.group.rank_of(r)
                             for r in group.world_ranks]
        for t in self._start_group:
            seg = self._seg(win, t)
            seen = self._post_seen.get(t, 0)
            while self._native.atomic_load_u64(
                    seg.addr + _POST_EPOCH) <= seen:
                time.sleep(0)
            self._post_seen[t] = seen + 1

    def complete(self, win) -> None:
        for t in self._start_group or []:
            seg = self._seg(win, t)
            self._native.atomic_add_i64(seg.addr + _COMPLETE_CNT, 1)
        self._start_group = None

    def wait(self, win) -> None:
        while not self.pscw_test(win):
            time.sleep(0)

    def pscw_test(self, win) -> bool:
        """Nonblocking ``wait`` (MPI_Win_test) — the one copy of the
        epoch-close accounting; ``wait`` spins on it."""
        seg = self._segs[win.comm.rank]
        want = self._post_group_size
        if self._native.atomic_load_u64(seg.addr + _COMPLETE_CNT) < want:
            return False
        self._native.atomic_add_i64(seg.addr + _COMPLETE_CNT, -want)
        return True


class RdmaOscComponent(Component):
    name = "rdma"
    priority = 60

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=60,
            help="Selection priority of osc/rdma (mapped-window RMA)")

    def win_query(self, win):
        rte = win.comm.rte
        if rte is None or rte.is_device_world:
            return None
        if getattr(win, "dynamic", False):
            return None   # dynamic regions need the active-message path
        if getattr(rte, "client", None) is None:
            return None
        try:
            from ompi_tpu_torch import native

            if not native.available():
                return None
        except Exception:
            return None
        # every member must share my node (mapped memory reach)
        my_node = rte.node_of(rte.my_world_rank)
        if my_node is None:
            return None
        for w in win.comm.group.world_ranks:
            if rte.node_of(w) != my_node:
                return None
        return self._prio.value, RdmaModule(self)


COMPONENT = RdmaOscComponent()
