"""osc/local — windows in the single-controller models.

Copy of ``ompi_tpu/mca/osc/local.py`` (the counterpart of the reference's
``osc/sm``): when every rank's exposure region lives in one address space
(the device world's conductor, or a comm of one), RMA is direct memory
access.  Each rank's base array sits in a per-window table; ops index the
table and apply at once; synchronization collapses to no-ops (one thread of
control orders every epoch).
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType


class LocalModule:
    def attach(self, win) -> None:
        # one region per rank, all hosted here (conductor model)
        self._bases = {r: (np.array(win.local, copy=True) if r != win.rank
                           else win.local)
                       for r in range(win.size)}

    def detach(self, win) -> None:
        self._bases.clear()

    def base_of(self, rank: int) -> np.ndarray:
        return self._bases[rank]

    # -- ops -------------------------------------------------------------
    def put(self, win, arr, target: int, offset: int) -> None:
        self._bases[target][offset:offset + arr.size] = arr

    def get(self, win, count: int, target: int, offset: int) -> np.ndarray:
        return np.array(self._bases[target][offset:offset + count], copy=True)

    def accumulate(self, win, arr, target: int, offset: int, op) -> None:
        base = self._bases[target]
        if win.byte_addressed and arr.dtype != base.dtype:
            # byte-addressed heap window: typed view at a byte offset
            view = base[offset:offset + arr.nbytes].view(arr.dtype)
            op(arr, view)
        else:
            view = base[offset:offset + arr.size]
            op(arr.astype(base.dtype, copy=False), view)

    def get_accumulate(self, win, arr, target: int, offset: int,
                       op) -> np.ndarray:
        base = self._bases[target]
        if win.byte_addressed and arr.dtype != base.dtype:
            old = np.array(base[offset:offset + arr.nbytes].view(arr.dtype),
                           copy=True)
        else:
            old = self.get(win, arr.size, target, offset)
        self.accumulate(win, arr, target, offset, op)
        return old

    def compare_and_swap(self, win, value, compare, target: int, offset: int):
        base = self._bases[target]
        value = np.asarray(value)
        if win.byte_addressed and value.dtype != base.dtype:
            view = base[offset:offset + value.dtype.itemsize].view(value.dtype)
            old = view[0]
            if old == compare:
                view[0] = value
            return old
        old = base[offset]
        if old == compare:
            base[offset] = value
        return old

    # -- sync: one thread of control, all trivially ordered --------------
    def flush(self, win, target: int) -> None:
        pass

    def fence(self, win) -> None:
        pass

    def lock(self, win, target: int, lock_type: str) -> None:
        pass

    def unlock(self, win, target: int) -> None:
        pass

    def post(self, win, group) -> None:
        pass

    def start(self, win, group) -> None:
        pass

    def complete(self, win) -> None:
        pass

    def wait(self, win) -> None:
        pass


class LocalComponent(Component):
    name = "local"

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=80,
            help="Selection priority of osc/local")

    def win_query(self, win):
        if getattr(win, "dynamic", False):
            return None   # region RMA needs the active-message path
        if (win.comm.rte is not None and win.comm.rte.is_device_world) \
                or win.comm.size == 1:
            return self._prio.value, LocalModule()
        return None


COMPONENT = LocalComponent()
