"""osc/device — RMA windows on the card (device-memory windows).

Port of ``ompi_tpu/mca/osc/device.py``.  The device world's data model:
the window is one tensor of shape ``(size, n)`` on the world's device, and
row r is rank r's exposure region.  put, get, accumulate (SUM, MAX, MIN,
PROD, REPLACE; ``ERR_OP`` otherwise), get_accumulate and compare_and_swap
are indexed in-place torch ops on a row slice, where the reference makes
XLA ``.at[]`` updates (``device.py:57-95``); neither reaches a kernel of
its own.  ``get`` returns numpy, as the reference's does, and
``win.device_array`` stays the tensor.

The window keeps the base's dtype.  The reference's window is a
``jax.device_put`` of the base, so without ``jax_enable_x64`` a float64
base (``Win.create``'s default) gives a float32 window there; the port's
stays float64 (pinned in ``tests/test_torch_osc.py``).

Single-controller model: the conductor issues every rank's operations in
stream order, so epochs are ordered by construction and the
synchronization calls are no-ops.  Select with ``Win.create(comm, ...,
device=True)`` in a device world.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType


class DeviceModule:
    """Window = (size, n) tensor on the world's device, row r rank r's."""

    def attach(self, win) -> None:
        base = np.broadcast_to(np.asarray(win.local),
                               (win.size, win.local.size))
        self._win_array = torch.from_numpy(np.array(base)).to(
            win.comm.rte.device)
        win.device_array = self._win_array
        # the exposure region lives on the card: drop the host alias, so
        # that stores to a stale win.local cannot diverge from RMA
        win.local = None

    def detach(self, win) -> None:
        self._win_array = None
        win.device_array = None

    def _vals(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)).to(
            device=self._win_array.device, dtype=self._win_array.dtype)

    # -- data path (indexed in-place updates of one row slice) ------------
    def put(self, win, arr, target: int, offset: int) -> None:
        vals = self._vals(arr)
        self._win_array[target, offset:offset + vals.numel()].copy_(vals)

    def get(self, win, count: int, target: int, offset: int) -> np.ndarray:
        return self._win_array[target, offset:offset + count].to(
            "cpu", copy=True).numpy()

    def accumulate(self, win, arr, target: int, offset: int, op) -> None:
        vals = self._vals(arr)
        view = self._win_array[target, offset:offset + vals.numel()]
        if op is op_mod.SUM:
            view.add_(vals)
        elif op is op_mod.MAX:
            torch.maximum(view, vals, out=view)
        elif op is op_mod.MIN:
            torch.minimum(view, vals, out=view)
        elif op is op_mod.PROD:
            view.mul_(vals)
        elif op is op_mod.REPLACE:
            view.copy_(vals)
        else:
            raise MpiError(ErrorClass.ERR_OP,
                           f"device window accumulate: unsupported {op}")

    def get_accumulate(self, win, arr, target: int, offset: int,
                       op) -> np.ndarray:
        old = self.get(win, np.asarray(arr).size, target, offset)
        self.accumulate(win, arr, target, offset, op)
        return old

    def compare_and_swap(self, win, value, compare, target: int,
                         offset: int):
        old = self.get(win, 1, target, offset)[0]
        if old == compare:
            self.put(win, np.asarray([value]), target, offset)
        return old

    # -- sync: one thread of control orders everything --------------------
    def fence(self, win) -> None:
        pass

    def flush(self, win, target: int) -> None:
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


class DeviceOscComponent(Component):
    name = "device"
    priority = 90     # above osc/local: explicit device=True windows only

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=90,
            help="Selection priority of osc/device (windows on the card)")

    def win_query(self, win):
        rte = win.comm.rte
        if rte is None or not rte.is_device_world:
            return None
        if not getattr(win, "device", False):
            return None
        if getattr(rte, "device", None) is None:
            return None
        return self._prio.value, DeviceModule()


COMPONENT = DeviceOscComponent()
