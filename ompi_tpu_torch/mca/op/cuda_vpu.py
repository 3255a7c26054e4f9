"""op/cuda_vpu — hand-written fold kernels for the card (the op/avx analog).

Port of ``ompi_tpu/mca/op/pallas_vpu.py``.  Reference:
``ompi/mca/op/avx/op_avx_component.c`` registers with a high priority and
per-type checks against the CPU's capabilities; here the capability check
is the world's device.  With the world on the card the Triton kernels of
``ompi_tpu_torch/ops/reduce.py`` win (priority 50); with the world on the
CPU their plain versions work but win nothing over the builtin torch folds
(priority 10), so the priority drops to 5 — as pallas_vpu drops off-TPU.
"""
from __future__ import annotations

import functools

from ompi_tpu_torch.base import mca
from ompi_tpu_torch.ops import reduce


def _world_on_card() -> bool:
    """Whether the current world lives on a CUDA device (before init: whether
    there is a card at all, the default world device)."""
    import torch

    from ompi_tpu_torch.runtime import init as rt

    rte = rt.get_rte()
    device = getattr(rte, "device", None)
    if device is None:
        return torch.cuda.is_available()
    return device.type == "cuda"


class CudaVpuComponent(mca.Component):
    name = "cuda_vpu"
    priority = 50

    def register_vars(self, fw) -> None:
        self._prio_var = self.register_var(
            "priority", vtype=mca.VarType.INT, default=50,
            help="Selection priority of the hand-written reduction kernels")

    def open(self) -> bool:
        self.priority = int(self._prio_var.value)
        if not _world_on_card():
            # the plain versions work on the CPU but win nothing over
            # op/builtin; defer to it
            self.priority = min(self.priority, 5)
        return True

    def close(self) -> None:
        from ompi_tpu_torch.mca.op import base as op_base

        op_base.reset_cache()

    def query_fold(self, op_name: str, dtype, fusable: bool = False):
        if fusable:
            return None  # a kernel launch, not a fold of plain torch ops
        return reduce.device_fold(op_name, dtype)

    def query_stack(self, op_name: str, dtype):
        if reduce.device_fold(op_name, dtype) is None:
            return None
        return functools.partial(reduce.reduce_stack, op_name)


COMPONENT = CudaVpuComponent()
