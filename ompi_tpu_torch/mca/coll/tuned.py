"""coll/tuned — the device-tier fused ladder cells.

Port of the device half of ``ompi_tpu/mca/coll/tuned.py``: the
communication-fused matmul programs (``ops/overlap.py``, K20) that
jit-adjacent call sites consult by name — the MoE expert FFN,
``parallel/moe.expert_ffn_fused`` — and the one force-var that governs
them, ``otpu_coll_tuned_fused_cells``.  They are not rows of a host menu:
a host algorithm takes ``(comm, buf, ...)``, a cell ``(a, b, n)``.

This component is a config home, as coll/quant is: ``comm_query`` answers
None, so coll selection and every slot's owner stay as they were.  Not
ported yet: the host ladder (``_MENUS``, ``TunedModule``, the dynamic rule
file, the per-collective force and segment-size vars, the eager lane); it
comes with the host tier.
"""
from __future__ import annotations

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType

#: the device-tier ladder cells (ops/overlap)
DEVICE_CELLS = ("matmul_allreduce", "matmul_reduce_scatter")


def device_cell(name: str):
    """Resolve a device-tier fused ladder cell, honoring the force-var.

    Returns the ``ops/overlap`` kernel callable, or None when the fused tier
    is disabled (``fused_cells=off``) or the var forces a DIFFERENT cell —
    the caller then takes its unfused form."""
    if name not in DEVICE_CELLS:
        raise KeyError(f"no device ladder cell {name!r} (known: "
                       f"{', '.join(DEVICE_CELLS)})")
    forced = COMPONENT.fused_cells_var()
    if forced == "off" or (forced and forced != name):
        return None
    from ompi_tpu_torch.ops import overlap

    return getattr(overlap, name)


class TunedCollComponent(Component):
    """Config home of the device cells; comm_query answers None."""

    name = "tuned"
    priority = 30

    def register_vars(self, fw) -> None:
        self._fused = self.register_var(
            "fused_cells", vtype=VarType.STRING, default="",
            help="Device-tier fused ladder cells (ops/overlap) consulted via "
                 f"device_cell(): one of {', '.join(DEVICE_CELLS)} to force "
                 "that cell only, 'off' to disable the fused tier (callers "
                 "take their unfused einsum form), empty = ladder decides")

    def fused_cells_var(self) -> str:
        v = getattr(self, "_fused", None)
        return (v.value or "").strip() if v is not None else ""

    def comm_query(self, comm):
        return None


COMPONENT = TunedCollComponent()
