"""coll/quant — the accuracy-budget decision ladder of the quantized collectives.

Port of the device half of ``ompi_tpu/mca/coll/quant.py``: the rule that
decides, per communicator, whether a device collective may run through a
lossy block codec, and which.  coll/builtin consumes it
(``allreduce_array``, ``allgather_array``); the codec kernels are in
``ompi_tpu_torch/ops/quant.py`` (int8, K17–K19) and, for bf16, plain torch
casts, as the reference computes that codec outside any Pallas kernel.

Quantization is LOSSY, so it engages only under an EXPLICIT
per-communicator accuracy budget (the info key :data:`BUDGET_KEY`), never
for non-commutative reductions (the codec reorders rounding error the way
a ring reorders operands), and never for exact or non-float32 dtypes.

Not ported yet: the numpy codec (``encode_f32``/``decode_f32``), the host
collective variants, the btl wire stage and the serving KV slabs, with
their ``block``, ``wire``, ``wire_codec`` and ``kv_codec`` vars (they come
with the host tier and serving), and the SPC counters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.output import register_help, show_help
from ompi_tpu_torch.base.var import VarType

#: codec names, and the accuracy band each one charges against the declared
#: budget.  bf16 rounds to 7 stored mantissa bits: per-element relative error
#: <= 2^-8.  int8's single-encode bound is half a step of the block max
#: (0.5/127), but a reduction folds one independent quantization error per
#: rank, so the ladder charges a full step (1/127).  The ladder admits a
#: codec only when the comm's declared budget covers its band.
CODECS = ("int8", "bf16")
CODEC_BANDS = {"int8": 1.0 / 127.0, "bf16": 2.0 ** -8}

#: collectives the quant tier implements (the reference's list; alltoallv's
#: quantized path is the MoE dispatch's int8 packing, which asks ``pick``
#: for "alltoallv" in ``parallel/moe.py``'s ``dispatch_tokens``)
QUANT_COLLS = ("allreduce", "allgather", "alltoallv")

DEFAULT_MIN_BYTES = 64 << 10

#: the comm info key carrying the accuracy budget (max relative error the
#: application accepts).  Mutable through the budget_key var; this module
#: global IS the current name (one dict probe on the device fast path).
BUDGET_KEY = "otpu_quant_budget"


def _set_budget_key(value) -> None:
    global BUDGET_KEY
    BUDGET_KEY = str(value or "otpu_quant_budget")


def _is_float32(dtype) -> bool:
    """True for torch.float32 and numpy float32 (the reference's
    ``np.dtype(dtype) == np.float32``, which raises TypeError on a torch
    dtype and so would never quantize a tensor)."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


def decide(coll: str, dtype, nbytes: int, budget: Optional[float],
           commute: bool = True, min_bytes: int = None) -> Optional[str]:
    """The quant rule key as a pure function: codec name, or None.

    A cell quantizes only when EVERY gate passes: an explicit positive
    budget, a supported collective, a commutative reduction, a float32
    payload, and a message big enough to earn the encode."""
    if not budget or budget <= 0.0:
        return None
    if coll not in QUANT_COLLS or not commute:
        return None
    if dtype is None or not _is_float32(dtype):
        return None
    if nbytes < (DEFAULT_MIN_BYTES if min_bytes is None else min_bytes):
        return None
    for codec in ("int8", "bf16"):   # deepest compression first
        if budget >= CODEC_BANDS[codec]:
            return codec
    return None


def budget_of(comm) -> Optional[float]:
    """The comm's declared accuracy budget (info key), or None."""
    raw = comm.info.get(BUDGET_KEY)
    if raw is None:
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        show_help("help-coll-quant", "bad-budget",
                  info_key=BUDGET_KEY, value=raw)
        return None
    return value if value > 0.0 else None


def pick(comm, coll: str, dtype, nbytes: int, op=None) -> Optional[str]:
    """Ladder entry for the dispatch sites (coll/builtin): the comm's
    budget and the min_bytes var through :func:`decide`."""
    budget = budget_of(comm)
    if budget is None:
        return None
    commute = bool(getattr(op, "commute", True)) if op is not None else True
    return decide(coll, dtype, int(nbytes), budget, commute, min_bytes())


class QuantCollComponent(Component):
    """Config home.  comm_query answers None: quant is not a per-comm
    module — coll/builtin consumes its ladder directly."""

    name = "quant"
    priority = 0

    def register_vars(self, fw) -> None:
        self._min = self.register_var(
            "min_bytes", vtype=VarType.SIZE, default="64k",
            help="Smallest payload (the whole (n, ...) world tensor) the "
                 "quant ladder considers — below this the encode costs more "
                 "than the bytes it saves")
        self._budget_key = self.register_var(
            "budget_key", vtype=VarType.STRING,
            default="otpu_quant_budget", on_set=_set_budget_key,
            help="Comm info key read for the per-communicator accuracy "
                 "budget (max relative error) that arms the quant decision "
                 "ladder")

    def comm_query(self, comm):
        return None


COMPONENT = QuantCollComponent()


def min_bytes() -> int:
    v = getattr(COMPONENT, "_min", None)
    return int(v.value) if v is not None and v.value is not None \
        else DEFAULT_MIN_BYTES


register_help(
    "help-coll-quant", "bad-budget",
    "The communicator info key {info_key!r} carries {value!r}, which does "
    "not parse as a positive float.  The accuracy budget is the max "
    "relative error the application accepts (>= 1/127 ~ 0.0079 admits "
    "the int8 block codec, >= 2^-8 ~ 0.0039 bf16); quantization stays "
    "OFF for this communicator.")
