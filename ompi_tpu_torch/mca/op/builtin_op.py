"""op/builtin — plain torch reduction folds, the always-available base.

Port of ``ompi_tpu/mca/op/xla_op.py`` (op/xla).  Reference analog: the
base C loops every op falls back to when no SIMD component covers the
(op, type) pair (``ompi/mca/op/base``).
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.base import mca


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


_TABLE = {
    "SUM": torch.add,
    "PROD": torch.mul,
    "MAX": torch.maximum,
    "MIN": torch.minimum,
    "LAND": _logical(torch.logical_and),
    "LOR": _logical(torch.logical_or),
    "LXOR": _logical(torch.logical_xor),
    "BAND": torch.bitwise_and,
    "BOR": torch.bitwise_or,
    "BXOR": torch.bitwise_xor,
}


class BuiltinOpComponent(mca.Component):
    name = "builtin"
    priority = 10

    def close(self) -> None:
        from ompi_tpu_torch.mca.op import base as op_base

        op_base.reset_cache()

    def query_fold(self, op_name: str, dtype, fusable: bool = False):
        return _TABLE.get(op_name)


COMPONENT = BuiltinOpComponent()
