"""Reduction operators (``ompi/op/op.c`` + the ``ompi/mca/op/`` framework).

Port of ``ompi_tpu/api/op.py``.  Each named MPI op carries the torch
reduction over the rank axis it lowers to where one exists (SUM ->
``sum``, MAX -> ``amax``, MIN -> ``amin``; the JAX package's
``psum``/``pmax``/``pmin``).  Every other op is a gather plus a fold that
the MCA ``op`` framework supplies: :func:`torch_stack_reduce` (one pass over
a ``(k, ...)`` stack) and :func:`torch_fold` (two operands) take the place
of ``jax_stack_reduce``/``jax_fold``.  The numpy host kernels of the
reference have no user in the port yet.
"""
from __future__ import annotations

from typing import Callable, Optional

from ompi_tpu_torch.api.errors import ErrorClass, MpiError


class Op:
    def __init__(self, name: str, commute: bool = True,
                 torch_reduce: Optional[str] = None,
                 builtin: bool = False) -> None:
        self.name = name
        self.commute = commute
        self.torch_reduce = torch_reduce  # "sum" | "amax" | "amin" | None
        self.builtin = builtin

    def __repr__(self) -> str:
        return f"Op({self.name}, commute={self.commute})"


SUM = Op("SUM", True, "sum", builtin=True)
PROD = Op("PROD", True, builtin=True)
MAX = Op("MAX", True, "amax", builtin=True)
MIN = Op("MIN", True, "amin", builtin=True)
LAND = Op("LAND", True, builtin=True)
LOR = Op("LOR", True, builtin=True)
LXOR = Op("LXOR", True, builtin=True)
BAND = Op("BAND", True, builtin=True)
BOR = Op("BOR", True, builtin=True)
BXOR = Op("BXOR", True, builtin=True)
MAXLOC = Op("MAXLOC", True, builtin=True)
MINLOC = Op("MINLOC", True, builtin=True)
REPLACE = Op("REPLACE", False, builtin=True)
NO_OP = Op("NO_OP", False, builtin=True)

BUILTIN_OPS = {
    op.name: op
    for op in (SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR,
               MAXLOC, MINLOC, REPLACE, NO_OP)
}


def torch_stack_reduce(op: Op, dtype=None) -> Optional[Callable]:
    """Fused reduction of a (k, ...) stack along axis 0, if any op
    component provides one (cuda_vpu's ``reduce_stack``); None otherwise.
    Callers fall back to chained :func:`torch_fold`."""
    from ompi_tpu_torch.mca.op import base as op_base

    if op.name not in BUILTIN_OPS:
        return None
    return op_base.select_stack(op.name, dtype)


def torch_fold(op: Op, dtype=None) -> Callable:
    """A two-operand fold for device-side reductions, from the MCA ``op``
    framework: the highest-priority component covering (op, dtype) wins
    (``ompi/mca/op/base/op_base_op_select.c``)."""
    from ompi_tpu_torch.mca.op import base as op_base

    fn = op_base.select_fold(op.name, dtype)
    if fn is None:
        raise MpiError(ErrorClass.ERR_OP,
                       f"op {op.name} has no device lowering")
    return fn


def reduce_local(inbuf, inoutbuf, op: Op):
    """``MPI_Reduce_local`` on tensors: ``inoutbuf = inbuf (op) inoutbuf``
    with the op framework's fold (kernel K2, ``combine2``, for a tensor on
    the card); returns ``inoutbuf``.  The JAX package's form
    (``ompi_tpu/datatype/__init__.py:84``) applies the numpy host kernel."""
    if inbuf.shape != inoutbuf.shape or inbuf.dtype != inoutbuf.dtype:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       f"reduce_local needs matching buffers, got "
                       f"{tuple(inbuf.shape)} {inbuf.dtype} and "
                       f"{tuple(inoutbuf.shape)} {inoutbuf.dtype}")
    return inoutbuf.copy_(torch_fold(op, inbuf.dtype)(inbuf, inoutbuf))
