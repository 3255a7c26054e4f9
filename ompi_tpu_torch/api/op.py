"""Reduction operators (``ompi/op/op.c`` + the ``ompi/mca/op/`` framework).

Port of ``ompi_tpu/api/op.py``.  Each named MPI op carries its numpy host
kernel (``op(invec, inoutvec)``: ``inoutvec = invec (op) inoutvec``, MPI's
argument order), which coll/conductor folds host buffers with, and the
torch reduction over the rank axis it lowers to where one exists (SUM ->
``sum``, MAX -> ``amax``, MIN -> ``amin``; the JAX package's
``psum``/``pmax``/``pmin``).  Every other op is a gather plus a fold that
the MCA ``op`` framework supplies: :func:`torch_stack_reduce` (one pass over
a ``(k, ...)`` stack) and :func:`torch_fold` (two operands) take the place
of ``jax_stack_reduce``/``jax_fold``.  User ops (``create``, the
``MPI_Op_create`` analog) carry a numpy function and a commute flag and
fold host buffers only.

Host reductions of 1 MB and more (SUM, PROD, MAX, MIN on float32/64,
int32/64, contiguous) fan out over the threads framework's worker pool
(``_pool_reduce``, ``ompi_tpu/api/op.py:53-95``) when the pool runs parallel
native loops (``threads/native``); otherwise the ufunc runs inline.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError


class Op:
    def __init__(self, name: str, commute: bool = True,
                 torch_reduce: Optional[str] = None,
                 builtin: bool = False, fn: Optional[Callable] = None) -> None:
        self.name = name
        self.commute = commute
        self.torch_reduce = torch_reduce  # "sum" | "amax" | "amin" | None
        self.builtin = builtin
        self._fn = fn

    def __call__(self, invec, inoutvec, datatype=None):
        """inoutvec = invec (op) inoutvec — MPI argument order."""
        if self._fn is None:
            raise MpiError(ErrorClass.ERR_OP, f"{self.name} not callable")
        return self._fn(invec, inoutvec, datatype)

    def reduce_arrays(self, a: np.ndarray, b: np.ndarray,
                      datatype=None) -> np.ndarray:
        """Pure reduction of two operand arrays: ``a (op) b`` into a copy
        of ``b``."""
        out = b.copy()
        self(a, out, datatype)
        return out

    def __repr__(self) -> str:
        return f"Op({self.name}, commute={self.commute})"


#: ufuncs the threads-framework pool can run as parallel native spans
_POOL_UFUNC = {np.add: "sum", np.multiply: "prod",
               np.maximum: "max", np.minimum: "min"}
_POOL_DTYPES = ("float32", "float64", "int32", "int64")
#: big host reductions fan out over the worker pool (op/avx discipline:
#: keep the reduction math at the speed of every memory channel)
_POOL_REDUCE_MIN = 1 << 20


def _pool_reduce(ufunc, invec, inoutvec) -> bool:
    opname = _POOL_UFUNC.get(ufunc)
    if (opname is None or not isinstance(inoutvec, np.ndarray)
            or not isinstance(invec, np.ndarray)
            or inoutvec.nbytes < _POOL_REDUCE_MIN
            or str(inoutvec.dtype) not in _POOL_DTYPES
            or invec.dtype != inoutvec.dtype
            or invec.shape != inoutvec.shape
            or not (invec.flags.c_contiguous
                    and inoutvec.flags.c_contiguous)):
        return False
    from ompi_tpu_torch.mca.threads import base as threads_base

    pool = threads_base.get_pool()
    if not getattr(pool, "parallel_pack", False) or pool.size < 2:
        return False
    # commutative elementwise: acc = acc (op) src == invec (op) inoutvec
    pool.reduce(opname, inoutvec, invec).wait()
    return True


def _elementwise(ufunc):
    # write straight into inoutvec: the temp-then-copy form doubles memory
    # traffic, which is THE cost of a host reduction
    def fn(invec, inoutvec, datatype=None):
        if not _pool_reduce(ufunc, invec, inoutvec):
            ufunc(invec, inoutvec, out=inoutvec)
    return fn


def _logical(np_fn):
    def fn(invec, inoutvec, datatype=None):
        inoutvec[...] = np_fn(invec.astype(bool), inoutvec.astype(bool)) \
            .astype(inoutvec.dtype)
    return fn


def _loc_op(extremum):
    """MAXLOC/MINLOC on pair-type structured arrays (fields 'v' and 'i')."""
    def fn(invec, inoutvec, datatype=None):
        if invec.dtype.fields is None or "v" not in invec.dtype.fields:
            raise MpiError(ErrorClass.ERR_OP,
                           "MINLOC/MAXLOC need a pair datatype")
        a_v, b_v = invec["v"], inoutvec["v"]
        if extremum == "max":
            take_a = (a_v > b_v) | ((a_v == b_v) & (invec["i"] < inoutvec["i"]))
        else:
            take_a = (a_v < b_v) | ((a_v == b_v) & (invec["i"] < inoutvec["i"]))
        inoutvec["v"] = np.where(take_a, a_v, b_v)
        inoutvec["i"] = np.where(take_a, invec["i"], inoutvec["i"])
    return fn


def _replace(invec, inoutvec, datatype=None):
    inoutvec[...] = invec


def _no_op(invec, inoutvec, datatype=None):
    pass


SUM = Op("SUM", True, "sum", builtin=True, fn=_elementwise(np.add))
PROD = Op("PROD", True, builtin=True, fn=_elementwise(np.multiply))
MAX = Op("MAX", True, "amax", builtin=True, fn=_elementwise(np.maximum))
MIN = Op("MIN", True, "amin", builtin=True, fn=_elementwise(np.minimum))
LAND = Op("LAND", True, builtin=True, fn=_logical(np.logical_and))
LOR = Op("LOR", True, builtin=True, fn=_logical(np.logical_or))
LXOR = Op("LXOR", True, builtin=True, fn=_logical(np.logical_xor))
BAND = Op("BAND", True, builtin=True, fn=_elementwise(np.bitwise_and))
BOR = Op("BOR", True, builtin=True, fn=_elementwise(np.bitwise_or))
BXOR = Op("BXOR", True, builtin=True, fn=_elementwise(np.bitwise_xor))
MAXLOC = Op("MAXLOC", True, builtin=True, fn=_loc_op("max"))
MINLOC = Op("MINLOC", True, builtin=True, fn=_loc_op("min"))
REPLACE = Op("REPLACE", False, builtin=True, fn=_replace)
NO_OP = Op("NO_OP", False, builtin=True, fn=_no_op)

BUILTIN_OPS = {
    op.name: op
    for op in (SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR,
               MAXLOC, MINLOC, REPLACE, NO_OP)
}


def create(fn: Callable, commute: bool) -> Op:
    """``MPI_Op_create``: user function fn(invec, inoutvec, datatype)."""
    return Op(f"user_{id(fn):x}", commute=commute, fn=fn)


def torch_stack_reduce(op: Op, dtype=None) -> Optional[Callable]:
    """Fused reduction of a (k, ...) stack along axis 0, if any op
    component provides one (cuda_vpu's ``reduce_stack``); None otherwise.
    Callers fall back to chained :func:`torch_fold`."""
    from ompi_tpu_torch.mca.op import base as op_base

    if op.name not in BUILTIN_OPS:
        return None
    return op_base.select_stack(op.name, dtype)


def torch_fold(op: Op, dtype=None, fusable: bool = False) -> Callable:
    """A two-operand fold for device-side reductions, from the MCA ``op``
    framework: the highest-priority component covering (op, dtype) wins
    (``ompi/mca/op/base/op_base_op_select.c``).  ``fusable=True`` (scan and
    exscan) asks for a fold that runs as plain torch ops: the kernel
    component declines, as pallas_vpu declines in the reference."""
    from ompi_tpu_torch.mca.op import base as op_base

    fn = op_base.select_fold(op.name, dtype, fusable=fusable)
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
