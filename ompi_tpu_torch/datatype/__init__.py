"""Datatype engine: described-layout memory + stateful pack/unpack convertor.

Copy of ``ompi_tpu/datatype/__init__.py`` (after the reference's
``opal/datatype/`` and ``ompi/datatype/``): MPI named types and the full
constructor set build a *type map* that is flattened and coalesced into
elementary segments; the :class:`Convertor` is the stateful pack/unpack
iterator with partial-buffer resume and repositioning
(``opal_convertor.c``), with external32 conversion and checksums.
``bfloat16``/``float16`` are named types.
"""
from ompi_tpu_torch.datatype.core import (  # noqa: F401
    Datatype,
    BYTE,
    PACKED,
    BOOL,
    INT8,
    INT16,
    INT32,
    INT64,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    FLOAT16,
    BFLOAT16,
    FLOAT32,
    FLOAT64,
    COMPLEX64,
    COMPLEX128,
    FLOAT_INT,
    DOUBLE_INT,
    LONG_INT,
    SHORT_INT,
    TWO_INT,
    NAMED_TYPES,
    from_numpy_dtype,
    contiguous,
    vector,
    hvector,
    indexed,
    hindexed,
    hindexed_block,
    indexed_block,
    create_struct,
    subarray,
    darray,
    resized,
    ORDER_C,
    ORDER_FORTRAN,
    DISTRIBUTE_BLOCK,
    DISTRIBUTE_CYCLIC,
    DISTRIBUTE_NONE,
    DISTRIBUTE_DFLT_DARG,
)
from ompi_tpu_torch.datatype.convertor import Convertor, ConvertorFlags  # noqa: F401


def pack(buf, count, datatype, external32: bool = False) -> bytes:
    """``MPI_Pack`` (/ ``MPI_Pack_external``): described memory → a
    contiguous byte stream, via the convertor (``ompi/mpi/c/pack.c``)."""
    flags = ConvertorFlags.EXTERNAL32 if external32 else ConvertorFlags.NONE
    # user-facing MPI_Pack keeps the documented bytes contract; the hot
    # path (pml/btl) consumes the convertor's zero-extra-copy array form
    return Convertor(datatype, count, buf, flags=flags).pack().tobytes()


def unpack(data, buf, count, datatype, external32: bool = False) -> int:
    """``MPI_Unpack``: byte stream → described memory; returns the bytes
    consumed."""
    flags = ConvertorFlags.EXTERNAL32 if external32 else ConvertorFlags.NONE
    return Convertor(datatype, count, buf, flags=flags).unpack(data)


def pack_size(count, datatype, external32: bool = False) -> int:
    """``MPI_Pack_size``: an upper bound on pack()'s output size."""
    return count * datatype.size


def reduce_local(inbuf, inoutbuf, op) -> None:
    """``MPI_Reduce_local``: inoutbuf = inbuf (op) inoutbuf — the op
    kernel applied locally (``ompi/mpi/c/reduce_local.c``; kernel table
    ≅ ``ompi/mca/op``)."""
    op(inbuf, inoutbuf)
