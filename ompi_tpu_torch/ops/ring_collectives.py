"""Ring all-reduce kernels for the card — port of ``ompi_tpu/ops/pallas_collectives.py``.

The JAX package runs its explicit ring schedules as Pallas kernels over a
1-D device mesh: every rank holds its ``(n, rows, 128)`` payload, ring
blocks travel rank to rank by remote DMA and each hop folds.  In the port the
n virtual ranks are the rows of one tensor on one card (``x[i]`` is rank
i's buffer), so the remote copies disappear and what stays is the
arithmetic of the schedule: the ring-block partition, the fold order, and
the accumulator regime.

``all_reduce(x, n, op, variant, seg_elems)`` — ``(n, *S)`` to ``(*S)``:

* ``'fused'`` — kernel K3 (``csrc/ring_fused.cu``), replacing
  ``pc._build_all_reduce`` (``pallas_collectives.py:361``): the whole
  accumulator on chip (registers here, VMEM there).
* ``'seg'`` — kernel K4 (``csrc/ring_seg.cu``), replacing
  ``pc._build_all_reduce_seg`` (``pallas_collectives.py:674``): the
  accumulator in device memory, each ring step streamed through a
  double-buffered shared-memory window.  ``seg_elems`` (the TPU kernel's
  VMEM window) rounds the ring blocks up to whole windows, as in the
  reference, which fixes the block partition and so the fold order; the
  card's window is a per-block shared-memory tile.

The other variants of the reference (``bidi``, ``seg_bidi``, ``wire16``)
are not ported yet and raise ``NotImplementedError``.

Block b of the result is ``fold(x[b-1], fold(x[b-2], ... fold(x[b+1],
x[b])))`` over blocks of ``rows*128`` elements (``_jit_all_reduce``,
``pallas_collectives.py:1577-1620``), padded with ``_pad_value`` — the
order of the TPU ring, kept by the kernels and the plain versions, so the
port is bit-identical with the reference.  A CPU tensor goes to the plain
version, a CUDA tensor to the kernel; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv

#: default VMEM window (elements) of the segmented kernels when the caller
#: does not size it (``pallas_collectives._DEFAULT_SEG_ELEMS``)
_DEFAULT_SEG_ELEMS = 131072

_FOLDS = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum,
          "min": torch.minimum}
_OPCODE = {"sum": 0, "prod": 1, "max": 2, "min": 3}
_DTCODE = {torch.float16: 0, torch.float32: 1, torch.float64: 2}
_NOT_PORTED = ("bidi", "seg_bidi", "wire16")

#: kernel launches per wrapper (plain-version calls are not counted)
launches = {"all_reduce_fused": 0, "all_reduce_seg": 0}


def _rows_for(elems: int) -> int:
    """128-lane rows covering ``elems`` elements (>= 1)."""
    return max(1, -(-elems // 128))


def _seg_rows(rows: int, seg_elems: int | None) -> tuple[int, int]:
    """(window rows, padded block rows): the window is ``seg_elems`` rounded
    down to whole 128-lane rows, never exceeding the ring block; the block is
    rounded up to a whole number of windows."""
    srows = max(1, min((seg_elems or _DEFAULT_SEG_ELEMS) // 128, rows))
    return srows, -(-rows // srows) * srows


def _pad_value(op: str, dtype: torch.dtype) -> float | int:
    """Neutral element padding the payload to n equal ring blocks; the
    dtype's extrema for max/min (finfo also for bfloat16)."""
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    lim = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return lim.min if op == "max" else lim.max


def ring_block_elems(size: int, n: int, variant: str,
                     seg_elems: int | None = None) -> int:
    """Elements per ring block for a payload of ``size`` elements."""
    rows = _rows_for(-(-size // n))
    if variant == "seg":
        _, rows = _seg_rows(rows, seg_elems)
    return rows * 128


def _check(x, n: int, op: str, variant: str) -> bool:
    """Argument checks shared by kernels and plain versions; returns whether
    the kernel runs (x lies on the card)."""
    if variant in _NOT_PORTED:
        raise NotImplementedError(
            f"ring all_reduce variant {variant!r} is not ported yet")
    if variant not in ("fused", "seg"):
        raise ValueError(f"unknown ring all_reduce variant {variant!r}")
    if op not in _FOLDS:
        raise ValueError(
            f"unsupported ring reduction {op!r}: one of sum/max/min/prod")
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"ring all_reduce needs a leading rank axis of {n}, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in _DTCODE:
        raise TypeError(f"ring all_reduce takes float16/32/64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("ring all_reduce needs a contiguous tensor")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ring all_reduce runs on cuda or cpu, got {x.device}")
    return cudaenv.on_card(x)


# -- plain versions ------------------------------------------------------

def _ring_plain(x: torch.Tensor, n: int, op: str, blk: int) -> torch.Tensor:
    """The ring schedule on whole blocks: the partial of block b starts as
    rank b's block and rank b+k folds its own block in, ``fold(own,
    partial)``, for k = 1..n-1."""
    size = x[0].numel()
    xp = torch.full((n, n * blk), _pad_value(op, x.dtype), dtype=x.dtype,
                    device=x.device)
    xp[:, :size] = x.reshape(n, size)
    xb = xp.view(n, n, blk)                      # [rank, block, element]
    fold = _FOLDS[op]
    blocks = torch.arange(n, device=x.device)
    acc = xb[blocks, blocks]
    for k in range(1, n):
        acc = fold(xb[(blocks + k) % n, blocks], acc)
    return acc.reshape(-1)[:size].reshape(x.shape[1:])


def all_reduce_fused_plain(x: torch.Tensor, n: int, op: str) -> torch.Tensor:
    """Plain version of K3."""
    return _ring_plain(x, n, op, ring_block_elems(x[0].numel(), n, "fused"))


def all_reduce_seg_plain(x: torch.Tensor, n: int, op: str,
                         seg_elems: int | None = None) -> torch.Tensor:
    """Plain version of K4: the same folds over the window-rounded blocks
    (where the accumulator lives changes no value)."""
    return _ring_plain(x, n, op,
                       ring_block_elems(x[0].numel(), n, "seg", seg_elems))


# -- kernels -------------------------------------------------------------

def _vec(x: torch.Tensor, *outs: torch.Tensor) -> int:
    """16-byte vector width when every row and pointer is 16-byte aligned,
    else 1 (element by element)."""
    row_bytes = x[0].numel() * x.element_size()
    if row_bytes % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *outs)):
        return 16 // x.element_size()
    return 1


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _kernel_fused(x: torch.Tensor, n: int, op: str, blk: int) -> torch.Tensor:
    from ompi_tpu_torch.ops import _build

    size = x[0].numel()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if size:
        lib = _build.load("ring_fused")
        with torch.cuda.device(x.device):
            _launch(lib.otpu_ring_fused, x.data_ptr(), out.data_ptr(), size,
                    blk, n, _DTCODE[x.dtype], _OPCODE[op], _vec(x, out),
                    torch.cuda.current_stream(x.device).cuda_stream)
        launches["all_reduce_fused"] += 1
    return out


def _kernel_seg(x: torch.Tensor, n: int, op: str, blk: int) -> torch.Tensor:
    from ompi_tpu_torch.ops import _build

    size = x[0].numel()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if size:
        acc = torch.empty(size, dtype=x.dtype, device=x.device)
        lib = _build.load("ring_seg")
        with torch.cuda.device(x.device):
            _launch(lib.otpu_ring_seg, x.data_ptr(), acc.data_ptr(),
                    out.data_ptr(), size, blk, n, _DTCODE[x.dtype],
                    _OPCODE[op], _vec(x, acc, out),
                    torch.cuda.current_stream(x.device).cuda_stream)
        launches["all_reduce_seg"] += 1
    return out


def all_reduce(x: torch.Tensor, n: int, op: str = "sum",
               variant: str = "fused",
               seg_elems: int | None = None) -> torch.Tensor:
    """``(n, *S)`` -> ``(*S)``: the ring all-reduce of the n rank rows."""
    on_card = _check(x, n, op, variant)
    payload_shape = tuple(x.shape[1:])
    if n == 1:
        return x.reshape(payload_shape).clone()
    size = int(np.prod(payload_shape)) if payload_shape else 1
    blk = ring_block_elems(size, n, variant, seg_elems)
    if not on_card:
        return _ring_plain(x, n, op, blk)
    if variant == "seg":
        return _kernel_seg(x, n, op, blk)
    return _kernel_fused(x, n, op, blk)
