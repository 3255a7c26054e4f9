"""Ring collective kernels for the card — port of ``ompi_tpu/ops/pallas_collectives.py``.

The JAX package runs its explicit ring schedules as Pallas kernels over a
1-D device mesh: every rank holds its ``(n, rows, 128)`` payload, ring
blocks travel rank to rank by remote DMA and each hop folds.  In the port the
n virtual ranks are the rows of one tensor on one card (``x[i]`` is rank
i's buffer), so the remote copies disappear and what stays is the
arithmetic of the schedule: the ring-block partition and the fold order.
Every reduction below is one CUDA kernel (``csrc/ring_fused.cu``) in one
pass over the payload with the accumulator in registers, each thread
streaming its ranks' slices through a ring of shared-memory slots
(``cp.async``); the variants differ in their C entry point, their ring
blocks, the wire rounding and the walk.

``all_reduce(x, n, op, variant, seg_elems)`` — ``(n, *S)`` to ``(*S)``:

* ``'fused'`` — kernel K3 (``csrc/ring_fused.cu``), replacing
  ``pc._build_all_reduce`` (``pallas_collectives.py:361``): the whole
  accumulator on chip (registers here, VMEM there).
* ``'seg'`` — kernel K4 (``csrc/ring_fused.cu``, ``otpu_ring_seg``),
  replacing ``pc._build_all_reduce_seg`` (``pallas_collectives.py:674``),
  whose accumulator lives in HBM with one pass over the payload per ring
  step; on the card it is K3's one-pass body.  ``seg_elems`` (the TPU
  kernel's VMEM window) rounds the ring blocks up to whole windows, as in
  the reference, which fixes the block partition and so the fold order.
* ``'wire16'`` — kernel K7 (``csrc/ring_fused.cu``, ``otpu_ring_wire16``),
  replacing ``pc._build_all_reduce_wire16`` (``:425``): K3's schedule on
  float32 with the bf16 wire of the reference — the partial is rounded to
  bfloat16 (nearest, ties to even) before every hop and folded in float32,
  ``p = fold(x[r][blk], f32(bf16(p)))``, and the finished block is rounded
  to bfloat16 once more (``pc:463-469``).  The reference's kernel writes
  that bf16 result and its wrapper upcasts it (``pc:1606``); the card writes
  the same values as float32 directly.

``reduce_scatter(x, n, op, variant, seg_elems)`` — ``(n, n, *S)`` to
``(n, *S)``, row b the reduction of block b over the ranks: the same
kernels with the partial of block b starting on rank b+1 (K5
``otpu_ring_rs_fused``, replacing ``pc._build_reduce_scatter``, ``:502``;
K6 ``otpu_ring_rs_seg``, replacing ``pc._build_reduce_scatter_seg``,
``:744``; K5's wire16 form ``otpu_ring_rs_wire16``, replacing
``pc._build_reduce_scatter(wire16=True)``, ``:554``: the bf16 wire of K7
and no final rounding, as the owner's float32 partial is the result,
``pc:511-515``).  ``wire16`` takes float32 only and raises ``ValueError``
otherwise, as the reference does (``pc:1527-1530``, ``:1601-1604``).

The duplex variants of ``all_reduce`` split every ring block into two halves
of ``h = hrows*128`` elements: the first (``dir 0``) walks the ring
clockwise, the second (``dir 1``) counter-clockwise, as the reference's two
mirrored rings do (``pc:987-1010``, ``:876-909``):

* ``'bidi'`` — kernel K8 (``csrc/ring_fused.cu``, ``otpu_ring_bidi``),
  replacing ``pc._build_all_reduce_bidi`` (``:961``): blocks of ``2*hrows*128``
  elements, ``hrows = ceil(rows/2)`` (``pc:1594-1599``), the accumulator in
  registers as K3's.
* ``'seg_bidi'`` — kernel K9 (``csrc/ring_fused.cu``, ``otpu_ring_seg_bidi``),
  replacing ``pc._build_all_reduce_seg_bidi`` (``:850``) and its
  ``_bidi_done_and_ag`` (``:804``): ``hrows`` first rounded up to whole
  windows (``pc:1586-1593``), so its blocks, and with them its values, can
  differ from ``bidi``'s for the same payload; K8's one-pass body.

``reduce_scatter`` has no duplex kernel: ``bidi`` is its ``fused`` and
``seg_bidi`` its ``seg`` (the values are the reference's, which builds the
one-way ring for both).

``all_gather(x, n, variant)`` — ``(n, *S)`` to a new ``(n, *S)``: ``'ring'``
is kernel K10 (``csrc/ring_copy.cu``), replacing ``pc._build_all_gather``
(``:177``); ``'bidi'`` is kernel K11 (``otpu_ring_all_gather_bidi``),
replacing ``pc._build_all_gather_bidi`` (``:226``), and for n <= 2 the
one-way ring, as in the reference (``pc:1438-1439``).  Both launch the byte
mover of ``csrc/pair_copy.cuh`` (K10 as one pair of the whole tensor, K11 as
n pairs), the body of the exchange tier below too.

The torus schedules (``pc:1833-2028``) ride sub-rings of an ``(n0, n1)``
grid of ranks, rank ``p = i0*n1 + i1``; ``n0``, ``n1`` are the reference's
``mesh.shape[axes[0]]``, ``mesh.shape[axes[1]]``, and a degenerate axis
(length 1) is the 1-D ring:

* ``all_reduce_torus(x, n0, n1, op)`` — ``(n0, n1, *S)`` to ``(*S)``: K5's
  schedule over the column rings (blocks of ``rows0*128``), then K3's over
  the row rings on the scattered blocks (``rows1*128``); the closing
  all-gather moves no bytes on one card.
* ``reduce_scatter_torus(x, n0, n1, op)`` — ``(N, N, *S)`` to ``(N, *S)``:
  K5 over the columns on super-blocks of ``n1`` blocks, then K5 over the
  rows.
* ``all_gather_torus(x, n0, n1)`` — ``(N, *S)``: a copy (K10).

On the card each phase is one launch of K3/K5 over all its sub-rings at
once (``otpu_ring_sub``): a rank pitch and a batch over the grid, no
transposed copies; the counts go to ``all_reduce_fused`` and
``reduce_scatter_fused``.

``bcast(x, n, root)`` — ``(n, *S)`` to ``(n, *S)`` with every row equal to
``x[root % n]``: kernel K12 (``csrc/ring_copy.cu``), replacing
``pc._build_bcast`` (``:1294``); any dtype, the kernel copies bytes.

The exchange tier moves bytes too, on any dtype, through the same mover:

* ``right_permute(x, n)`` — ``out[(i+1) % n] = x[i]``: kernel K13
  (``csrc/ring_copy.cu``), replacing ``pc._build_right_permute`` (``:141``).
* ``all_to_all(x, n)`` — ``(n, n, *S)``, ``out[j, i] = x[i, j]``: kernel K14
  (``csrc/exchange.cu``), replacing ``pc._build_all_to_all`` (``:1050``).
* ``all_to_all_v(x, counts, n)`` — ``(n, n, R, W)`` with an ``(n, n)`` counts
  table, ``out[j, i, :c] = x[i, j, :c]``: kernel K15 (``csrc/exchange.cu``),
  replacing ``pc._build_all_to_all_v`` (``:1105``).
* ``all_gather_v(x, counts, n)`` — ``(n, R, W)`` with ``(n,)`` counts,
  ``out[i, :c_i] = x[i, :c_i]``: kernel K16 (``csrc/exchange.cu``),
  replacing ``pc._build_all_gather_v`` (``:1204``).

Under CUDA graph capture: a launch of the mover on a capturing stream runs
its span tickets on a counter pair of its own, 16 zeroed bytes allocated in
the capture (``_launch_mover``), where an eager launch takes a slot of the
library's round-robin pool.  The ragged two need their counts table on the
card to be captured (a host table is staged through pinned memory).

The ragged two clamp their counts to ``[0, R]`` (on the card an unclamped
count would copy past the slot) and leave the rows past each count
unspecified, as the reference does: the output is not zeroed.  Their counts
are a runtime operand of the kernel, a small int32 device tensor made per
call, so a new routing rebuilds nothing.

Fold order: block b of a ring reduction is
``fold(x[b+s-1], ... fold(x[b+s+1], x[b+s]))`` — the partial starts on
rank b+s and every hop folds its own block into the incoming partial,
``fold(own, partial)``.  The start offset s is the counterpart of
``_rs_phase``'s ``align``: 0 for the all-reduce (``align=0``), 1 for the
owner-aligned reduce-scatter (``align=-1``).  A counter-clockwise half
starts on rank b+s too and walks left: ``fold(x[b+s+1], ...
fold(x[b+s-1], x[b+s]))``.  The all-reduce's blocks are
``rows*128`` elements (``_jit_all_reduce``, ``pallas_collectives.py:1577-
1620``), padded with ``_pad_value``; the reduce-scatter's are the payload
``prod(S)`` itself.  Kernels and plain versions keep that order, so the port
is bit-identical with the reference.  A CPU tensor goes to the plain
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
_VARIANTS = ("fused", "seg", "wire16", "bidi", "seg_bidi")
_BIDI = ("bidi", "seg_bidi")
#: the reduce-scatter's kernel for each duplex variant (it has none of its own)
_RS_ONE_WAY = {"bidi": "fused", "seg_bidi": "seg"}

#: ring-block start offset (``_rs_phase``'s align): all-reduce, reduce-scatter
_AR_START, _RS_START = 0, 1
#: ring walk of each part of a block: one way, or a clockwise and a
#: counter-clockwise half
_ONE_WAY, _DUPLEX = (1,), (1, -1)

#: kernel launches per wrapper (plain-version calls are not counted)
launches = {"all_reduce_fused": 0, "all_reduce_seg": 0,
            "all_reduce_wire16": 0,
            "all_reduce_bidi": 0, "all_reduce_seg_bidi": 0,
            "reduce_scatter_fused": 0, "reduce_scatter_seg": 0,
            "reduce_scatter_wire16": 0,
            "all_gather": 0, "all_gather_bidi": 0, "bcast": 0,
            "right_permute": 0,
            "all_to_all": 0, "all_to_all_v": 0, "all_gather_v": 0}


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
    """Elements per all-reduce ring block for a payload of ``size``; a duplex
    block is two halves of ``hrows`` rows (window-rounded for seg_bidi)."""
    rows = _rows_for(-(-size // n))
    if variant == "seg":
        _, rows = _seg_rows(rows, seg_elems)
    elif variant in _BIDI:
        hrows = -(-rows // 2)
        if variant == "seg_bidi":
            _, hrows = _seg_rows(hrows, seg_elems)
        rows = 2 * hrows
    return rows * 128


def _check_ranks(x, n: int, what: str) -> bool:
    """Checks every wrapper shares: a contiguous tensor with a leading rank
    axis of n on the card or the CPU; returns whether the kernel runs."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"ring {what} needs a leading rank axis of {n}, "
                         f"got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"ring {what} needs a contiguous tensor")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ring {what} runs on cuda or cpu, got {x.device}")
    return cudaenv.on_card(x)


def _check(x, n: int, op: str, variant: str,
           what: str = "all_reduce") -> bool:
    """Checks of the ring reductions (kernels and plain versions alike);
    a reduce-scatter also needs the ``(n, n, *S)`` layout."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown ring {what} variant {variant!r}")
    if op not in _FOLDS:
        raise ValueError(
            f"unsupported ring reduction {op!r}: one of sum/max/min/prod")
    on_card = _check_ranks(x, n, what)
    if what == "reduce_scatter" and (x.dim() < 2 or x.shape[1] != n):
        raise ValueError(f"ring reduce_scatter needs shape ({n}, {n}, ...), "
                         f"got {tuple(x.shape)}")
    if variant == "wire16" and x.dtype != torch.float32:
        raise ValueError("wire16 compresses float32 payloads to bf16 wire "
                         f"bytes; got dtype {x.dtype}")
    if x.dtype not in _DTCODE:
        raise TypeError(f"ring {what} takes float16/32/64, got {x.dtype}")
    return on_card


# -- plain versions ------------------------------------------------------

def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 -> float32, to nearest with ties to even, every NaN
    made the quiet NaN 0x7FC00000: the bits of the card's wire
    (``bf16_round`` in ``csrc/ring_common.cuh``).  Written on the bits, as
    torch's own conversion gives NaN other payloads on other paths."""
    u = t.view(torch.int32)
    r = (u + (0x7FFF + ((u >> 16) & 1))) & -65536
    return torch.where(torch.isnan(t), 0x7FC00000, r).view(torch.float32)


def _ring_fold(xb: torch.Tensor, op: str, start: int,
               walks: tuple = _ONE_WAY, wire: bool = False) -> torch.Tensor:
    """The ring schedule on ``xb`` = ``[rank, block, part, *rest]`` (n ranks,
    n blocks, one part per entry of ``walks``): the partial of part d of
    block b starts as rank b+start's and rank b+start+k*walks[d] folds its
    own in, ``fold(own, partial)``, for k = 1..n-1.  ``rest`` may hold a
    batch of sub-rings.  ``wire``: the partial crosses each hop as bfloat16
    (``bf16_round`` before each fold).  Returns ``[block, part, *rest]``."""
    n = xb.shape[0]
    fold = _FOLDS[op]
    b = torch.arange(n, device=xb.device)[:, None]
    d = torch.arange(len(walks), device=xb.device)[None, :]
    step = torch.tensor(walks, device=xb.device)[None, :]
    acc = xb[(b + start) % n, b, d]
    for k in range(1, n):
        if wire:
            acc = bf16_round(acc)
        acc = fold(xb[(b + start + k * step) % n, b, d], acc)
    return acc


def _ring_plain(x: torch.Tensor, n: int, op: str, blk: int,
                start: int = _AR_START, wire: bool = False,
                round_out: bool = False,
                walks: tuple = _ONE_WAY) -> torch.Tensor:
    """The ring schedule (``_ring_fold``) on whole blocks of ``blk``
    elements of each rank's row, padded with the op's neutral element; a
    duplex block (``walks=_DUPLEX``) is its two halves.  ``round_out``: the
    result is rounded to bfloat16 once more.  Returns the folded row in the
    shape ``x.shape[1:]``."""
    size = x[0].numel()
    xp = torch.full((n, n * blk), _pad_value(op, x.dtype), dtype=x.dtype,
                    device=x.device)
    xp[:, :size] = x.reshape(n, size)
    acc = _ring_fold(xp.view(n, n, len(walks), blk // len(walks)), op, start,
                     walks, wire)
    if round_out:
        acc = bf16_round(acc)
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


def all_reduce_bidi_plain(x: torch.Tensor, n: int, op: str) -> torch.Tensor:
    """Plain version of K8: duplex blocks, the clockwise half walking
    right and the counter-clockwise half left from the same start rank."""
    return _ring_plain(x, n, op, ring_block_elems(x[0].numel(), n, "bidi"),
                       walks=_DUPLEX)


def all_reduce_seg_bidi_plain(x: torch.Tensor, n: int, op: str,
                              seg_elems: int | None = None) -> torch.Tensor:
    """Plain version of K9: K8's folds over the window-rounded halves."""
    return _ring_plain(x, n, op, ring_block_elems(x[0].numel(), n, "seg_bidi",
                                                  seg_elems), walks=_DUPLEX)


def all_reduce_wire16_plain(x: torch.Tensor, n: int, op: str) -> torch.Tensor:
    """Plain version of K7: K3's blocks with the bf16 wire and the result
    rounded once."""
    return _ring_plain(x, n, op, ring_block_elems(x[0].numel(), n, "fused"),
                       wire=True, round_out=True)


def reduce_scatter_wire16_plain(x: torch.Tensor, n: int,
                                op: str) -> torch.Tensor:
    """Plain version of K5's wire16 form: the bf16 wire, no final
    rounding."""
    return _ring_plain(x, n, op, x[0, 0].numel(), _RS_START, wire=True)


def reduce_scatter_plain(x: torch.Tensor, n: int, op: str) -> torch.Tensor:
    """Plain version of K5 and K6 alike, ``(n, n, *S)`` to ``(n, *S)``.

    One version serves both regimes: the reference pads each block to
    whole 128-lane rows (and the seg variant to whole windows) but slices
    the padding off each block before it reaches the output, so the
    partition never mixes blocks, and the only thing that fixes a value is
    the rank its fold starts on (b+1).  ``seg_elems`` changes nothing."""
    return _ring_plain(x, n, op, x[0, 0].numel(), _RS_START)


def all_gather_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K10 and K11: every rank ends with every rank's row,
    whichever way round the ring it came."""
    return x.clone()


def bcast_plain(x: torch.Tensor, n: int, root: int) -> torch.Tensor:
    """Plain version of K12: every row becomes root's row."""
    return x[root % n].expand(x.shape).clone()


# -- kernels -------------------------------------------------------------

def _vec(x: torch.Tensor, blk: int, *outs: torch.Tensor) -> int:
    """16-byte vector width when every row, every ring block of ``blk``
    elements and every pointer is 16-byte aligned, else 1 (element by
    element): a pack that straddled two ring blocks would fold part of its
    lanes in the other block's order."""
    width = 16 // x.element_size()
    row_bytes = x[0].numel() * x.element_size()
    if (row_bytes % 16 == 0 and blk % width == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *outs))):
        return width
    return 1


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


#: what a mover entry returns, having launched nothing, for a launch on a
#: capturing stream that brought no counter pair
#: (``cudaErrorStreamCaptureUnsupported``)
_NEEDS_COUNTER = 900


def _launch_mover(fn, x: torch.Tensor, *args) -> None:
    """Launch the byte-mover entry ``fn(*args, counter, stream)`` on
    ``x``'s device.  An eager launch passes no counter pair: the kernel takes
    a slot of the library's round-robin pool.  A launch that a CUDA graph
    captures keeps its arguments for every replay, so the entry refuses it
    without a pair of its own; the wrapper then passes 16 zeroed bytes
    allocated in the capture, from the graph's private pool, whose zero
    fill is captured too and runs before the launch in every replay."""
    stream = _stream(x)
    err = fn(*args, None, stream)
    if err == _NEEDS_COUNTER:
        counter = torch.zeros(2, dtype=torch.int64, device=x.device)
        err = fn(*args, counter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


#: C entry point per (variant, start offset)
_ENTRIES = {("fused", _AR_START): "otpu_ring_fused",
            ("seg", _AR_START): "otpu_ring_seg",
            ("wire16", _AR_START): "otpu_ring_wire16",
            ("bidi", _AR_START): "otpu_ring_bidi",
            ("seg_bidi", _AR_START): "otpu_ring_seg_bidi",
            ("fused", _RS_START): "otpu_ring_rs_fused",
            ("seg", _RS_START): "otpu_ring_rs_seg",
            ("wire16", _RS_START): "otpu_ring_rs_wire16"}


def _kernel_ring(x: torch.Tensor, n: int, op: str, blk: int, variant: str,
                 start: int) -> torch.Tensor:
    """Launch K3/K5 (fused), K4/K6 (seg), K7/K5w (wire16), K8 (bidi) or K9
    (seg_bidi) on ``x`` viewed as ``(n, size)``; the output is
    ``x.shape[1:]``."""
    from ompi_tpu_torch.ops import _build

    size = x[0].numel()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if not size:
        return out
    coll = "all_reduce" if start == _AR_START else "reduce_scatter"
    entry = _ENTRIES[variant, start]
    # a 16-byte pack must not straddle a duplex half either
    pack_blk = blk // 2 if variant in _BIDI else blk
    with torch.cuda.device(x.device):
        _launch(getattr(_build.load("ring_fused"), entry), x.data_ptr(),
                out.data_ptr(), size, blk, n, _DTCODE[x.dtype], _OPCODE[op],
                _vec(x, pack_blk, out), _stream(x))
    launches[f"{coll}_{variant}"] += 1
    return out


def all_reduce(x: torch.Tensor, n: int, op: str = "sum",
               variant: str = "fused",
               seg_elems: int | None = None) -> torch.Tensor:
    """``(n, *S)`` -> ``(*S)``: the ring all-reduce of the n rank rows
    (for n == 1 a copy of the one row, unrounded under wire16 as in the
    reference)."""
    on_card = _check(x, n, op, variant)
    payload_shape = tuple(x.shape[1:])
    if n == 1:
        return x.reshape(payload_shape).clone()
    size = int(np.prod(payload_shape)) if payload_shape else 1
    blk = ring_block_elems(size, n, variant, seg_elems)
    if not on_card:
        wire = variant == "wire16"
        return _ring_plain(x, n, op, blk, wire=wire, round_out=wire,
                           walks=_DUPLEX if variant in _BIDI else _ONE_WAY)
    return _kernel_ring(x, n, op, blk, variant, _AR_START)


def reduce_scatter(x: torch.Tensor, n: int, op: str = "sum",
                   variant: str = "fused",
                   seg_elems: int | None = None) -> torch.Tensor:
    """``(n, n, *S)`` -> ``(n, *S)``: row b is block b reduced over the
    ranks, its fold starting on rank b+1.  ``variant`` picks the
    accumulator regime (K5 fused, K6 seg; ``bidi`` and ``seg_bidi`` are
    those two, as no duplex reduce-scatter exists) or the bf16 wire (K5w,
    float32); ``seg_elems``, the reference's VMEM window, is accepted for
    the same call shape but fixes no value (see ``reduce_scatter_plain``)."""
    on_card = _check(x, n, op, variant, "reduce_scatter")
    variant = _RS_ONE_WAY.get(variant, variant)
    if n == 1:
        return x.reshape(x.shape[1:]).clone()
    if not on_card:
        if variant == "wire16":
            return reduce_scatter_wire16_plain(x, n, op)
        return reduce_scatter_plain(x, n, op)
    return _kernel_ring(x, n, op, x[0, 0].numel(), variant, _RS_START)


def all_gather(x: torch.Tensor, n: int, variant: str = "ring") -> torch.Tensor:
    """``(n, *S)`` -> ``(n, *S)`` replicated: a new tensor equal to ``x``
    (``x`` itself for n == 1, as the reference returns it).  ``'bidi'`` is
    K11, or K10 for n <= 2, where no two chains pair up."""
    if variant not in ("ring", "bidi"):
        raise ValueError(f"unknown ring all_gather variant {variant!r}")
    on_card = _check_ranks(x, n, "all_gather")
    if n == 1:
        return x
    if not on_card:
        return all_gather_plain(x, n)
    if variant == "bidi" and n > 2:
        row_bytes = x[0].numel() * x.element_size()
        return _copy("ring_copy", "otpu_ring_all_gather_bidi",
                     "all_gather_bidi", x, row_bytes, row_bytes, n)
    from ompi_tpu_torch.ops import _build

    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes:
        vec = 16 if x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
        with torch.cuda.device(x.device):
            _launch_mover(_build.load("ring_copy").otpu_ring_all_gather, x,
                          x.data_ptr(), out.data_ptr(), nbytes, vec)
        launches["all_gather"] += 1
    return out


def _byte_vec(unit_bytes: int, *tensors: torch.Tensor) -> int:
    """16 (bytes a thread) when ``unit_bytes`` -- the row, block or slot at
    each multiple of which a copy starts -- and every pointer are 16-byte
    aligned, else 1."""
    if unit_bytes % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 16
    return 1


def _copy(lib: str, entry: str, key: str, x: torch.Tensor, unit_bytes: int,
          *args) -> torch.Tensor:
    """A new tensor like ``x`` written by the byte mover's entry ``entry``
    of library ``lib``, called as ``entry(x, out, *args, vec, counter,
    stream)`` through ``_launch_mover`` with the vector width that
    ``unit_bytes`` allows; an empty unit launches nothing."""
    from ompi_tpu_torch.ops import _build

    out = torch.empty_like(x)
    if unit_bytes:
        with torch.cuda.device(x.device):
            _launch_mover(getattr(_build.load(lib), entry), x, x.data_ptr(),
                          out.data_ptr(), *args, _byte_vec(unit_bytes, x, out))
        launches[key] += 1
    return out


def bcast(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """``(n, *S)`` -> ``(n, *S)``, every row a copy of ``x[root % n]``'s
    bytes (``x`` itself for n == 1, as the reference returns it)."""
    on_card = _check_ranks(x, n, "bcast")
    if n == 1:
        return x
    root = int(root) % n
    if not on_card:
        return bcast_plain(x, n, root)
    from ompi_tpu_torch.ops import _build

    row_bytes = x[0].numel() * x.element_size()
    out = torch.empty_like(x)
    if row_bytes:
        with torch.cuda.device(x.device):
            _launch(_build.load("ring_copy").otpu_ring_bcast, x.data_ptr(),
                    out.data_ptr(), row_bytes, n, root,
                    _byte_vec(row_bytes, x, out), _stream(x))
        launches["bcast"] += 1
    return out


# -- the torus schedules (sub-rings of an (n0, n1) grid) ----------------------

def _torus_blocks(size: int, n0: int, n1: int) -> tuple[int, int]:
    """(blk0, blk1): the all-reduce torus's column-ring blocks, ``rows0*128``
    elements, and its row-ring blocks over one of them, ``rows1*128``
    (``pc:1841-1844``)."""
    blk0 = _rows_for(-(-size // n0)) * 128
    return blk0, _rows_for(-(-blk0 // n1)) * 128


def all_reduce_torus_plain(x: torch.Tensor, n0: int, n1: int,
                           op: str) -> torch.Tensor:
    """Plain version of ``all_reduce_torus`` on ``(n0, n1, *S)``, n0, n1 >= 2:
    the padded column-ring reduce-scatter (start i0+1), then the padded
    row-ring all-reduce of each scattered block (start at its block)."""
    size = x[0, 0].numel()
    blk0, blk1 = _torus_blocks(size, n0, n1)
    pad = _pad_value(op, x.dtype)
    xp = torch.full((n0, n1, n0 * blk0), pad, dtype=x.dtype, device=x.device)
    xp[..., :size] = x.reshape(n0, n1, size)
    # column rings: [rank i0, block, part, batch i1, element]
    part = _ring_fold(xp.view(n0, n1, n0, 1, blk0).permute(0, 2, 3, 1, 4), op,
                      _RS_START)[:, 0]                 # [i0, i1, blk0]
    pp = torch.full((n1, n0, n1 * blk1), pad, dtype=x.dtype, device=x.device)
    pp[..., :blk0] = part.transpose(0, 1)
    # row rings: [rank i1, block, part, batch i0, element]
    red = _ring_fold(pp.view(n1, n0, n1, 1, blk1).permute(0, 2, 3, 1, 4), op,
                     _AR_START)[:, 0]                  # [block, i0, blk1]
    red = red.transpose(0, 1).reshape(n0, n1 * blk1)[:, :blk0]
    return red.reshape(-1)[:size].reshape(x.shape[2:])


def reduce_scatter_torus_plain(x: torch.Tensor, n0: int, n1: int,
                               op: str) -> torch.Tensor:
    """Plain version of ``reduce_scatter_torus`` on ``(N, N, *S)``, n0, n1 >=
    2: the column rings reduce-scatter super-blocks of n1 blocks (start
    i0+1), then the row rings the blocks of each (start i1+1); rank p = i0*n1
    + i1 ends with block p.  No padding: the folds are elementwise."""
    size = x[0, 0].numel()
    xv = x.reshape(n0, n1, n0, n1, size)      # [i0', i1', I0, I1, element]
    # column rings: [rank i0', block I0, part, batch i1', I1, element]
    p1 = _ring_fold(xv.permute(0, 2, 1, 3, 4).unsqueeze(2), op,
                    _RS_START)[:, 0]           # [i0, i1', I1, element]
    # row rings: [rank i1', block I1, part, batch i0, element]
    p2 = _ring_fold(p1.permute(1, 2, 0, 3).unsqueeze(2), op,
                    _RS_START)[:, 0]           # [i1, i0, element]
    return p2.transpose(0, 1).reshape(x.shape[1:])


def _sub_vec(x: torch.Tensor, out: torch.Tensor, *units: int) -> int:
    """16-byte vector width of a sub-ring launch when every unit (total,
    block, period, rank pitch, in elements) holds whole packs and both
    pointers are 16-byte aligned, else 1."""
    width = 16 // x.element_size()
    if (all(u % width == 0 for u in units) and x.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0):
        return width
    return 1


def _sub_ring(x: torch.Tensor, out: torch.Tensor, op: str, n: int,
              start: int, blk: int, period: int, rpitch: int) -> None:
    """One launch of K3/K5 over a batch of sub-rings (``otpu_ring_sub``):
    element t of ``out`` folds ``x[r*rpitch + t]`` over the n ranks of its
    ring, in the order of block ``(t % period) // blk`` from ``start``."""
    from ompi_tpu_torch.ops import _build

    total = out.numel()
    if not total:
        return
    with torch.cuda.device(x.device):
        _launch(_build.load("ring_fused").otpu_ring_sub, x.data_ptr(),
                out.data_ptr(), total, blk, period, rpitch, n, start,
                _DTCODE[x.dtype], _OPCODE[op],
                _sub_vec(x, out, total, blk, period, rpitch), _stream(x))
    launches["all_reduce_fused" if start == _AR_START
             else "reduce_scatter_fused"] += 1


def _check_torus(x, n0: int, n1: int, op: str, lead: tuple,
                 what: str) -> bool:
    """The torus reductions' checks: axis lengths, the op, leading dims
    ``lead``, then those of every ring wrapper; returns whether the kernels
    run."""
    if n0 < 1 or n1 < 1:
        raise ValueError(f"{what} needs axis lengths >= 1, got ({n0}, {n1})")
    if op not in _FOLDS:
        raise ValueError(
            f"unsupported ring reduction {op!r}: one of sum/max/min/prod")
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"{what} needs a tensor of shape {lead} + S, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTCODE:
        raise TypeError(f"{what} takes float16/32/64, got {x.dtype}")
    return _check_ranks(x, lead[0], what)


def all_reduce_torus(x: torch.Tensor, n0: int, n1: int,
                     op: str = "sum") -> torch.Tensor:
    """``(n0, n1, *S)`` -> ``(*S)``: the torus all-reduce (``pc:1880``).  A
    degenerate axis is the fused 1-D ring over the n0*n1 ranks."""
    on_card = _check_torus(x, n0, n1, op, (n0, n1), "all_reduce_torus")
    payload = tuple(x.shape[2:])
    if n0 == 1 or n1 == 1:
        return all_reduce(x.reshape((n0 * n1,) + payload), n0 * n1, op)
    if not on_card:
        return all_reduce_torus_plain(x, n0, n1, op)
    size = x[0, 0].numel()
    blk0, blk1 = _torus_blocks(size, n0, n1)
    part = torch.empty((n1, size), dtype=x.dtype, device=x.device)
    # column rings: rank (i0, i1) at (i0*n1 + i1)*size, ring of i1 at pitch
    # n1*size; part[i1] holds each column's scattered blocks
    _sub_ring(x, part, op, n0, _RS_START, blk0, size, n1 * size)
    out = torch.empty(payload, dtype=x.dtype, device=x.device)
    # row rings: rank i1 of row i0 holds part[i1, i0*blk0 : (i0+1)*blk0]
    _sub_ring(part, out, op, n1, _AR_START, blk1, blk0, size)
    return out


def reduce_scatter_torus(x: torch.Tensor, n0: int, n1: int,
                         op: str = "sum") -> torch.Tensor:
    """``(N, N, *S)`` -> ``(N, *S)``, N = n0*n1: the torus reduce-scatter
    (``pc:1961``), rank p's row the reduction of block p.  A degenerate axis
    is the fused 1-D ring."""
    n = n0 * n1
    on_card = _check_torus(x, n0, n1, op, (n, n), "reduce_scatter_torus")
    if n0 == 1 or n1 == 1:
        return reduce_scatter(x, n, op)
    if not on_card:
        return reduce_scatter_torus_plain(x, n0, n1, op)
    size = x[0, 0].numel()
    part = torch.empty((n1, n * size), dtype=x.dtype, device=x.device)
    # column rings over super-blocks of n1 blocks: rank (i0, i1) at
    # (i0*n1 + i1)*n*size, ring of i1 at pitch n1*n*size
    _sub_ring(x, part, op, n0, _RS_START, n1 * size, n * size, n1 * n * size)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    # row rings: rank i1 of row i0 holds super-block i0 of part[i1]
    _sub_ring(part, out, op, n1, _RS_START, size, n1 * size, n * size)
    return out


def all_gather_torus(x: torch.Tensor, n0: int, n1: int) -> torch.Tensor:
    """``(N, *S)`` -> ``(N, *S)`` replicated (``pc:2016``): the row rings'
    blocks already lie in their rows, so only the column gather copies
    (K10 on the card)."""
    return all_gather(x, n0 * n1)


# -- the exchange tier (K13-K16) --------------------------------------------

def right_permute_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K13: row i moves to row i+1 (mod n)."""
    return torch.roll(x, 1, 0)


def all_to_all_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K14: ``out[j, i] = x[i, j]``."""
    return x.transpose(0, 1).contiguous()


def _ragged_counts(counts, shape: tuple, rows: int, what: str) -> torch.Tensor:
    """``counts`` as an int32 tensor clamped to ``[0, rows]`` -- the
    reference's clip, without which a count past R would copy past its slot
    on the card -- on the device it came on (the CPU unless it is a
    tensor).  A table of another shape raises ``ValueError``."""
    if isinstance(counts, torch.Tensor):
        table = counts.detach()
    else:
        table = torch.as_tensor(np.asarray(counts, dtype=np.int64))
    table = table.clamp(0, rows).to(torch.int32)
    if tuple(table.shape) != shape:
        raise ValueError(f"ring {what} needs {shape} counts, got "
                         f"{tuple(table.shape)}")
    return table


def all_to_all_v_plain(x: torch.Tensor, counts, n: int) -> torch.Tensor:
    """Plain version of K15: the n*n pairs one by one, ``c`` rows each
    (counts clamped); rows past a count are left as ``torch.empty`` gives
    them."""
    c = _ragged_counts(counts, (n, n), x.shape[2], "all_to_all_v").tolist()
    out = torch.empty_like(x)
    for i in range(n):
        for j in range(n):
            out[j, i, :c[i][j]] = x[i, j, :c[i][j]]
    return out


def all_gather_v_plain(x: torch.Tensor, counts, n: int) -> torch.Tensor:
    """Plain version of K16: the n blocks one by one, ``c_i`` rows each."""
    c = _ragged_counts(counts, (n,), x.shape[1], "all_gather_v").tolist()
    out = torch.empty_like(x)
    for i in range(n):
        out[i, :c[i]] = x[i, :c[i]]
    return out


def _check_ragged(x, n: int, ndim: int, what: str, layout: str) -> bool:
    """The ragged wrappers' shape checks: ``ndim`` dims (the second of
    a2av also n) and a row width W that is a whole number of 128 lanes."""
    on_card = _check_ranks(x, n, what)
    if x.dim() != ndim or (ndim == 4 and x.shape[1] != n):
        raise ValueError(f"ring {what} needs a {layout} tensor, got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] % 128:
        raise ValueError(f"ring {what} row width must be a multiple of 128 "
                         f"lanes, got {x.shape[-1]} (pad the feature dim)")
    return on_card


def _ragged(entry: str, key: str, x: torch.Tensor,
            table: torch.Tensor) -> torch.Tensor:
    """Launch K15 or K16 on ``x`` with the clamped ``table``, which reaches
    the card as an int32 tensor without a host synchronisation (from pinned
    memory, unless it lies on the card already)."""
    if table.device != x.device:
        table = table.pin_memory().to(x.device, non_blocking=True)
    table = table.contiguous()
    row_bytes = x.shape[-1] * x.element_size()
    slot_bytes = x.shape[-2] * row_bytes
    return _copy("exchange", entry, key, x, slot_bytes, table.data_ptr(),
                 slot_bytes, row_bytes, x.shape[0])


def right_permute(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(n, *S)`` -> ``(n, *S)`` with ``out[(i+1) % n] = x[i]``, any dtype
    (``x`` itself for n == 1, as the reference returns it)."""
    on_card = _check_ranks(x, n, "right_permute")
    if n == 1:
        return x
    if not on_card:
        return right_permute_plain(x, n)
    row_bytes = x[0].numel() * x.element_size()
    return _copy("ring_copy", "otpu_ring_right_permute", "right_permute", x,
                 row_bytes, row_bytes, n)


def all_to_all(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(n, n, *S)`` -> ``(n, n, *S)`` with ``out[j, i] = x[i, j]``, any
    dtype (``x`` itself for n == 1); another layout raises ``ValueError``."""
    on_card = _check_ranks(x, n, "all_to_all")
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(f"ring all_to_all needs a ({n}, {n}, *S) tensor, "
                         f"got {tuple(x.shape)}")
    if n == 1:
        return x
    if not on_card:
        return all_to_all_plain(x, n)
    blk_bytes = x[0, 0].numel() * x.element_size()
    return _copy("exchange", "otpu_all_to_all", "all_to_all", x, blk_bytes,
                 blk_bytes, n)


def all_to_all_v(x: torch.Tensor, counts, n: int,
                 chunk_rows: int = 8) -> torch.Tensor:
    """``(n, n, R, W)`` -> ``(n, n, R, W)`` with ``out[j, i, :c] =
    x[i, j, :c]``, ``c = clamp(counts[i, j], 0, R)``; rows past ``c`` are
    unspecified.  Any dtype; W must be a multiple of 128 and ``counts`` an
    ``(n, n)`` table (a list, array or tensor), else ``ValueError``.  ``x``
    itself for n == 1, R == 0 or W == 0.

    ``chunk_rows`` is accepted for the reference's call shape but fixes no
    value: the reference pads R to whole chunks of (chunk_rows, W) DMAs and
    slices the padding off again, and the card copies each pair's rows
    exactly."""
    on_card = _check_ragged(x, n, 4, "all_to_all_v", f"({n}, {n}, R, W)")
    if n == 1:
        return x
    table = _ragged_counts(counts, (n, n), x.shape[2], "all_to_all_v")
    if x.shape[2] == 0 or x.shape[3] == 0:
        return x
    if not on_card:
        return all_to_all_v_plain(x, table, n)
    return _ragged("otpu_all_to_all_v", "all_to_all_v", x, table)


def all_gather_v(x: torch.Tensor, counts, n: int,
                 chunk_rows: int = 8) -> torch.Tensor:
    """``(n, R, W)`` -> ``(n, R, W)`` replicated with ``out[i, :c_i] =
    x[i, :c_i]``, ``c_i = clamp(counts[i], 0, R)``; rows past ``c_i`` are
    unspecified.  Any dtype; W must be a multiple of 128 and ``counts`` of
    length n, else ``ValueError``.  ``x`` itself for n == 1, R == 0 or
    W == 0.  ``chunk_rows`` is accepted but fixes no value (see
    ``all_to_all_v``)."""
    on_card = _check_ragged(x, n, 3, "all_gather_v", f"({n}, R, W)")
    if n == 1:
        return x
    table = _ragged_counts(counts, (n,), x.shape[1], "all_gather_v")
    if x.shape[1] == 0 or x.shape[2] == 0:
        return x
    if not on_card:
        return all_gather_v_plain(x, table, n)
    return _ragged("otpu_all_gather_v", "all_gather_v", x, table)
