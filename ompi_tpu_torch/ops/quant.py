"""Block-quantization kernels for the card (Triton) — port of ``ompi_tpu/ops/pallas_quant.py``.

The device half of coll/quant's int8 codec: one *block* is 128 contiguous
elements of one rank's payload, and each block carries an f32 scale
``max(|x|)/127`` beside its int8 values.  The world's n ranks are the rows
of one tensor, and each rank's row is padded with zeros to whole blocks on
its own, so a block never straddles two ranks (in the reference every
shard encodes its own flat payload, ``coll/xla.py:264-269``).

``encode_int8(x)`` — K17, replaces ``pallas_quant.encode_int8``
    (``ompi_tpu/ops/pallas_quant.py:77``): ``(n, *S)`` float32 to
    ``q (n, rows, 128)`` int8 and ``s (n, rows)`` float32, rows =
    ceil(prod(S)/128).  The reference's scale is lane-padded to ``(rows,
    128)`` inside its kernel, a Mosaic tiling rule (``:71-73``) that would
    write 128 times the scale bytes here: the port writes one f32 a block.
``dequant_accumulate(q, s)`` — K18, replaces
    ``pallas_quant.dequant_accumulate`` (``:106``): ``(k, rows, 128)`` int8
    and ``(k, rows)`` scales to the ``(rows, 128)`` float32 sum of ``q[i] ·
    s[i]`` over i in rank order, with no dequantized intermediate in device
    memory; ``k == 1`` is ``decode_int8``, as in the reference (``:112``).
``decode_int8(q, s)`` — K19, replaces ``pallas_quant.decode_int8``
    (``:139``): ``q · s`` to float32, ``(..., rows, 128)`` with ``(...,
    rows)`` scales.

Arithmetic, bit for bit with the reference's CPU run (interpret mode):

* encode: ``amax`` = max |x| over the block, NaN if the block holds one;
  ``inv = 127/amax`` correctly rounded (0 where amax is not > 0, so also
  for a NaN block); ``q = rint(x · inv)``, ties to even, then XLA's
  float-to-int8 convert: NaN to 0, saturating to [-128, 127].  A block
  holding NaN or ±inf gives q = 0 and a NaN or inf scale.  ``s = amax ·
  f32(1/127)``, a multiply.
* dequant-accumulate: the order XLA's CPU backend gives the reference's
  kernel body ``acc + q[i]·s[i]`` (``:98-102``) by contracting it into
  fused multiply-adds: ``acc = fma(q0, s0, q1·s1)`` with the product q1·s1
  rounded, then ``acc = fma(q_i, s_i, acc)`` for i >= 2.  The kernel writes
  it with ``tl.fma`` and nothing else that could contract; the plain
  version computes each step in float64 (int8 × f32 is exact there) and
  rounds to f32 once per step.  Its one residual risk is a double rounding
  in that emulation (the float64 sum rounded, then rounded again to f32),
  which the seeded tests did not meet.

Where they differ, and why: XLA's CPU run flushes subnormals to zero, the
card does not, so a block whose scale is subnormal (amax < 127·2^-126)
keeps its scale here and gets 0 there (ROADMAP C).

Bound on an H100: device-memory bytes; each kernel is one pass with a
handful of operations per element (~1 op/byte, far below the ridge).  K17
reads 4 bytes and writes 1 + 4/128 per element, K18 reads k·(1 + 4/128)
and writes 4, K19 reads 1 + 4/128 and writes 4.  Design: one Triton
program owns a tile of ROWS blocks (ROWS × 128 elements) of one rank,
reduces each 128-lane row in registers (K17) or loads the k ranks' rows of
the tile together and folds them in registers (K18), and stores once; no
cross-program communication.  Correctly rounded division and round-to-even
are PTX instructions (``div.rn.f32``, ``cvt.rni.f32.f32``) through inline
assembly: Triton's own fp32 ``/`` is an approximate division.

A CPU tensor goes to the plain version of each kernel (``*_plain``), a CUDA
tensor to the kernel; ``launches`` counts kernel launches.  Triton is
imported, and the kernels built, at the first launch, so this module
imports without Triton.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.base import cudaenv

LANES = 128          # one codec block = 128 elements
ROWS = 32            # blocks per Triton program (32 × 128 elements)
#: f32(1/127), the scale factor (``amax * (1.0 / 127.0)`` in the reference)
INV127 = 0.007874015718698502

#: kernel launches per wrapper (plain-version calls are not counted)
launches = {"encode_int8": 0, "dequant_accumulate": 0, "decode_int8": 0}


def _rows_for(size: int) -> int:
    """Blocks covering ``size`` elements (>= 1, as the reference pads an
    empty payload to one row)."""
    return max(1, -(-size // LANES))


def _check(t, dtype, what: str, name: str = "x") -> bool:
    """A contiguous tensor of ``dtype`` on the card or the CPU; returns
    whether the kernel runs."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} expected a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what} takes {name} of {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} needs a contiguous {name}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, got {t.device}")
    return cudaenv.on_card(t)


def _check_scales(q, s, what: str) -> bool:
    """``q (..., rows, 128)`` int8 with ``s (..., rows)`` float32 on one
    device; returns whether the kernel runs."""
    on_card = _check(q, torch.int8, what, "q")
    _check(s, torch.float32, what, "s")
    if (q.dim() < 2 or q.shape[-1] != LANES
            or tuple(s.shape) != tuple(q.shape[:-1])):
        raise ValueError(f"{what} needs q (..., rows, {LANES}) and s (..., "
                         f"rows), got {tuple(q.shape)} and {tuple(s.shape)}")
    if s.device != q.device:
        raise ValueError(f"{what}: q on {q.device}, s on {s.device}")
    return on_card


# -- plain versions ------------------------------------------------------

def encode_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K17: ``(n, *S)`` float32 to ``(q, s)``."""
    n, size = x.shape[0], x[0].numel()
    rows = _rows_for(size)
    xp = torch.zeros((n, rows * LANES), dtype=torch.float32, device=x.device)
    xp[:, :size] = x.reshape(n, size)
    xb = xp.view(n, rows, LANES)
    amax = xb.abs().amax(dim=2)                         # NaN propagates
    # a tensor numerator: ``127.0 / t`` is reciprocal-then-multiply in torch
    inv = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                      torch.zeros_like(amax))
    y = torch.round(xb * inv[..., None])                # ties to even
    q = y.nan_to_num(0.0).clamp(-128.0, 127.0).to(torch.int8)
    return q, amax * INV127


def decode_int8_plain(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of K19: ``q · s`` in float32."""
    return q.to(torch.float32) * s[..., None]


def dequant_accumulate_plain(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of K18: ``fma(q0, s0, q1·s1)``, then ``fma(q_i, s_i,
    acc)``, each fma as a float64 sum rounded once to float32."""
    k = q.shape[0]
    if k == 1:
        return decode_int8_plain(q[0], s[0])

    def product(i):          # exact in float64
        return q[i].to(torch.float64) * s[i].to(torch.float64)[..., None]

    acc = (product(0) + product(1).to(torch.float32).to(torch.float64)
           ).to(torch.float32)
    for i in range(2, k):
        acc = (product(i) + acc.to(torch.float64)).to(torch.float32)
    return acc


# -- wrappers ------------------------------------------------------------

def encode_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(n, *S)`` float32 -> ``(q (n, rows, 128) int8, s (n, rows)
    float32)``, each rank's row padded with zeros to whole blocks."""
    on_card = _check(x, torch.float32, "encode_int8")
    if x.dim() < 1:
        raise ValueError("encode_int8 needs a leading rank axis")
    if not on_card:
        return encode_int8_plain(x)
    n, size = x.shape[0], x[0].numel()
    rows = _rows_for(size)
    q = torch.empty((n, rows, LANES), dtype=torch.int8, device=x.device)
    s = torch.empty((n, rows), dtype=torch.float32, device=x.device)
    if n:
        k_enc, _, _ = _kernels()
        with torch.cuda.device(x.device):
            k_enc[(-(-rows // ROWS), n)](x, q, s, size, rows, INV127,
                                         ROWS=ROWS, num_warps=4)
        launches["encode_int8"] += 1
    return q, s


def decode_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``q (..., rows, 128)`` int8, ``s (..., rows)`` float32 -> ``q · s``
    float32 of q's shape."""
    if not _check_scales(q, s, "decode_int8"):
        return decode_int8_plain(q, s)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    blocks = s.numel()
    if blocks:
        _, _, k_dec = _kernels()
        with torch.cuda.device(q.device):
            k_dec[(-(-blocks // ROWS),)](q, s, out, blocks, ROWS=ROWS,
                                         num_warps=4)
        launches["decode_int8"] += 1
    return out


def dequant_accumulate(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``q (k, rows, 128)`` int8, ``s (k, rows)`` float32 -> the ``(rows,
    128)`` float32 sum of ``q[i] · s[i]`` in rank order (see the module
    note for the fma order); ``k == 1`` is ``decode_int8``."""
    on_card = _check_scales(q, s, "dequant_accumulate")
    if q.dim() != 3 or q.shape[0] < 1:
        raise ValueError(f"dequant_accumulate needs q (k, rows, {LANES}) "
                         f"with k >= 1, got {tuple(q.shape)}")
    k, rows = q.shape[0], q.shape[1]
    if k == 1:
        return decode_int8(q[0], s[0])
    if not on_card:
        return dequant_accumulate_plain(q, s)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=q.device)
    if rows:
        _, k_acc, _ = _kernels()
        with torch.cuda.device(q.device):
            k_acc[(-(-rows // ROWS),)](q, s, out, rows, K=k, ROWS=ROWS,
                                       num_warps=4)
        launches["dequant_accumulate"] += 1
    return out


# -- Triton kernels ------------------------------------------------------
# Written at module level so Triton can read their source; ``tl`` and the
# helpers are bound when ``_kernels`` first runs (on the card only).

tl = None
_max_nan = _div_rn = _rint = _rank_block = None
_KERNELS = None


def _max_nan_src(a, b):
    # a NaN operand wins (``jnp.max`` propagates NaN; ``tl.max`` drops it)
    return tl.where((a != a) | (a > b), a, b)


def _div_rn_src(a, b):
    return tl.inline_asm_elementwise("div.rn.f32 $0, $1, $2;", "=f,f,f",
                                     [a, b], dtype=tl.float32, is_pure=True,
                                     pack=1)


def _rint_src(a):
    # round to the nearest integer, ties to even (``jnp.round``)
    return tl.inline_asm_elementwise("cvt.rni.f32.f32 $0, $1;", "=f,f", [a],
                                     dtype=tl.float32, is_pure=True, pack=1)


def _encode_src(x_ptr, q_ptr, s_ptr, size, rows, inv127,
                ROWS: tl.constexpr):
    rank = tl.program_id(1)
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    lane = tl.arange(0, 128)[None, :]
    e = r.to(tl.int64)[:, None] * 128 + lane             # within the rank
    x = tl.load(x_ptr + rank.to(tl.int64) * size + e, mask=e < size,
                other=0.0)
    amax = tl.reduce(tl.abs(x), 1, _max_nan)
    inv = tl.where(amax > 0, _div_rn(tl.full(amax.shape, 127.0, tl.float32),
                                     amax), 0.0)
    y = _rint(x * inv[:, None])
    # XLA's float -> int8 convert: NaN to 0, saturating
    y = tl.where(y != y, 0.0, tl.minimum(tl.maximum(y, -128.0), 127.0))
    row = rank * rows + r                                # block of (n, rows)
    live = r < rows
    tl.store(q_ptr + row.to(tl.int64)[:, None] * 128 + lane, y.to(tl.int8),
             mask=live[:, None])
    tl.store(s_ptr + row, amax * inv127, mask=live)


def _rank_block_src(q_ptr, s_ptr, i, rows, r, live, ROWS: tl.constexpr):
    # rank i's values and scales for the tile's rows, as float32 (ROWS, 128)
    row = i * rows + r                                   # block of (k, rows)
    q = tl.load(q_ptr + row.to(tl.int64)[:, None] * 128
                + tl.arange(0, 128)[None, :], mask=live[:, None], other=0)
    s = tl.load(s_ptr + row, mask=live, other=0.0)
    return q.to(tl.float32), tl.broadcast_to(s[:, None], (ROWS, 128))


def _dequant_acc_src(q_ptr, s_ptr, o_ptr, rows, K: tl.constexpr,
                     ROWS: tl.constexpr):
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    live = r < rows
    q0, s0 = _rank_block(q_ptr, s_ptr, 0, rows, r, live, ROWS)
    q1, s1 = _rank_block(q_ptr, s_ptr, 1, rows, r, live, ROWS)
    acc = tl.fma(q0, s0, q1 * s1)                        # q1·s1 rounded
    for i in tl.static_range(2, K):
        qi, si = _rank_block(q_ptr, s_ptr, i, rows, r, live, ROWS)
        acc = tl.fma(qi, si, acc)
    tl.store(o_ptr + r.to(tl.int64)[:, None] * 128 + tl.arange(0, 128)[None, :],
             acc, mask=live[:, None])


def _decode_src(q_ptr, s_ptr, o_ptr, blocks, ROWS: tl.constexpr):
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    live = r < blocks
    e = r.to(tl.int64)[:, None] * 128 + tl.arange(0, 128)[None, :]
    q = tl.load(q_ptr + e, mask=live[:, None], other=0).to(tl.float32)
    s = tl.load(s_ptr + r, mask=live, other=0.0)
    tl.store(o_ptr + e, q * s[:, None], mask=live[:, None])


def _kernels():
    """(encode, dequant-accumulate, decode) kernels, built once."""
    global tl, _max_nan, _div_rn, _rint, _rank_block, _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language

        tl = triton.language
        _max_nan = triton.jit(_max_nan_src)
        _div_rn = triton.jit(_div_rn_src)
        _rint = triton.jit(_rint_src)
        _rank_block = triton.jit(_rank_block_src)
        _KERNELS = (triton.jit(_encode_src), triton.jit(_dequant_acc_src),
                    triton.jit(_decode_src))
    return _KERNELS
