"""The flash-attention block update for the card (CUDA C++) — port of ``ompi_tpu/ops/flash_attention.py``.

Ring attention (``ompi_tpu_torch/parallel/model.py``) rotates K/V blocks
around the sequence-parallel axis and, per ring step, folds one K/V block
into a running ``(max, numerator, denominator)`` softmax state.  That
block update is kernel K21 (``csrc/flash_block.cu``), replacing
``flash_attention._update_pallas`` (``ompi_tpu/ops/flash_attention.py:135``,
body ``_block_kernel`` ``:38-71``)::

    s    = q kᵀ · d^-½ (+ bias)          # float32
    m'   = max(m, rowmax s)
    c    = e^(m − m'),  p = e^(s − m')
    num' = num·c + p v,  den' = den·c + Σp

q ``(*lead, sq, d)``, k/v ``(*lead, skv, d)``, m/den ``(*lead, sq)``, num
``(*lead, sq, d)``; the reference's lead is ``(b, h)``, the port's ring
attention adds the four mesh axes in front, so one launch serves every
rank.  Casts follow the reference's kernel, not its jnp twin: q kᵀ and
p v accumulate in float32, m and den are upcast to float32, p is cast to
v's dtype before p v (``:65-67``), num' is rounded to num's dtype and m',
den' to theirs once at the end (``:68-71``, ``:186-188``).

``bias`` is an additive score bias (−inf masks): the reference's is one
``(sq, skv)`` shared over ``(b, h)`` (``:168-171``); here it is ``(*P, sq,
skv)`` with ``P`` a prefix of q's leading dims (``()`` is the reference's
form), so causal ring attention gives each sp rank its own mask.  It is
read as float32 whatever its dtype, as the reference upcasts it.

``flash_block_update`` and ``flash_block_update_biased`` are
``torch.autograd.Function``s: the forward is the kernel on a CUDA tensor
and ``update_plain`` on a CPU tensor; the backward recomputes through
``update_twin`` (the reference's ``_update_jnp``) under autograd, as the
reference's ``custom_vjp`` does (``:91-131``): nothing beyond the step's
inputs is saved, and the backward launches no kernel.  ``launches``
counts kernel launches; on a CUDA tensor a wrapper launches the kernel or
raises.

Layout: the reference pads m and den to ``(bh, sq, 128)`` lanes for
Mosaic's tiling (``:152-155``); the port keeps them ``(*lead, sq)``.

Bound on an H100: operations.  A call does 4·B·sq·skv·d operations (two
products) on 4·B·(sq + skv)·d elements, ~sq·skv/(sq + skv) operations per
element, far above the ridge at the step's and the bench's shapes.  So the
kernel (see its source) is built to feed the FFMA pipes: float32 FMAs on
the CUDA cores for both dtypes (no TF32, no tensor cores), Q, K and V
brought to shared memory by 16-byte ``cp.async`` (K and V in units through
two stages, one in flight while the other is computed), operands read
16 bytes at a time into 4 × 4 score and 8 × 8 ``p v`` register tiles, and
the block's scores kept on chip where 64 × skv of them fit (skv ≤ 320 at
d = 256 in float32: the step's 256), so that the second pass does not
recompute ``q kᵀ``; a larger skv (the bench's 2048) recomputes it.  Each
sum still runs in ascending order with the reference's unfused ends.  What
still bounds it is the FFMA issue rate; its times are in ``PERF.md``.
"""
from __future__ import annotations

import math

import torch

from ompi_tpu_torch.base import cudaenv

#: kernel launches per wrapper (plain-version calls are not counted)
launches = {"flash_block": 0}

_DTCODE = {torch.float32: 0, torch.bfloat16: 1}
#: a thread of the kernel owns at most 8 of a query's output columns, two
#: groups of 4 across a warp's 32 lanes: d up to 256
MAX_HEAD_DIM = 256


def lift_bias(bias: torch.Tensor, lead_ndim: int) -> torch.Tensor:
    """``bias (*P, sq, skv)`` with 1s inserted after ``P`` so it
    broadcasts against scores ``(*lead, sq, skv)``."""
    prefix = bias.shape[:-2]
    return bias.reshape(*prefix, *([1] * (lead_ndim - len(prefix))),
                        *bias.shape[-2:])


def _scores(q, k, bias) -> torch.Tensor:
    """``q kᵀ · d^-½ (+ bias)`` in float32, the kernel's order."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + lift_bias(bias.float(), q.dim() - 2)
    return s


def update_plain(q, k, v, m, num, den, bias=None):
    """Plain version of K21, with the kernel's casts; returns ``(m', num',
    den')`` in the dtypes of ``(m, num, den)``."""
    s = _scores(q, k, bias)
    m32 = m.float()
    new_m = torch.maximum(m32, s.amax(dim=-1))
    c = torch.exp(m32 - new_m)
    p = torch.exp(s - new_m[..., None])
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    new_num = num.float() * c[..., None] + pv
    new_den = den.float() * c + p.sum(dim=-1)
    return new_m.to(m.dtype), new_num.to(num.dtype), new_den.to(den.dtype)


def update_twin(q, k, v, m, num, den, bias=None):
    """The block update in the working dtype, step by step (the
    reference's ``_update_jnp``): the recompute of the backward pass."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + lift_bias(bias, q.dim() - 2)
    new_m = torch.maximum(m, s.amax(dim=-1))
    c = torch.exp(m - new_m)
    p = torch.exp(s - new_m[..., None])
    new_num = num * c[..., None] + torch.matmul(p, v)
    new_den = den * c + p.sum(dim=-1)
    return new_m, new_num, new_den


def _check(q, k, v, m, num, den, bias) -> bool:
    """Shapes, dtypes and devices K21 takes; returns whether the kernel
    runs (the tensors lie on the card)."""
    ts = (q, k, v, m, num, den) + (() if bias is None else (bias,))
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash_block_update takes torch.Tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_block_update: operands on different devices")
    if q.dim() < 2:
        raise ValueError(f"flash_block_update needs q (*lead, sq, d), got "
                         f"{tuple(q.shape)}")
    lead, sq, d = q.shape[:-2], q.shape[-2], q.shape[-1]
    skv = k.shape[-2]
    want = {"k": (k, (*lead, skv, d)), "v": (v, (*lead, skv, d)),
            "m": (m, (*lead, sq)), "num": (num, (*lead, sq, d)),
            "den": (den, (*lead, sq))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"flash_block_update: {name} is "
                             f"{tuple(t.shape)}, want {tuple(shape)}")
    if skv == 0:
        raise ValueError("flash_block_update needs a non-empty K/V block")
    for name, t in (("q", q), ("m", m), ("num", num), ("den", den)) + (
            () if bias is None else (("bias", bias),)):
        if t.dtype not in _DTCODE:
            raise TypeError(f"flash_block_update takes float32 or bfloat16, "
                            f"got {name} {t.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_block_update: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype} must share one dtype")
    if bias is not None:
        prefix = bias.shape[:-2]
        if (bias.dim() < 2 or tuple(bias.shape[-2:]) != (sq, skv)
                or len(prefix) > len(lead)
                or any(b not in (1, n) for b, n in zip(prefix, lead))):
            raise ValueError(f"flash_block_update: bias {tuple(bias.shape)} "
                             f"is not (*P, {sq}, {skv}) with P a prefix of "
                             f"q's leading dims {tuple(lead)}")
    return cudaenv.on_card(q)


def update(q, k, v, m, num, den, bias=None):
    """K21 on a CUDA tensor, ``update_plain`` on a CPU tensor (no
    autograd: the forward of the Functions below)."""
    if not _check(q, k, v, m, num, den, bias):
        return update_plain(q, k, v, m, num, den, bias)
    return _launch(q, k, v, m, num, den, bias)


def _launch(q, k, v, m, num, den, bias):
    from ompi_tpu_torch.ops import _build

    lead, sq, d = q.shape[:-2], q.shape[-2], q.shape[-1]
    skv = k.shape[-2]
    rows = math.prod(lead)
    if d > MAX_HEAD_DIM or rows >= 2 ** 31:
        raise ValueError(f"flash_block_update on the card takes head dims up to "
                         f"{MAX_HEAD_DIM} and < 2^31 rows, got d={d}, "
                         f"rows={rows}")
    m_out = torch.empty_like(m, memory_format=torch.contiguous_format)
    num_out = torch.empty_like(num, memory_format=torch.contiguous_format)
    den_out = torch.empty_like(den, memory_format=torch.contiguous_format)
    if rows == 0 or sq == 0:
        return m_out, num_out, den_out
    q, k, v, m, num, den = (t.contiguous() for t in (q, k, v, m, num, den))
    groups, bias_ptr, bias_dt = 1, None, 0
    if bias is not None:
        prefix = tuple(lead[:bias.dim() - 2])
        bias = bias.expand(*prefix, sq, skv).contiguous()
        groups, bias_ptr, bias_dt = math.prod(prefix), bias.data_ptr(), \
            _DTCODE[bias.dtype]
    with torch.cuda.device(q.device):
        err = _build.load("flash_block").otpu_flash_block(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            num.data_ptr(), den.data_ptr(), bias_ptr, m_out.data_ptr(),
            num_out.data_ptr(), den_out.data_ptr(), rows, sq, skv, d,
            rows // groups, _DTCODE[q.dtype], _DTCODE[m.dtype],
            _DTCODE[num.dtype], _DTCODE[den.dtype], bias_dt,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"otpu_flash_block failed: CUDA error {err}")
    launches["flash_block"] += 1
    return m_out, num_out, den_out


class _FlashBlock(torch.autograd.Function):
    """Forward: K21 (or its plain version on the CPU); backward: autograd
    through ``update_twin`` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, m, num, den, bias):
        ctx.save_for_backward(q, k, v, m, num, den, bias)
        return update(q, k, v, m, num, den, bias)

    @staticmethod
    def backward(ctx, g_m, g_num, g_den):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(w)
                  for t, w in zip(saved, need)]
            outs = update_twin(*xs)
            wrt = [x for x, w in zip(xs, need) if w]
            got = iter(torch.autograd.grad(outs, wrt, (g_m, g_num, g_den),
                                           allow_unused=True) if wrt else ())
        return tuple(next(got) if w else None for w in need)


def flash_block_update(q, k_blk, v_blk, m, num, den):
    """One online-softmax accumulation step against a K/V block; returns
    the updated ``(m, num, den)``.  Differentiable (recompute backward)."""
    return _FlashBlock.apply(q, k_blk, v_blk, m, num, den, None)


def flash_block_update_biased(q, k_blk, v_blk, m, num, den, bias):
    """The block update with an additive score bias ``(*P, sq, skv)``
    (−inf masks, finite shifts)."""
    return _FlashBlock.apply(q, k_blk, v_blk, m, num, den, bias)
