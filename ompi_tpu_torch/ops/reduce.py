"""Fold kernels for the card (Triton) — port of ``ompi_tpu/ops/pallas_reduce.py``.

Two entry points, over operands of any shape:

``combine2(op_name, a, b)``
    Elementwise ``a (op) b`` — the two-operand fold every reduction
    algorithm uses (reference kernel table
    ``ompi/mca/op/avx/op_avx_functions.c``).  Replaces the Pallas kernel
    ``pallas_reduce.combine2`` (``ompi_tpu/ops/pallas_reduce.py:82``).

``reduce_stack(op_name, x)``
    Fold a ``(k, ...)`` stack along axis 0, left to right
    (``acc = fold(acc, x[i])``), in one pass.  Replaces
    ``pallas_reduce.reduce_stack`` (``ompi_tpu/ops/pallas_reduce.py:111``).

On the card both are bound by device-memory bytes, not arithmetic: one
fold per element, nothing reused.  ``combine2`` moves 3·S bytes (two reads,
one write); ``reduce_stack`` moves (k+1)·S.  Each writes once, with the
ragged edge masked — no (rows, 128) padding, no intermediate in device
memory — and the op is a ``tl.constexpr`` switch, so one source covers
every op and dtype.  ``combine2`` streams one 1-D block per program.
``reduce_stack`` has k rows to read per block, and a program that loads
them only when it folds them leaves the memory idle between its blocks:
it runs a persistent grid (as many programs as the SMs hold, from the
compiled kernel's registers and shared memory) in which each program walks
blocks grid-stride in a ``tl.range`` with ``num_stages``, so Triton
pipelines the next block's k row loads behind this block's folds.  The fold
runs left to right in ``reduce_stack_plain``'s order, so every op and dtype
is bit-exact against it, MAX/MIN's NaN and ±0 rules included.

A CPU tensor goes to the plain version of each kernel (``*_plain``), a CUDA
tensor to the kernel; ``launches`` counts kernel launches.  Triton is
imported, and the kernels built, at the first launch, so this module
imports without Triton.
"""
from __future__ import annotations

import functools

import torch

from ompi_tpu_torch.base import cudaenv

_BITWISE = ("BAND", "BOR", "BXOR")
_OPCODE = {"SUM": 0, "PROD": 1, "MAX": 2, "MIN": 3, "BAND": 4, "BOR": 5,
           "BXOR": 6, "LAND": 7, "LOR": 8, "LXOR": 9}
#: dtypes the kernels take (bool travels as its uint8 bytes).  torch's
#: uint16/32/64 have little CUDA support: not taken, the builtin fold
#: serves them.
_KERNEL_DTYPES = (torch.float16, torch.bfloat16, torch.float32,
                  torch.float64, torch.int8, torch.uint8, torch.int16,
                  torch.int32, torch.int64, torch.bool)
#: elements per Triton program of ``combine2``
BLOCK = 2048
#: ``reduce_stack``'s setting: bytes of the k rows a block reads (so the
#: block holds ``STACK_BYTES / (k · itemsize)`` elements, a power of two),
#: warps per program, and the depth of the pipeline over a program's blocks
#: (the fastest of three settings timed on an H100; PERF.md)
STACK_BYTES, STACK_WARPS, STACK_STAGES = 32768, 4, 2

#: kernel launches per wrapper (plain-version calls are not counted)
launches = {"combine2": 0, "reduce_stack": 0}


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


_FOLDS = {
    "SUM": lambda a, b: a + b,
    "PROD": lambda a, b: a * b,
    "MAX": torch.maximum,
    "MIN": torch.minimum,
    "BAND": torch.bitwise_and,
    "BOR": torch.bitwise_or,
    "BXOR": torch.bitwise_xor,
    "LAND": _logical(torch.logical_and),
    "LOR": _logical(torch.logical_or),
    "LXOR": _logical(torch.logical_xor),
}


def supported_ops() -> tuple:
    return tuple(_FOLDS)


def _supported_dtype(op_name: str, dtype) -> bool:
    """The dtype gate of ``pallas_reduce._supported_dtype``: bitwise ops
    take integers and bool, the others floats and integers."""
    if dtype not in _KERNEL_DTYPES:
        return False
    if op_name in _BITWISE:
        return not dtype.is_floating_point
    return dtype != torch.bool


def _check(op_name: str, *tensors: torch.Tensor) -> bool:
    """Argument checks shared by the kernel and the plain version; returns
    whether the kernel runs (the operands lie on the card)."""
    if op_name not in _FOLDS:
        raise ValueError(f"unsupported fold {op_name!r}: one of "
                         f"{', '.join(_FOLDS)}")
    t0 = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
        if t.device.type not in ("cuda", "cpu") or t.device != t0.device:
            raise ValueError(f"operands must share one cuda or cpu device, "
                             f"got {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise TypeError(f"operand dtypes differ: {t.dtype} vs {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if not _supported_dtype(op_name, t0.dtype):
        raise TypeError(f"{op_name} does not take dtype {t0.dtype}")
    return cudaenv.on_card(t0)


# -- plain versions ------------------------------------------------------

def combine2_plain(op_name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FOLDS[op_name](a, b)


def reduce_stack_plain(op_name: str, x: torch.Tensor) -> torch.Tensor:
    fold = _FOLDS[op_name]
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = fold(acc, x[i])
    return acc


# -- wrappers ------------------------------------------------------------

def combine2(op_name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a (op) b``; shape and dtype of ``a``."""
    on_card = _check(op_name, a, b)
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if not on_card:
        return combine2_plain(op_name, a, b)
    out = torch.empty_like(a)
    n = a.numel()
    if n:
        _, k_combine, _ = _kernels()
        k_combine[(-(-n // BLOCK),)](
            _lane(a), _lane(b), _lane(out), n,
            OP=_OPCODE[op_name], BLOCK=BLOCK, num_warps=4)
        launches["combine2"] += 1
    return out


def reduce_stack(op_name: str, x: torch.Tensor) -> torch.Tensor:
    """Fold ``x[k, ...]`` along axis 0, left to right, in one pass."""
    on_card = _check(op_name, x)
    if x.dim() < 1 or x.shape[0] < 1:
        raise ValueError(f"reduce_stack needs a (k, ...) stack with k >= 1, "
                         f"got shape {tuple(x.shape)}")
    k = x.shape[0]
    if k == 1:
        return x[0].clone()
    if not on_card:
        return reduce_stack_plain(op_name, x)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if out.numel():
        _launch_stack(op_name, x, out)
        launches["reduce_stack"] += 1
    return out


def stack_block(k: int, itemsize: int) -> int:
    """Elements per block of the stack fold: the largest power of two whose
    k rows fit ``STACK_BYTES``, 128 at least."""
    return max(128, 1 << (STACK_BYTES // (k * itemsize)).bit_length() - 1)


def _launch_stack(op_name: str, x: torch.Tensor, out: torch.Tensor):
    """One launch of the stack fold over a persistent grid; returns the
    compiled kernel (its ``n_regs`` and ``n_spills``) and the grid."""
    _, _, k_stack = _kernels()
    per = out.numel()
    block = stack_block(x.shape[0], x.element_size())
    blocks = -(-per // block)
    args = (_lane(x), _lane(out), per, blocks)
    meta = dict(K=x.shape[0], OP=_OPCODE[op_name], BLOCK=block,
                STAGES=STACK_STAGES, num_warps=STACK_WARPS,
                num_stages=STACK_STAGES)
    key = (x.device.index, x.dtype, x.shape[0], op_name, per % 16,
           blocks % 16)
    fits = _PER_SM.get(key)
    if fits is None:
        fits = _PER_SM[key] = _programs_per_sm(
            k_stack.warmup(*args, **meta, grid=(1,)), STACK_WARPS, x.device)
    grid = min(blocks, _sm_count(x.device.index) * fits)
    return k_stack[(grid,)](*args, **meta), grid


def device_fold(op_name: str, dtype):
    """Return a two-operand fold callable for (op, dtype), or None.

    The op framework's component query hook: None means "these kernels do
    not cover the type", and selection falls through to the next component
    (the builtin torch fold), as in ``pallas_reduce.device_fold``."""
    if op_name not in _FOLDS or not _supported_dtype(op_name, dtype):
        return None
    return functools.partial(combine2, op_name)


#: (device, dtype, k, op, alignment) -> programs of the stack fold an SM
#: holds
_PER_SM: dict = {}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _programs_per_sm(kernel, num_warps: int, device) -> int:
    """How many programs of the compiled ``kernel`` one SM holds at once,
    from its registers and shared memory (Triton's persistent-kernel
    recipe)."""
    from triton.runtime import driver

    props = driver.active.utils.get_device_properties(device.index)
    kernel._init_handles()
    threads = props["warpSize"] * num_warps
    regs = -(-max(kernel.n_regs, 1) // 8) * 8       # allocated in 8s
    fits = min(props["max_num_regs"] // (regs * threads), 2048 // threads)
    if kernel.metadata.shared:                       # 1 KB reserved a block
        fits = min(fits, (props["max_shared_mem"] + 1024)
                   // (kernel.metadata.shared + 1024))
    return max(fits, 1)


# -- Triton kernels ------------------------------------------------------
# Written at module level so Triton can read their source; ``tl`` and
# ``_fold`` are bound when ``_kernels`` first runs (on the card only).

tl = None
_fold = None
_KERNELS = None


def _lane(t: torch.Tensor) -> torch.Tensor:
    """bool travels through the kernels as its uint8 bytes (0/1)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _fold_src(a, b, OP: tl.constexpr):
    # MAX/MIN: a NaN operand wins, as in torch.maximum/minimum; equal
    # operands give ``a``
    if OP == 0:
        r = a + b
    elif OP == 1:
        r = a * b
    elif OP == 2:
        r = tl.where((a != a) | (a >= b), a, b)
    elif OP == 3:
        r = tl.where((a != a) | (a <= b), a, b)
    elif OP == 4:
        r = a & b
    elif OP == 5:
        r = a | b
    elif OP == 6:
        r = a ^ b
    elif OP == 7:
        r = ((a != 0) & (b != 0)).to(a.dtype)
    elif OP == 8:
        r = ((a != 0) | (b != 0)).to(a.dtype)
    else:
        r = ((a != 0) ^ (b != 0)).to(a.dtype)
    return r


def _combine2_src(a_ptr, b_ptr, o_ptr, n, OP: tl.constexpr,
                  BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    a = tl.load(a_ptr + offs, mask=mask)
    b = tl.load(b_ptr + offs, mask=mask)
    tl.store(o_ptr + offs, _fold(a, b, OP).to(o_ptr.dtype.element_ty),
             mask=mask)


def _stack_src(x_ptr, o_ptr, per, blocks, K: tl.constexpr, OP: tl.constexpr,
               BLOCK: tl.constexpr, STAGES: tl.constexpr):
    # a persistent program: blocks pid, pid + programs, ...; STAGES deep,
    # Triton pipelines the next blocks' loads behind this block's folds
    for b in tl.range(tl.program_id(0), blocks, tl.num_programs(0),
                      num_stages=STAGES):
        offs = b.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < per
        row = x_ptr
        acc = tl.load(row + offs, mask=mask)
        for _ in tl.static_range(1, K):
            row += per
            acc = _fold(acc, tl.load(row + offs, mask=mask), OP)
        tl.store(o_ptr + offs, acc.to(o_ptr.dtype.element_ty), mask=mask)


def _kernels():
    """(triton, combine2 kernel, reduce_stack kernel), built once."""
    global tl, _fold, _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language

        tl = triton.language
        _fold = triton.jit(_fold_src)
        _KERNELS = (triton, triton.jit(_combine2_src), triton.jit(_stack_src))
    return _KERNELS
