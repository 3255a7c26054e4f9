"""The collective matmul for the card (CUDA C++) — port of ``ompi_tpu/ops/pallas_overlap.py``.

The contraction-sharded ("tensor-parallel k-split") matmul

    C = Σ_i  A_i @ B_i        A_i: (M, K/n),  B_i: (K/n, N)

whose partial products ring-reduce across the ranks.  The reference runs it
as kernel K20, ``pallas_overlap._build_fused_matmul``
(``ompi_tpu/ops/pallas_overlap.py:57``, ``pallas_call`` at ``:146``), over a
1-D mesh: the rows are cut into n blocks of ``m_blk = ceil(M/n)`` (zero
padded, ``:168-174``), and each ring step computes a block's partial just in
time while the running partial of another block is in flight.  On one card
the ranks are rows of one tensor, ``a (n, M, K/n)`` and ``b (n, K/n, N)``
(``(x, n)`` as in ``ops/ring_collectives.py``); the remote copies vanish and
what stays is the schedule's arithmetic, which the port keeps bit for bit:

* each rank's partial is rounded to the operand dtype before it is folded,
  ``P_r[blk] = dot(a[r][blk rows], b[r], f32).astype(dtype)`` (``:88-92``);
* every fold is "mine + incoming" in the dtype (``:111-112``), block ``blk``
  starting on rank ``blk + s`` and taking ranks ``blk + s + 1, …`` in turn:
  ``s = 0`` for ``matmul_allreduce`` (align 0, K3's start offset; the
  all-gather that replicates the result moves no bytes on one card), ``s =
  1`` for ``matmul_reduce_scatter`` (align −1, K5's).

``matmul_allreduce(a, b, n)`` returns the ``(M, N)`` product;
``matmul_reduce_scatter(a, b, n)`` the ``(n, m_blk, N)`` row blocks, block i
being rank i's, with the padded tail kept (``:186-197``).  Mixed dtypes are
promoted before the kernel (``:44-47``); a contraction mismatch raises
``ValueError("contraction mismatch …")`` (``:39-43``); ``n == 1`` is the
plain product ``a[0] @ b[0]`` with no kernel (``:194-195``, ``:235-236``).

A CPU tensor goes to the plain version (``*_plain``: the whole schedule in
torch), a CUDA tensor to the kernel (``csrc/fused_matmul.cu``), which takes
float32 (FFMA, no TF32) and bfloat16 (tensor cores, float32 accumulators)
and raises ``TypeError`` on any other dtype.  ``launches`` counts kernel
launches per form; ``bodies`` counts them per body, as the C entry point
reports the one it launched (it alone picks, by shape): ``ffma`` for
float32, ``wgmma`` (TMA and ``wgmma`` in a persistent grid) for bfloat16
where ``K/n`` and ``N`` are multiples of 8 and both operands 16-byte
aligned, ``mma_sync`` (wmma) for the other bfloat16 shapes.  Not
copied: the TPU kernel stages all of ``a`` in VMEM and overlaps a remote DMA
with each partial; one card has no link to overlap.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ompi_tpu_torch.base import cudaenv

#: kernel launches per wrapper (plain-version calls are not counted)
launches = {"matmul_allreduce": 0, "matmul_reduce_scatter": 0}
#: the same launches per body of the kernel
bodies = {"wgmma": 0, "mma_sync": 0, "ffma": 0}

_DTCODE = {torch.float32: 0, torch.bfloat16: 1}
#: body codes of the C entry point (``BODY_*`` in ``csrc/fused_matmul.cu``)
_BODIES = ("ffma", "wgmma", "mma_sync")
#: ring-block start offset: all-reduce (align 0), reduce-scatter (align -1)
_AR_START, _RS_START = 0, 1


def _prep(a: torch.Tensor, b: torch.Tensor, n: int, what: str) -> tuple:
    """The shared preamble (``_prep_operands``): check the layout and the
    contraction, promote mixed dtypes; returns ``(a, b, m_blk)``."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        raise TypeError(f"{what} takes torch.Tensors")
    if a.device != b.device:
        raise ValueError(f"{what}: a on {a.device}, b on {b.device}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n:
        raise ValueError(f"{what} needs a ({n}, M, K/n) and b ({n}, K/n, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if b.shape[1] != a.shape[2]:
        raise ValueError(f"contraction mismatch: a has K/n={a.shape[2]}, b "
                         f"has {b.shape[1]}")
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype), -(-a.shape[1] // n)


def _fold_plain(a: torch.Tensor, b: torch.Tensor, n: int, m_blk: int,
                start: int) -> torch.Tensor:
    """The ring schedule in torch: every rank's partial of every block
    (float32 products rounded to the dtype), folded block by block in ring
    order from rank ``blk + start``; returns ``(n, m_blk, N)``."""
    ap = F.pad(a, (0, 0, 0, n * m_blk - a.shape[1]))
    p = torch.matmul(ap.float(), b.float()).to(a.dtype)
    p = p.reshape(n, n, m_blk, b.shape[2])          # [rank, block, row, col]
    blk = torch.arange(n, device=a.device)
    acc = p[(blk + start) % n, blk]
    for j in range(1, n):
        acc = p[(blk + start + j) % n, blk] + acc   # mine + incoming
    return acc


def matmul_allreduce_plain(a: torch.Tensor, b: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Plain version of K20's all-reduce form: ``(M, N)``."""
    a, b, m_blk = _prep(a, b, n, "matmul_allreduce")
    if n == 1:
        return torch.matmul(a[0], b[0])
    out = _fold_plain(a, b, n, m_blk, _AR_START)
    return out.reshape(n * m_blk, -1)[:a.shape[1]]


def matmul_reduce_scatter_plain(a: torch.Tensor, b: torch.Tensor,
                                n: int) -> torch.Tensor:
    """Plain version of K20's reduce-scatter form: ``(n, m_blk, N)``."""
    a, b, m_blk = _prep(a, b, n, "matmul_reduce_scatter")
    if n == 1:
        return torch.matmul(a[0], b[0])[None]
    return _fold_plain(a, b, n, m_blk, _RS_START)


def _kernel(a: torch.Tensor, b: torch.Tensor, n: int, m_blk: int, start: int,
            key: str) -> torch.Tensor:
    """Launch K20 on ``a (n, M, K/n)``, ``b (n, K/n, N)``; returns the
    ``(out_rows, N)`` rows: M for the all-reduce, ``n * m_blk`` for the
    reduce-scatter."""
    from ompi_tpu_torch.ops import _build

    if a.dtype not in _DTCODE:
        raise TypeError(f"{key} on the card takes float32 or bfloat16, got "
                        f"{a.dtype}")
    m, k, nc = a.shape[1], a.shape[2], b.shape[2]
    out_rows = m if start == _AR_START else n * m_blk
    if max(m, k, nc, out_rows) >= 2 ** 31:
        raise ValueError(f"{key} on the card takes dims below 2^31")
    out = torch.empty((out_rows, nc), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    a, b = a.contiguous(), b.contiguous()
    body = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        err = _build.load("fused_matmul").otpu_fused_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, k, nc, m_blk,
            start, out_rows, _DTCODE[a.dtype], ctypes.byref(body),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"otpu_fused_matmul failed: CUDA error {err}")
    launches[key] += 1
    bodies[_BODIES[body.value]] += 1
    return out


def matmul_allreduce(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``Σ_i a[i] @ b[i]`` as the replicated ``(M, N)`` product of the
    fused ring (align 0)."""
    a, b, m_blk = _prep(a, b, n, "matmul_allreduce")
    if n == 1 or not cudaenv.on_card(a):
        return matmul_allreduce_plain(a, b, n)
    return _kernel(a, b, n, m_blk, _AR_START, "matmul_allreduce")


def matmul_reduce_scatter(a: torch.Tensor, b: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Row-parallel fused GEMM: ``(n, m_blk, N)``, block i the row block of
    ``Σ_j a[j] @ b[j]`` that rank i owns (align −1); M is padded to
    ``n * m_blk``, and callers slice the tail block."""
    a, b, m_blk = _prep(a, b, n, "matmul_reduce_scatter")
    if n == 1 or not cudaenv.on_card(a):
        return matmul_reduce_scatter_plain(a, b, n)
    out = _kernel(a, b, n, m_blk, _RS_START, "matmul_reduce_scatter")
    return out.reshape(n, m_blk, -1)
