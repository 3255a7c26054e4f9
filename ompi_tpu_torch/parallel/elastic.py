"""The exact-arithmetic helpers of the elastic training loop.

Copy of the numpy-only part of ``ompi_tpu/parallel/elastic.py`` (``:52-86``)
that ``parallel/moe.py``'s gating and oracle use: the gradient of global
sample ``j`` at step ``s`` is an integer field and the learning rate a power
of two, so every update is an exact dyadic rational and any partition of the
batch sums to the same float64 bits.  ``ElasticTrainer`` (checkpoints,
detect → revoke → agree → shrink → restore) waits for the fault-tolerance
tier.
"""
from __future__ import annotations

import numpy as np

#: power-of-two learning rate: updates are exact dyadic rationals
DEFAULT_LR = 2.0 ** -6

_P1, _P2, _P3 = 1_000_003, 7_919, 104_729


def grad_field(step: int, lo: int, hi: int, dims: int,
               seed: int = 0) -> np.ndarray:
    """Summed integer gradient of global samples [lo, hi) at ``step``.

    Values are small integers (|g| <= 8 per sample), so any partition of
    the global batch sums to the same float64 bit pattern."""
    j = np.arange(int(lo), int(hi), dtype=np.int64)[:, None]
    d = np.arange(int(dims), dtype=np.int64)[None, :]
    g = (int(step) * _P1 + j * _P2 + d * _P3 + int(seed) * 13) % 17 - 8
    return g.sum(axis=0).astype(np.float64)


def partition(rank: int, size: int, total: int) -> tuple:
    """Contiguous [lo, hi) split of ``total`` items over ``size`` ranks
    (first ``total % size`` ranks take one extra)."""
    base, rem = divmod(int(total), int(size))
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (1 if rank < rem else 0)


def reference_run(w0: np.ndarray, from_step: int, to_step: int,
                  global_batch: int, lr: float = DEFAULT_LR,
                  seed: int = 0) -> np.ndarray:
    """Failure-free single-process replay from ``w0`` at ``from_step``."""
    w = np.array(w0, dtype=np.float64, copy=True)
    for s in range(int(from_step), int(to_step)):
        w -= lr * grad_field(s, 0, global_batch, w.shape[0], seed)
    return w
