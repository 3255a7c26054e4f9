"""Smoke run of the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. The card: ``nvidia-smi --query-gpu=name,power.limit``.
2. Every kernel of the main path against its plain PyTorch version, on the
   card, bit for bit (the fold order of each is fixed):
   K2 ``combine2`` (Triton) — every op on float32, int32, int8 and bool;
   K1 ``reduce_stack`` (Triton) — k = 8, 16 MB slices, the same ops;
   K3 fused ring all-reduce (CUDA C++) — float32 sum/max/min/prod, 4 MB per
   rank; K4 segmented ring all-reduce (CUDA C++) — the same at 16 MB per rank;
   K5 fused ring reduce-scatter (CUDA C++) — the same four ops on
   ``(8, 8, 131072)``, 4 MB per rank; K6 segmented ring reduce-scatter —
   the same on ``(8, 8, 524288)``, 16 MB per rank; K5 and K6 on ragged
   blocks ``S = (3, 5)`` and ``(1001,)``, float32 and float16; K10 ring
   all-gather (CUDA C++) — 16 MB per rank float32, an odd int8 length and an
   unaligned pointer; K12 ring bcast (CUDA C++) — roots 0, 3 and 7 at 16 MB
   per rank float32 (root 3's row holding -0.0 and NaN), int32, an int8
   payload of odd byte length, bool and bfloat16; K13 ring right permute
   (CUDA C++) — 16 MB per rank float32, an odd float16 length, an unaligned
   pointer; K14 all-to-all (CUDA C++) — ``(8, 8, 524288)`` float32 (16 MB per
   rank), int8 blocks of odd byte length, bool; K15 ragged all-to-all (CUDA
   C++) — the MoE dispatch slab below with its routing, then counts 0, R,
   R + 5 and -3, an R of 1001 (not a whole number of chunk_rows), and the
   slab as int32; K16 ragged all-gather (CUDA C++) — ``(8, 1280, 4096)``
   float32 with the routing's counts, with counts 0 and R, and bfloat16.
   The copies (K10, K12, K13–K16) are compared byte for byte, the ragged
   ones over their valid rows.  The int8 codec (Triton): K17
   ``encode_int8``, K19 ``decode_int8`` and K18 ``dequant_accumulate`` at
   k = 2 and 8, on 8 × 16 MB float32 and on 8 × 70001 elements, each holding
   an all-zero block, a block of exact .5 ties, a NaN block and a ±inf block
   (bit for bit; NaN compared as NaN at the same places).  The bf16 wire
   (CUDA C++): K7 ``all_reduce`` wire16 with sum/max/min/prod at 4 MB per
   rank and 23 and 1000 elements per rank, K5's wire16 form on ``(8, 8,
   131072)`` and ragged blocks ``S = (23,)`` and ``(5, 200)``.  K21, the
   flash-attention block update (CUDA C++), within 1e-6 (float32) and 2^-7
   (bfloat16) of the plain version's largest magnitude, NaN at the same
   places: both dtypes at the training step's shape (32 rows, 256 x 256,
   head dim 256), unbiased and with ring attention's per-rank causal bias,
   from m = -inf and chained (a fully masked block leaves the state); a
   fully masked row at m = -inf (NaN); a ragged sq = 200; the JAX bench's
   shape ``(4, 8, 2048, 2048, 128)`` in bfloat16.  The duplex ring (CUDA
   C++): K8 ``all_reduce`` bidi at 4 MB per rank and K9 seg_bidi at 16 MB
   per rank (float32, every op), both on 23, 407 and 999 elements per rank
   in float16/32/64 with every op, from an aligned and an unaligned pointer;
   K11 all-gather bidi on 16 MB per rank float32, an odd int8 length, an
   unaligned view and n = 5 (byte for byte).  The torus schedules, each
   phase one sub-ring launch of K3/K5, on grids (2, 4) and (4, 2) against
   their plain composition: ``all_reduce_torus`` (float32 and float16, every
   op), ``reduce_scatter_torus`` (sum, max) and ``all_gather_torus``.  K20,
   the collective matmul (CUDA C++), both forms (``matmul_allreduce``,
   ``matmul_reduce_scatter``) at Mixtral-8x7B's expert down projection
   (``w2``, 14336 → 4096, split over the 8 ranks along its hidden units,
   on the capacity buffer of 8 × 1280 rows: a ``(8, 10240, 1792)``, b
   ``(8, 1792, 4096)``), at M = 10237 (a padded last block) and at a
   ``(8, 1001, 37)``, b ``(8, 37, 203)`` (K/n and N off the multiples of 8),
   float32 and bfloat16: bit for bit on integer inputs in [-4, 4], within 1e-5
   (float32) and 2^-7 (bfloat16) of the largest Σ|a||b| on normal ones, and
   bfloat16 within (n + 1)·2^-8 of max|C| (half an ulp for each of the n
   partials' roundings and of the folds').
3. The main path, with every launch count set to 0 before and read after:
   ``ompi_tpu_torch.init()`` (8 virtual ranks on ``cuda:0``), then at
   default priorities ``COMM_WORLD.allreduce_array`` — SUM to coll/builtin,
   PROD and BAND to coll/builtin's stack fold (K1) — ``bcast_array(root=3)``
   and ``allgather_array`` at 16 MB per rank and ``reduce_scatter_array``
   SUM and PROD (K1) at 4 MB per rank, all through coll/builtin, and
   ``ompi_tpu_torch.reduce_local`` (MPI_Reduce_local, K2); then re-init with
   ``OTPU_MCA_coll_ring_priority=95``: allreduce SUM at 4 MB per rank (K3)
   and at 16 MB per rank, the headline cell (K4), ``bcast_array`` (K12) and
   ``allgather_array`` (K10) at 16 MB per rank, ``reduce_scatter_array``
   SUM at 4 MB (K5) and 16 MB per rank (K6).  The exchange tier, both
   ways: ``alltoall_array`` on ``(8, 8, 524288)`` float32 (K14),
   ``alltoallv_array`` on the MoE dispatch slab (K15), ``allgatherv_array``
   on ``(8, 1280, 4096)`` float32 (K16), ``ppermute_array`` with the +1
   rotation at 16 MB per rank (K13) and with a general perm that leaves
   rank 1 without a source (coll/builtin both ways: K13's count must not
   move).  The compressed collectives: in the first init, ``COMM_WORLD.dup()``
   with the accuracy budget 0.01 (info key ``otpu_quant_budget``) runs
   allreduce SUM and allgather at 16 MB per rank through coll/builtin's
   int8 codec (K17 twice, K18 once, K19 once, exactly); a dup with budget
   0.005 (bf16 codec, plain torch) and MAX on the 0.01 dup launch no codec
   kernel; a third init adds ``OTPU_MCA_coll_ring_wire16=1`` to the raised
   ring: allreduce SUM at 4 MB per rank (K7 once), at 16 MB per rank (K4,
   no K7) and reduce_scatter SUM at 4 MB per rank (K5's wire16 form once); a
   fourth init has the raised ring with
   ``OTPU_MCA_coll_ring_bidirectional=1``: allreduce SUM at 4 MB per rank
   (K8 once) and at 16 MB per rank (K9 once), reduce_scatter SUM at 4 and 16
   MB per rank (K5, K6: no duplex kernel), allgather at 16 MB per rank (K11
   once), and ``allreduce_array_init`` at 4 MB per rank (K8 once to bind it)
   called twice (K8 twice, bit-equal to the one-shot call).
   Each result is held against the plain version (bit-exact; the ragged
   calls' views over their valid rows) and, for SUM, against
   ``torch.sum(x, 0)`` (tolerance below; the codecs within their band of
   ``torch.sum(x.double(), 0)`` relative to its largest magnitude, the
   wire within n·2^-8·Σ|x_i|).

   The MoE dispatch slab is Mixtral-8x7B's expert layer at full width
   (hidden 4096, 8 experts, top-2; the model card's published widths): 4096
   tokens per rank route 8192 rows over the 8 experts, one expert a rank,
   with skewed popularity (Zipf, exponent 0.7, sampled without replacement
   by Gumbel top-2 from SEED); capacity factor 1.25 gives R = ceil(1.25 ·
   4096 · 2 / 8) = 1280 rows per (rank, expert) pair, and each count is
   clamped to R, as a capacity-factor MoE drops the overflow.  x is
   ``(8, 8, 1280, 4096)`` float32: 160 MB per rank.

   Then the training path, with the counts set to 0 before and read after:
   ``parallel.dryrun.run_training_step`` at ``OTPU_MODEL_SCALE=64`` (the
   JAX package's bench width: d 512, head dim 256, sequence 512; lr 1e-5),
   two descending steps on the default mesh (dp=2, sp=2, tp=2) and two on
   dp=1, pp=2, sp=2, tp=2; K21 exactly (M + pp - 1) x layers_local x sp
   times a step (4 and 6), twice that under remat; the step with
   ``use_flash=False`` within 1e-5 of the K21 step's loss and 1e-4 of each
   leaf's update.

   Then the MoE path, with the counts set to 0 before and read after: a
   world with coll/ring raised; ``parallel.moe.expert_ffn_fused`` on K20's
   Mixtral shape in float32 through coll/tuned's device cell (K20's
   all-reduce form once); with ``otpu_coll_tuned_fused_cells`` forcing
   ``matmul_reduce_scatter``, ``expert_ffn_fused`` again (its unfused
   einsum: no K20) and that cell itself (K20's reduce-scatter form once);
   ``dispatch_tokens`` on the MoE dispatch slab (K15 once) and on a dup
   with ``otpu_quant_budget`` 0.02 (the int8 packing, an int32 slab ``(8,
   8, 1280, 1152)``, K15 once); ``run_moe_training_step`` on (dp=2, ep=4)
   (descending, bit-stable across two builds, within 1e-5 of a CPU run).
   The counts must be exactly those; K20 within its band of the plain
   version, the dispatch byte-exact (int8: bit-exact with the plain
   exchange of the packed slab, within half a step of each row's max).
4. Times: CUDA events around single calls, cold L2 (a 256 MB buffer is
   zeroed before each call), median of 25 after 3 warm-up calls, for each
   kernel, its plain version and one PyTorch library call computing the same
   function; the card spins first while the host enqueues every timed call,
   so host dispatch is never timed.  ``bound_ms`` is the bytes the function
   must move (inputs read once, output written once) over 3.35 TB/s, the
   H100 SXM's memory rate; the ragged kernels count their valid rows only.
   K7 and K5's wire16 form are timed
   beside K3 and K5 on the same inputs (the same bytes), K8 and K9 beside
   K3 and K4, the ``torus_ms`` line times the three torus functions at 8 ×
   16 MB on the (2, 4) grid beside ``torch.sum`` and ``clone``, and the
   ``codec_path_ms`` line times the whole int8 allreduce (K17 then K18) and
   the bf16 codec's plain torch beside ``torch.sum`` at 8 × 16 MB.
   The ``crossover_ms`` line times both
   accumulator regimes of the all-reduce and of the reduce-scatter at 4 and
   16 MB per rank; the ``host_us_per_call`` line is the host's time to
   enqueue one call of each kernel's wrapper and of its library call
   (200 calls while the card spins; K15's and K16's include the counts
   table each call makes and sends to the card).  K21 is timed at the
   step's shape (float32, its kernels-line row) and at the bench shape
   (bfloat16, the ``flash_block_bench`` line, beside
   ``scaled_dot_product_attention`` as a yardstick); its bound is the
   larger of 4·rows·sq·skv·d operations over the peak of the input dtype
   (67 TFLOP/s float32, 989 TFLOP/s bfloat16) and its bytes over 3.35
   TB/s.  The ``step_ms`` line is the host time of one training step
   ending in a sync (median and quartiles of 12 steps each), with K21 and
   with ``use_flash=False`` in turns; ``step_profile`` traces one step of
   each with ``torch.profiler`` (device time by kernel, idle share).
   K20's rows (float32, the MoE path's dtype, in the kernels line; bfloat16
   in a ``fused_matmul_bf16`` line, each row with its phase-2 band) at
   the Mixtral shape, beside
   ``torch.einsum("nmk,nko->mo")``, median of 25 calls or of 5 where one
   call takes over 50 ms; bound by operations, 2·M·K·N over the peak of
   the dtype.

Prints one JSON line per kernel, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Needs one card; with none it exits 1
before printing anything.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MB = 1 << 20
N = 8                      # virtual ranks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
REPS, WARMUP = 25, 3
SPIN_CYCLES = 100_000_000  # ~50 ms of device spin before timed calls
HOST_CALLS = 200
SEED = 1234

#: per kernel: route, source, the TPU kernel it replaces (def line)
KERNELS = {
    "reduce_stack": ("triton", "ompi_tpu_torch/ops/reduce.py",
                     "ompi_tpu/ops/pallas_reduce.py:111"),
    "combine2": ("triton", "ompi_tpu_torch/ops/reduce.py",
                 "ompi_tpu/ops/pallas_reduce.py:82"),
    "all_reduce_fused": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                         "ompi_tpu/ops/pallas_collectives.py:361"),
    "all_reduce_seg": ("cuda", "ompi_tpu_torch/csrc/ring_seg.cu",
                       "ompi_tpu/ops/pallas_collectives.py:674"),
    "reduce_scatter_fused": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                             "ompi_tpu/ops/pallas_collectives.py:502"),
    "reduce_scatter_seg": ("cuda", "ompi_tpu_torch/csrc/ring_seg.cu",
                           "ompi_tpu/ops/pallas_collectives.py:744"),
    "all_gather": ("cuda", "ompi_tpu_torch/csrc/ring_copy.cu",
                   "ompi_tpu/ops/pallas_collectives.py:177"),
    "bcast": ("cuda", "ompi_tpu_torch/csrc/ring_copy.cu",
              "ompi_tpu/ops/pallas_collectives.py:1294"),
    "right_permute": ("cuda", "ompi_tpu_torch/csrc/ring_copy.cu",
                      "ompi_tpu/ops/pallas_collectives.py:141"),
    "all_to_all": ("cuda", "ompi_tpu_torch/csrc/exchange.cu",
                   "ompi_tpu/ops/pallas_collectives.py:1050"),
    "all_to_all_v": ("cuda", "ompi_tpu_torch/csrc/exchange.cu",
                     "ompi_tpu/ops/pallas_collectives.py:1105"),
    "all_gather_v": ("cuda", "ompi_tpu_torch/csrc/exchange.cu",
                     "ompi_tpu/ops/pallas_collectives.py:1204"),
    "encode_int8": ("triton", "ompi_tpu_torch/ops/quant.py",
                    "ompi_tpu/ops/pallas_quant.py:77"),
    "dequant_accumulate": ("triton", "ompi_tpu_torch/ops/quant.py",
                           "ompi_tpu/ops/pallas_quant.py:106"),
    "decode_int8": ("triton", "ompi_tpu_torch/ops/quant.py",
                    "ompi_tpu/ops/pallas_quant.py:139"),
    "all_reduce_wire16": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                          "ompi_tpu/ops/pallas_collectives.py:425"),
    "reduce_scatter_wire16": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                              "ompi_tpu/ops/pallas_collectives.py:502"),
    "flash_block": ("cuda", "ompi_tpu_torch/csrc/flash_block.cu",
                    "ompi_tpu/ops/flash_attention.py:135"),
    "all_reduce_bidi": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                        "ompi_tpu/ops/pallas_collectives.py:961"),
    "all_reduce_seg_bidi": ("cuda", "ompi_tpu_torch/csrc/ring_seg.cu",
                            "ompi_tpu/ops/pallas_collectives.py:850"),
    "all_gather_bidi": ("cuda", "ompi_tpu_torch/csrc/ring_copy.cu",
                        "ompi_tpu/ops/pallas_collectives.py:226"),
    "matmul_allreduce": ("cuda", "ompi_tpu_torch/csrc/fused_matmul.cu",
                         "ompi_tpu/ops/pallas_overlap.py:57"),
    "matmul_reduce_scatter": ("cuda", "ompi_tpu_torch/csrc/fused_matmul.cu",
                              "ompi_tpu/ops/pallas_overlap.py:57"),
}
#: the kernels of the training path and of the MoE path; every other one
#: is on the collectives'
TRAINING_KERNELS = ("flash_block",)
MOE_KERNELS = ("matmul_allreduce", "matmul_reduce_scatter")
SEG = 512 * 1024 // 4      # seg_bytes (512k) in float32 elements

# the MoE dispatch slab: Mixtral-8x7B's expert layer (hidden 4096, 8
# experts, top-2), 4096 tokens per rank, capacity factor 1.25
HIDDEN, EXPERTS, TOP_K, TOKENS = 4096, 8, 2, 4096
CAPACITY = -(-5 * TOKENS * TOP_K // (4 * EXPERTS))    # ceil(1.25·T·k/E) = 1280
# K20 at Mixtral-8x7B's expert down projection: w2 (14336 -> 4096) split
# over the 8 ranks along its hidden units, applied to the expert's capacity
# buffer of 8 source ranks x CAPACITY rows: a (8, 10240, 1792), b (8, 1792,
# 4096); and 3 rows fewer, so the last block is padded
FFN = 14336
K20_M, K20_K = N * CAPACITY, FFN // N
K20_BANDS = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# bfloat16 also within the schedule's roundings: each of the n partials and
# each fold rounds once, half an ulp (2^-8 relative) of at most max|C| each
K20_BF16_FOLD_BAND = (N + 1) * 2.0 ** -8
MOE_BUDGET = "0.02"
ROT = tuple((i, (i + 1) % N) for i in range(N))       # the +1 rotation
GENERAL = tuple((i, (i + 2) % N) for i in range(N - 1))   # rank 1: no source


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def launch_tables() -> tuple:
    from ompi_tpu_torch.ops import (flash_attention, overlap, quant, reduce,
                                    ring_collectives)

    return (reduce.launches, ring_collectives.launches, quant.launches,
            flash_attention.launches, overlap.launches)


def counts():
    return {k: v for table in launch_tables() for k, v in table.items()}


def reset_counts() -> None:
    for table in launch_tables():
        for k in table:
            table[k] = 0


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype == torch.bool:
        return float((got != want).sum().item())
    return float((got.double() - want.double()).abs().max().item())


def same_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    require(torch.equal(got, want),
            f"{what}: kernel differs from plain version, max abs err "
            f"{max_abs_err(got, want)}")


def same_bits_nan(got: torch.Tensor, want: torch.Tensor, what: str) -> bool:
    """Bit for bit outside NaN, and NaN at the same places (a NaN's payload
    carries no value); returns whether the NaN bits agree as well."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    if not got.is_floating_point():
        same_bits(got, want, what)
        return True
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), f"{what}: NaN at other places")
    same_bits(got[~nan], want[~nan], what)
    return torch.equal(got[nan].view(torch.int32), want[nan].view(torch.int32))


def same_bytes(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Byte-for-byte equality (NaN and -0.0 included): the copies' check."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    require(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
            f"{what}: bytes differ from the plain version")


def valid_rows(out: torch.Tensor, counts) -> list:
    """The valid rows of a ragged result, pair by pair: ``out[j, i,
    :c[i, j]]`` for an (n, n) table, ``out[i, :c[i]]`` for an (n,) one, the
    counts clamped to [0, R]."""
    c = np.clip(np.asarray(counts), 0, out.shape[-2])
    if c.ndim == 2:
        return [out[j, i, :c[i, j]] for i in range(N) for j in range(N)]
    return [out[i, :c[i]] for i in range(N)]


def same_valid_bytes(got: torch.Tensor, want: torch.Tensor, counts,
                     what: str) -> None:
    """Byte-for-byte equality over the valid rows (the rest is
    unspecified)."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    for g, w in zip(valid_rows(got, counts), valid_rows(want, counts)):
        require(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                f"{what}: bytes of the valid rows differ")


def ragged_err(got: torch.Tensor, want: torch.Tensor, counts) -> float:
    return max((max_abs_err(g, w) for g, w in
                zip(valid_rows(got, counts), valid_rows(want, counts))
                if g.numel()), default=0.0)


def moe_counts() -> np.ndarray:
    """(n, n) rows rank i sends expert j (on rank j): each rank routes
    TOKENS tokens to TOP_K distinct experts, popularity skewed (Zipf,
    exponent 0.7) and sampled without replacement by Gumbel top-k; each
    count clamped to CAPACITY."""
    rng = np.random.default_rng(SEED)
    scores = (-0.7 * np.log(np.arange(1, EXPERTS + 1))
              + rng.gumbel(size=(N, TOKENS, EXPERTS)))
    top = np.argsort(-scores, axis=-1)[..., :TOP_K]
    sent = np.stack([np.bincount(t.ravel(), minlength=EXPERTS) for t in top])
    return np.minimum(sent, CAPACITY)


def moe_slab(gen) -> torch.Tensor:
    """The (8, 8, R, HIDDEN) float32 dispatch slab, 160 MB per rank."""
    return operands(torch.float32, (N, N, CAPACITY, HIDDEN), gen)


def permuted(x: torch.Tensor, perm) -> torch.Tensor:
    """lax.ppermute's result: out[d] = x[s], zeros where no pair lands."""
    want = torch.zeros_like(x)
    for s, d in perm:
        want[d] = x[s]
    return want


def rs_operands(per_rank: int, gen) -> torch.Tensor:
    """(n, n, S) float32 reduce-scatter input of ``per_rank`` bytes a rank."""
    return operands(torch.float32, (N, N, per_rank // 4 // N), gen)


def operands(dtype, shape, gen) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, device="cuda", generator=gen).bool()
    if not dtype.is_floating_point:
        return torch.randint(-40, 41, shape, device="cuda", generator=gen).to(dtype)
    # near 1, so PROD over 8 ranks stays finite and normal
    return 1.0 + 0.05 * torch.randn(shape, device="cuda", generator=gen, dtype=dtype)


# -- phase 2: kernels against their plain versions ----------------------

def check_kernels(gen) -> dict:
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc

    err = {}
    elems = 16 * MB // 4
    for dtype in (torch.float32, torch.int32, torch.int8, torch.bool):
        a = operands(dtype, (elems,), gen)
        b = operands(dtype, (elems,), gen)
        x = operands(dtype, (N, elems), gen)
        for op in reduce.supported_ops():
            if reduce.device_fold(op, dtype) is None:
                continue
            same_bits(reduce.combine2(op, a, b), reduce.combine2_plain(op, a, b),
                      f"K2 combine2 {op} {dtype}")
            same_bits(reduce.reduce_stack(op, x), reduce.reduce_stack_plain(op, x),
                      f"K1 reduce_stack {op} {dtype}")
        del a, b, x
    log("K2 combine2: every op on float32/int32/int8/bool, 16 MB: bit-exact")
    log("K1 reduce_stack: k=8, every op on float32/int32/int8/bool, 16 MB "
        "slices: bit-exact")
    err["combine2"] = err["reduce_stack"] = 0.0
    for name, variant, per_rank in (("all_reduce_fused", "fused", 4 * MB),
                                    ("all_reduce_seg", "seg", 16 * MB)):
        x = operands(torch.float32, (N, per_rank // 4), gen)
        seg = SEG if variant == "seg" else None
        for op in ("sum", "max", "min", "prod"):
            plain = (rc.all_reduce_seg_plain(x, N, op, seg) if variant == "seg"
                     else rc.all_reduce_fused_plain(x, N, op))
            same_bits(rc.all_reduce(x, N, op, variant, seg), plain,
                      f"{name} {op} float32 {per_rank // MB} MB/rank")
        err[name] = 0.0
        log(f"{name}: float32 sum/max/min/prod at {per_rank // MB} MB per "
            "rank: bit-exact")
        del x
    for name, variant, per_rank in (("reduce_scatter_fused", "fused", 4 * MB),
                                    ("reduce_scatter_seg", "seg", 16 * MB)):
        x = rs_operands(per_rank, gen)
        seg = SEG if variant == "seg" else None
        for op in ("sum", "max", "min", "prod"):
            same_bits(rc.reduce_scatter(x, N, op, variant, seg),
                      rc.reduce_scatter_plain(x, N, op),
                      f"{name} {op} float32 {per_rank // MB} MB/rank")
        err[name] = 0.0
        log(f"{name}: float32 sum/max/min/prod on {tuple(x.shape)}, "
            f"{per_rank // MB} MB per rank: bit-exact")
        del x
    # ragged ring blocks: a 16-byte pack would straddle two blocks, so the
    # wrapper must take the element path (and the packed one for blocks of
    # whole packs)
    for dtype in (torch.float32, torch.float16):
        for payload in ((3, 5), (1001,), (1024,)):
            x = operands(dtype, (N, N, *payload), gen)
            for variant in ("fused", "seg"):
                for op in ("sum", "max", "min", "prod"):
                    same_bits(rc.reduce_scatter(x, N, op, variant),
                              rc.reduce_scatter_plain(x, N, op),
                              f"reduce_scatter {variant} {op} {dtype} S={payload}")
    log("reduce_scatter_fused/seg: ragged blocks S=(3, 5), (1001,) and "
        "(1024,), float32 and float16, every op: bit-exact")

    x = operands(torch.float32, (N, 16 * MB // 4), gen)
    same_bytes(rc.all_gather(x, N), rc.all_gather_plain(x, N),
               "all_gather float32 16 MB/rank")
    odd = operands(torch.int8, (N, 1001), gen)
    same_bytes(rc.all_gather(odd, N), rc.all_gather_plain(odd, N),
               "all_gather int8 1001 B/rank")
    skew = operands(torch.int8, (N * 1001 + 1,), gen)[1:].view(N, 1001)
    require(skew.data_ptr() % 16 != 0, "the skewed view is aligned")
    same_bytes(rc.all_gather(skew, N), rc.all_gather_plain(skew, N),
               "all_gather int8 unaligned")
    err["all_gather"] = 0.0
    log("all_gather: float32 16 MB per rank, int8 1001 B per rank, an "
        "unaligned int8 view: byte-exact")

    x[3, :4] = torch.tensor([-0.0, float("nan"), -0.0, float("-inf")],
                            device="cuda")
    for root in (0, 3, 7):
        same_bytes(rc.bcast(x, N, root), rc.bcast_plain(x, N, root),
                   f"bcast float32 16 MB/rank root {root}")
    require(bool(torch.signbit(rc.bcast(x, N, 3)[:, 0]).all()),
            "bcast lost root's -0.0")
    for dtype, per in ((torch.int32, 1000), (torch.int8, 1001),
                       (torch.bool, 37), (torch.bfloat16, 24)):
        y = operands(dtype, (N, per), gen)
        same_bytes(rc.bcast(y, N, 5), rc.bcast_plain(y, N, 5),
                   f"bcast {dtype} {per}")
    err["bcast"] = 0.0
    log("bcast: roots 0/3/7 float32 16 MB per rank (-0.0, NaN in root 3's "
        "row), int32, int8 of odd length, bool, bfloat16: byte-exact")

    same_bytes(rc.right_permute(x, N), rc.right_permute_plain(x, N),
               "right_permute float32 16 MB/rank")
    odd = operands(torch.float16, (N, 1001), gen)
    same_bytes(rc.right_permute(odd, N), rc.right_permute_plain(odd, N),
               "right_permute float16 1001/rank")
    skew = operands(torch.float16, (N * 1001 + 1,), gen)[1:].view(N, 1001)
    require(skew.data_ptr() % 16 != 0, "the skewed view is aligned")
    same_bytes(rc.right_permute(skew, N), rc.right_permute_plain(skew, N),
               "right_permute float16 unaligned")
    err["right_permute"] = 0.0
    log("right_permute: float32 16 MB per rank, float16 1001 per rank, an "
        "unaligned float16 view: byte-exact")
    del x

    for dtype, shape in ((torch.float32, (N, N, 524288)),
                         (torch.int8, (N, N, 1001)), (torch.bool, (N, N, 37))):
        a = operands(dtype, shape, gen)
        same_bytes(rc.all_to_all(a, N), rc.all_to_all_plain(a, N),
                   f"all_to_all {dtype} {shape}")
    err["all_to_all"] = 0.0
    log("all_to_all: (8, 8, 524288) float32 (16 MB per rank), int8 blocks of "
        "1001 bytes, bool: byte-exact")
    del a

    moe, routed = moe_slab(gen), moe_counts()
    edge = routed.copy()
    edge[0, :4] = (0, CAPACITY, CAPACITY + 5, -3)
    for what, x, table in (("MoE routing", moe, routed),
                           ("counts 0/R/R+5/-3", moe, edge),
                           ("int32 slab", moe.view(torch.int32), routed)):
        same_valid_bytes(rc.all_to_all_v(x, table, N),
                         rc.all_to_all_v_plain(x, table, N), table,
                         f"all_to_all_v {what}")
    del moe
    odd_r = operands(torch.float32, (N, N, 1001, 128), gen)
    table = np.minimum(routed, 1001)
    same_valid_bytes(rc.all_to_all_v(odd_r, table, N),
                     rc.all_to_all_v_plain(odd_r, table, N), table,
                     "all_to_all_v R = 1001")
    err["all_to_all_v"] = 0.0
    log(f"all_to_all_v: the MoE slab (8, 8, {CAPACITY}, {HIDDEN}) float32 with "
        f"its routing (valid share {routed.sum() / (N * N * CAPACITY):.3f}), "
        "counts 0/R/R+5/-3, the slab as int32, R = 1001: byte-exact over the "
        "valid rows")
    del odd_r

    y = operands(torch.float32, (N, CAPACITY, HIDDEN), gen)
    for what, x, table in (("routing", y, routed[0]),
                           ("counts 0 and R", y, [0, CAPACITY] * (N // 2)),
                           ("bfloat16", y.bfloat16(), routed[1])):
        same_valid_bytes(rc.all_gather_v(x, table, N),
                         rc.all_gather_v_plain(x, table, N), table,
                         f"all_gather_v {what}")
    err["all_gather_v"] = 0.0
    log(f"all_gather_v: (8, {CAPACITY}, {HIDDEN}) float32 with ragged counts, "
        "counts 0 and R, bfloat16: byte-exact over the valid rows")
    del y
    check_codec_kernels(gen, err)
    check_wire16_kernels(gen, err)
    check_flash_kernel(gen, err)
    check_duplex_kernels(gen, err)
    check_torus(gen)
    check_fused_matmul(gen, err)
    torch.cuda.synchronize()
    return err


def codec_operands(k: int, size: int, gen) -> torch.Tensor:
    """(k, size) float32 on the card: normal values, and on ranks 0-3 an
    all-zero block, a block of exact .5 ties (amax 127, so 127/amax is 1),
    a block holding NaN and one holding +inf and -inf."""
    x = torch.randn((k, size), device="cuda", generator=gen)
    ties = torch.arange(128, device="cuda", dtype=torch.float32) - 63.5
    ties[0] = 127.0
    x[0, :128] = 0.0
    x[1 % k, 128:256] = ties
    x[2 % k, 256 + 17] = float("nan")
    x[3 % k, 384 + 3], x[3 % k, 384 + 90] = float("inf"), float("-inf")
    return x


def check_codec_kernels(gen, err: dict) -> None:
    """K17, K18 and K19 against their plain versions, bit for bit (NaN as
    NaN), with the special blocks of ``codec_operands``."""
    from ompi_tpu_torch.ops import quant as qo

    nan_bits = True
    for size in (16 * MB // 4, 70001):
        x = codec_operands(N, size, gen)
        q, s = qo.encode_int8(x)
        pq, ps = qo.encode_int8_plain(x)
        same_bits(q, pq, f"encode_int8 q, 8 x {size}")
        nan_bits &= same_bits_nan(s, ps, f"encode_int8 s, 8 x {size}")
        require(bool(torch.isnan(s[2, 2])) and bool(torch.isinf(s[3, 3]))
                and not bool(q[2, 2].any() or q[3, 3].any() or q[0, 0].any()),
                "encode_int8: the NaN, inf and zero blocks")
        require(q[1, 1, 60:68].tolist() == [-4, -2, -2, 0, 0, 2, 2, 4],
                "encode_int8: .5 ties are not rounded to even")
        nan_bits &= same_bits_nan(qo.decode_int8(q, s),
                                  qo.decode_int8_plain(q, s),
                                  f"decode_int8, 8 x {size}")
        for k in (2, 8):
            nan_bits &= same_bits_nan(
                qo.dequant_accumulate(q[:k], s[:k]),
                qo.dequant_accumulate_plain(q[:k], s[:k]),
                f"dequant_accumulate k={k}, {size}")
        del x, q, s, pq, ps
    err["encode_int8"] = err["dequant_accumulate"] = err["decode_int8"] = 0.0
    log("encode_int8/decode_int8/dequant_accumulate (k = 2, 8): 8 x 16 MB and "
        "8 x 70001 float32 with zero, .5-tie, NaN and inf blocks: bit-exact "
        f"(NaN at the same places; NaN bits {'equal' if nan_bits else 'differ'})")


def check_wire16_kernels(gen, err: dict) -> None:
    """K7 and K5's wire16 form against their plain versions, bit for bit."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    for per in (4 * MB // 4, 23, 1000):
        x = operands(torch.float32, (N, per), gen)
        for op in ("sum", "max", "min", "prod"):
            same_bits(rc.all_reduce(x, N, op, "wire16"),
                      rc.all_reduce_wire16_plain(x, N, op),
                      f"all_reduce wire16 {op} 8 x {per}")
    for payload in ((131072,), (23,), (5, 200)):
        x = operands(torch.float32, (N, N, *payload), gen)
        for op in ("sum", "max"):
            same_bits(rc.reduce_scatter(x, N, op, "wire16"),
                      rc.reduce_scatter_wire16_plain(x, N, op),
                      f"reduce_scatter wire16 {op} S={payload}")
    err["all_reduce_wire16"] = err["reduce_scatter_wire16"] = 0.0
    log("all_reduce wire16 (K7): sum/max/min/prod at 4 MB, 23 and 1000 "
        "elements per rank; reduce_scatter wire16: sum/max on (8, 8, 131072), "
        "S = (23,) and (5, 200): bit-exact")


def check_duplex_kernels(gen, err: dict) -> None:
    """K8, K9 and K11 against their plain versions, bit for bit (K11 byte
    for byte)."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    plain = {"bidi": rc.all_reduce_bidi_plain,
             "seg_bidi": rc.all_reduce_seg_bidi_plain}
    for variant, per_rank, seg in (("bidi", 4 * MB, None),
                                   ("seg_bidi", 16 * MB, SEG)):
        x = operands(torch.float32, (N, per_rank // 4), gen)
        for op in ("sum", "max", "min", "prod"):
            same_bits(rc.all_reduce(x, N, op, variant, seg),
                      plain[variant](x, N, op, *([seg] if seg else [])),
                      f"all_reduce {variant} {op} float32 {per_rank // MB} MB/rank")
        del x
    for dtype in (torch.float16, torch.float32, torch.float64):
        for per in (23, 407, 999):
            base = operands(dtype, (N * per + 1,), gen)
            for x in (base[:-1].view(N, per), base[1:].view(N, per)):
                for op in ("sum", "max", "min", "prod"):
                    for variant, seg in (("bidi", None), ("seg_bidi", 32)):
                        same_bits(rc.all_reduce(x, N, op, variant, seg),
                                  plain[variant](x, N, op, *([seg] if seg else [])),
                                  f"all_reduce {variant} {op} {dtype} 8 x {per} "
                                  f"(pointer % 16 = {x.data_ptr() % 16})")
    err["all_reduce_bidi"] = err["all_reduce_seg_bidi"] = 0.0
    log("all_reduce bidi (K8) at 4 MB and seg_bidi (K9) at 16 MB per rank, "
        "float32, every op; both on 23, 407 and 999 elements per rank, "
        "float16/32/64, every op, aligned and unaligned: bit-exact")
    x = operands(torch.float32, (N, 16 * MB // 4), gen)
    odd = operands(torch.int8, (N * 1001 + 1,), gen)
    five = operands(torch.float32, (5, 1001), gen)
    for what, t, n in (("float32 16 MB/rank", x, N),
                       ("int8 1001 B/rank", odd[:-1].view(N, 1001), N),
                       ("int8 unaligned", odd[1:].view(N, 1001), N),
                       ("n = 5 float32 1001/rank", five, 5)):
        same_bytes(rc.all_gather(t, n, "bidi"), rc.all_gather_plain(t, n),
                   f"all_gather bidi {what}")
    err["all_gather_bidi"] = 0.0
    log("all_gather bidi (K11): float32 16 MB per rank, int8 1001 B per rank "
        "aligned and not, n = 5: byte-exact")


def check_torus(gen) -> None:
    """The torus schedules (a sub-ring launch of K5, then one of K3 or K5)
    against their plain composition, bit for bit, on (2, 4) and (4, 2)."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    for n0, n1 in ((2, 4), (4, 2)):
        for dtype, per in ((torch.float32, 1000), (torch.float16, 1000),
                           (torch.float32, 4 * MB // 4)):
            x = operands(dtype, (n0, n1, per), gen)
            for op in ("sum", "max", "min", "prod"):
                same_bits(rc.all_reduce_torus(x, n0, n1, op),
                          rc.all_reduce_torus_plain(x, n0, n1, op),
                          f"all_reduce_torus ({n0}, {n1}) {op} {dtype} {per}")
            same_bytes(rc.all_gather_torus(x.view(N, per), n0, n1),
                       x.view(N, per), f"all_gather_torus ({n0}, {n1})")
        for dtype, per in ((torch.float32, 200), (torch.float16, 200),
                           (torch.float32, 131072)):
            y = operands(dtype, (N, N, per), gen)
            for op in ("sum", "max"):
                same_bits(rc.reduce_scatter_torus(y, n0, n1, op),
                          rc.reduce_scatter_torus_plain(y, n0, n1, op),
                          f"reduce_scatter_torus ({n0}, {n1}) {op} {dtype} {per}")
    log("torus schedules on (2, 4) and (4, 2): all_reduce_torus (float32 and "
        "float16 1000 per rank, float32 4 MB per rank, every op), "
        "reduce_scatter_torus (200 and 131072 per block, sum and max), "
        "all_gather_torus: bit-exact with the plain composition")


def k20_operands(dtype, m: int, kind: str, gen) -> tuple:
    """a (8, m, 1792) and b (8, 1792, 4096) on the card: integers in [-4, 4]
    (every float32 partial exact, |partial| <= 1792·16; past 256, so the
    bfloat16 partials and folds round), or normal values."""
    if kind == "int":
        a = torch.randint(-4, 5, (N, m, K20_K), device="cuda", generator=gen)
        b = torch.randint(-4, 5, (N, K20_K, HIDDEN), device="cuda", generator=gen)
    else:
        a = torch.randn((N, m, K20_K), device="cuda", generator=gen)
        b = torch.randn((N, K20_K, HIDDEN), device="cuda", generator=gen)
    return a.to(dtype), b.to(dtype)


def k20_scale(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest Σ|a||b| of an output element: the bands' unit."""
    return torch.einsum("nmk,nko->mo", a.abs().float(),
                        b.abs().float()).max().item()


def k20_band(want: torch.Tensor, scale: float) -> float:
    """K20's band around ``want``: K20_BANDS[dtype]·scale, and in bfloat16
    no more than K20_BF16_FOLD_BAND·max|want|."""
    band = K20_BANDS[want.dtype] * scale
    if want.dtype == torch.bfloat16:
        band = min(band, K20_BF16_FOLD_BAND * want.float().abs().max().item())
    return band


def check_k20_band(got, want, scale: float, what: str) -> tuple:
    """``got`` within :func:`k20_band` of ``want``, finite; returns the max
    abs error and the band."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    e, band = max_abs_err(got, want), k20_band(want, scale)
    require(e <= band, f"{what}: max abs err {e} above the band {band}")
    return e, band


def check_fused_matmul(gen, err: dict) -> None:
    """K20 (both forms) against its plain version at the Mixtral expert
    shape and at M = 10237 (a padded last block), float32 and bfloat16:
    bit for bit on integer-valued inputs, on normal ones within 1e-5
    (float32) and 2^-7 (bfloat16) of the largest Σ|a||b|, and bfloat16
    within (n + 1)·2^-8 of max|C| as well.  ``err`` gets each form's max
    abs error and, for bfloat16, its band (``<key>_band``)."""
    from ompi_tpu_torch.ops import overlap

    forms = {"matmul_allreduce": (overlap.matmul_allreduce,
                                  overlap.matmul_allreduce_plain),
             "matmul_reduce_scatter": (overlap.matmul_reduce_scatter,
                                       overlap.matmul_reduce_scatter_plain)}
    rel = {}
    for dtype in (torch.float32, torch.bfloat16):
        for m in (K20_M, K20_M - 3):
            for kind in ("int", "random"):
                a, b = k20_operands(dtype, m, kind, gen)
                scale = k20_scale(a, b) if kind == "random" else 0.0
                for name, (kernel, plain) in forms.items():
                    got, want = kernel(a, b, N), plain(a, b, N)
                    what = f"{name} {dtype} M={m} {kind}"
                    if kind == "int":
                        same_bits(got, want, what)
                        continue
                    e, band = check_k20_band(got, want, scale, what)
                    key = name if dtype == torch.float32 else f"{name}_bf16"
                    err[key] = max(err.get(key, 0.0), e)
                    rel[key] = max(rel.get(key, 0.0), e / band)
                    if dtype == torch.bfloat16:
                        err[f"{key}_band"] = min(
                            err.get(f"{key}_band", math.inf), band)
                    del got, want
                del a, b
    # K/n and N off the multiples of 8: the bfloat16 kernel's element loads
    for dtype in (torch.float32, torch.bfloat16):
        ints = [torch.randint(-4, 5, shape, device="cuda", generator=gen).to(dtype)
                for shape in ((N, 1001, 37), (N, 37, 203))]
        for name, (kernel, plain) in forms.items():
            same_bits(kernel(*ints, N), plain(*ints, N),
                      f"{name} {dtype} (8, 1001, 37) x (8, 37, 203)")
    log(f"K20 matmul_allreduce/matmul_reduce_scatter: a (8, {K20_M}, {K20_K}) "
        f"and (8, {K20_M - 3}, {K20_K}), b (8, {K20_K}, {HIDDEN}), and a (8, "
        "1001, 37), b (8, 37, 203), float32 and "
        "bfloat16: bit-exact on integer inputs; on normal inputs max abs err "
        "over its band (float32: 1e-5 x the largest Σ|a||b|; bfloat16: the "
        f"smaller of 2^-7 x that and {N + 1} x 2^-8 x max|C|) "
        + json.dumps(rel))


#: K21's bands against its plain version, relative to the largest finite
#: magnitude of each output (the tests' bands)
FLASH_BANDS = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
#: the step's per-rank layout at OTPU_MODEL_SCALE=64 on the default mesh:
#: (dp, pp, sp, tp, b, h_local) = 32 rows, s_local 256, head dim 256
STEP_LEAD, STEP_S, STEP_D = (2, 1, 2, 2, 2, 2), 256, 256
#: the JAX package's bench shape of the flash block (bench.py:347):
#: (b, h, sq, skv, d) in bfloat16
BENCH_FLASH = (4, 8, 2048, 2048, 128)


def flash_close(got: tuple, want: tuple, dtype, what: str) -> tuple:
    """K21's (m, num, den) within its band of the plain version's: NaN at
    the same places, infinities equal; returns the largest absolute error
    over the finite values and the largest error relative to max |plain|
    of its output (what the band holds)."""
    worst = rel = 0.0
    for g, w, name in zip(got, want, ("m", "num", "den")):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what} {name}: {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        g, w = g.float(), w.float()
        require(torch.equal(torch.isnan(g), torch.isnan(w)),
                f"{what} {name}: NaN at other places")
        inf = torch.isinf(w)
        require(torch.equal(g[inf], w[inf]), f"{what} {name}: infinities differ")
        fin = torch.isfinite(w)
        if not bool(fin.any()):
            continue
        err = (g[fin] - w[fin]).abs().max().item()
        scale = w[fin].abs().max().item()
        require(err <= FLASH_BANDS[dtype] * scale,
                f"{what} {name}: {err / scale:.3e} of max |plain| above the "
                f"band {FLASH_BANDS[dtype]:g}")
        worst, rel = max(worst, err), max(rel, err / scale)
    return worst, rel


def flash_state(lead, sq, d, dtype, m_inf: bool, gen):
    """(m, num, den): the first ring step's (-inf, 0, 0), or a running
    state (den > 0)."""
    if m_inf:
        return (torch.full((*lead, sq), -float("inf"), device="cuda",
                           dtype=dtype),
                torch.zeros((*lead, sq, d), device="cuda", dtype=dtype),
                torch.zeros((*lead, sq), device="cuda", dtype=dtype))
    return (torch.randn((*lead, sq), device="cuda", generator=gen).to(dtype),
            torch.randn((*lead, sq, d), device="cuda", generator=gen).to(dtype),
            torch.rand((*lead, sq), device="cuda", generator=gen).to(dtype) + 1)


def ring_bias(t: int, dtype) -> torch.Tensor:
    """Ring attention's causal bias at step t on the step's mesh: one
    (s_local, s_local) block per sp rank, prefix (1, 1, sp, 1) — step 0
    the diagonal, step 1 fully masked on sp rank 0 and fully visible on
    rank 1 (as ``parallel/model.py`` builds it)."""
    sp = STEP_LEAD[2]
    my = torch.arange(sp, device="cuda").reshape(1, 1, sp, 1, 1, 1)
    rows = torch.arange(STEP_S, device="cuda")
    src = torch.remainder(my - t + sp, sp)
    keep = my * STEP_S + rows[:, None] >= src * STEP_S + rows[None, :]
    return torch.where(keep, 0.0, -float("inf")).to(dtype)


def check_flash_kernel(gen, err: dict) -> None:
    """K21 against update_plain on the card: float32 and bfloat16, at the
    step's shape unbiased and with the per-rank causal bias, from m = -inf
    and chained; a fully masked block (K21 leaves the state as it was); a
    fully masked row at m = -inf (NaN); a ragged sq = 200; the JAX bench's
    shape in bfloat16.  Records (abs, rel) errors for the kernels-line row
    (float32 at the step's shape) and for the bench line."""
    from ompi_tpu_torch.ops import flash_attention as fa

    def rnd(*shape, dtype):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    def worse(a, b):
        return max(a[0], b[0]), max(a[1], b[1])

    step, rest = (0.0, 0.0), (0.0, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(*STEP_LEAD, STEP_S, STEP_D, dtype=dtype)
        kv = [rnd(*STEP_LEAD, STEP_S, STEP_D, dtype=dtype) for _ in range(4)]
        for causal in (False, True):
            state = flash_state(STEP_LEAD, STEP_S, STEP_D, dtype, True, gen)
            for t in range(2):        # the two ring steps of sp = 2
                bias = ring_bias(t, dtype) if causal else None
                args = (q, kv[2 * t], kv[2 * t + 1], *state, bias)
                got = fa.update(*args)
                e = flash_close(got, fa.update_plain(*args), dtype,
                                f"K21 step shape {dtype} causal={causal} "
                                f"step {t}")
                if dtype == torch.float32:
                    step = worse(step, e)
                else:
                    rest = worse(rest, e)
                if causal and t == 1:  # sp rank 0's second block: all masked
                    require(all(torch.equal(g[:, :, 0], s[:, :, 0])
                                for g, s in zip(got, state)),
                            f"K21 {dtype}: a fully masked block moved the "
                            f"state")
                state = fa.update_plain(*args)
        lead, sq = (2, 2), 64
        q, k, v = (rnd(*lead, sq, 32, dtype=dtype) for _ in range(3))
        masked = torch.zeros((sq, sq), device="cuda", dtype=dtype)
        masked[:16] = -float("inf")                 # rows 0-15 see nothing
        args = (q, k, v, *flash_state(lead, sq, 32, dtype, True, gen), masked)
        got = fa.update(*args)
        rest = worse(rest, flash_close(got, fa.update_plain(*args), dtype,
                                       f"K21 masked {dtype}"))
        require(bool(torch.isnan(got[1][..., :16, :]).all())
                and not bool(torch.isnan(got[1][..., 16:, :]).any()),
                "K21: a fully masked row at m = -inf must give NaN, others not")
        q = rnd(2, 2, 200, 64, dtype=dtype)
        k, v = (rnd(2, 2, 200, 64, dtype=dtype) for _ in range(2))
        args = (q, k, v, *flash_state((2, 2), 200, 64, dtype, False, gen))
        rest = worse(rest, flash_close(fa.update(*args), fa.update_plain(*args),
                                       dtype, f"K21 ragged sq=200 {dtype}"))
    b, h, sq, skv, d = BENCH_FLASH
    q = rnd(b, h, sq, d, dtype=torch.bfloat16)
    k, v = (rnd(b, h, skv, d, dtype=torch.bfloat16) for _ in range(2))
    args = (q, k, v, *flash_state((b, h), sq, d, torch.bfloat16, True, gen))
    bench = flash_close(fa.update(*args), fa.update_plain(*args),
                        torch.bfloat16, "K21 bench shape")
    err["flash_block"], err["flash_block_bench"] = step, bench
    log("flash_block (K21): float32 and bfloat16 at the step's shape (32 "
        "rows, 256 x 256, d 256) unbiased and per-rank causal, from m = -inf "
        "and chained (a fully masked block leaves K21's state bit-equal), a "
        "fully masked row at m = -inf (NaN at the same places), ragged sq = "
        f"200, the bench shape {BENCH_FLASH} bfloat16: within 1e-6 (f32) / "
        f"2^-7 (bf16) of max |plain|; (abs, rel) err float32 step shape "
        f"{step[0]:.3e}, {step[1]:.3e}; bench {bench[0]:.3e}, "
        f"{bench[1]:.3e}; other cases {rest[0]:.3e}, {rest[1]:.3e}")


# -- phase 3: the main path ---------------------------------------------

def sum_tolerance(x: torch.Tensor) -> torch.Tensor:
    """|a - b| allowed between two float32 sums of the n rank rows taken in
    different orders: each order is within (n-1)·u·Σ|x_i| of the exact sum
    (u = 2**-24), so they differ by at most 2(n-1)·u·Σ|x_i|."""
    return 2 * (N - 1) * 2.0 ** -24 * x.abs().sum(0)


def check_sum(out, x, plain, what):
    same_bits(out, plain, f"{what} vs plain version")
    lib = torch.sum(x, 0)
    bad = ((out - lib).abs() > sum_tolerance(x)).sum().item()
    require(bad == 0, f"{what}: {bad} elements outside the torch.sum band")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite values")


def owner(world, slot: str) -> str:
    return type(world.c_coll[slot].__self__).__name__


def main_path(gen) -> dict:
    import ompi_tpu_torch
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.runtime import init as rt

    big = operands(torch.float32, (N, 16 * MB // 4), gen)       # 16 MB/rank
    mid = operands(torch.float32, (N, 4 * MB // 4), gen)        # 4 MB/rank
    ints = operands(torch.int32, (N, 16 * MB // 4), gen)
    inbuf = operands(torch.float32, (16 * MB // 4,), gen)
    inout = operands(torch.float32, (16 * MB // 4,), gen)
    inout_plain = reduce.combine2_plain("SUM", inbuf, inout)
    rs_mid = rs_operands(4 * MB, gen)                            # 4 MB/rank
    rs_big = rs_operands(16 * MB, gen)                           # 16 MB/rank
    a2a = operands(torch.float32, (N, N, 524288), gen)            # 16 MB/rank
    moe, routed = moe_slab(gen), moe_counts()
    agv = operands(torch.float32, (N, CAPACITY, HIDDEN), gen)
    agv_counts = routed[0]
    new_slots = ("bcast_array", "allgather_array", "reduce_scatter_array",
                 "alltoall_array", "alltoallv_array", "allgatherv_array",
                 "ppermute_array")
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    world = ompi_tpu_torch.init()
    require(world.size == N and world.rte.device.type == "cuda",
            f"world of {world.size} on {world.rte.device}")
    for slot in ("allreduce_array", *new_slots):
        require(owner(world, slot) == "BuiltinCollModule",
                f"default owner of {slot} is not coll/builtin")
    s_builtin = world.allreduce_array(big, ompi_tpu_torch.SUM)
    p_prod = world.allreduce_array(big, ompi_tpu_torch.PROD)
    p_band = world.allreduce_array(ints, ompi_tpu_torch.BAND)
    b_builtin = world.bcast_array(big, 3)
    g_builtin = world.allgather_array(big)
    rs_builtin = world.reduce_scatter_array(rs_mid, ompi_tpu_torch.SUM)
    k1_before = reduce.launches["reduce_stack"]
    rs_prod = world.reduce_scatter_array(rs_mid, ompi_tpu_torch.PROD)
    k1_rs = reduce.launches["reduce_stack"] - k1_before
    ompi_tpu_torch.reduce_local(inbuf, inout, ompi_tpu_torch.SUM)
    exchange = {"builtin": exchange_calls(world, big, a2a, moe, routed, agv,
                                          agv_counts)}
    codec = codec_calls(world, big)
    rt.finalize()

    os.environ["OTPU_MCA_coll_ring_priority"] = "95"
    world = ompi_tpu_torch.init()
    for slot in ("allreduce_array", *new_slots):
        require(owner(world, slot) == "RingCollModule",
                f"raised owner of {slot} is not coll/ring")
    s_fused = world.allreduce_array(mid, ompi_tpu_torch.SUM)
    s_seg = world.allreduce_array(big, ompi_tpu_torch.SUM)
    b_ring = world.bcast_array(big, 3)
    g_ring = world.allgather_array(big)
    rs_fused = world.reduce_scatter_array(rs_mid, ompi_tpu_torch.SUM)
    rs_seg = world.reduce_scatter_array(rs_big, ompi_tpu_torch.SUM)
    exchange["ring"] = exchange_calls(world, big, a2a, moe, routed, agv,
                                      agv_counts)
    rt.finalize()

    os.environ["OTPU_MCA_coll_ring_wire16"] = "1"
    world = ompi_tpu_torch.init()
    wire = wire16_calls(world, mid, big, rs_mid)
    rt.finalize()

    # an unset variable leaves a var as it was: wire16 is turned off by value
    os.environ["OTPU_MCA_coll_ring_wire16"] = "0"
    os.environ["OTPU_MCA_coll_ring_bidirectional"] = "1"
    world = ompi_tpu_torch.init()
    duplex = duplex_calls(world, mid, big, rs_mid, rs_big)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    rt.finalize()
    for name in ("priority", "wire16", "bidirectional"):
        del os.environ[f"OTPU_MCA_coll_ring_{name}"]

    log(f"main path: 4 x init, 2 x dup, 12 allreduce_array, 2 bcast_array, "
        f"5 allgather_array, 7 reduce_scatter_array, reduce_local, 2 x "
        f"(alltoall_array, alltoallv_array, allgatherv_array, 2 "
        f"ppermute_array), allreduce_array_init and 2 calls of its handle in "
        f"{wall:.3f} s (host clock, includes the first-call builds); "
        f"launches {launched}")
    for name in KERNELS:
        if name not in TRAINING_KERNELS + MOE_KERNELS:
            require(launched[name] > 0, f"{name} was not launched on the main path")
    require(k1_rs > 0, "reduce_scatter_array PROD did not launch K1")

    require(torch.equal(s_builtin, torch.sum(big, 0)), "builtin SUM")
    same_bits(p_prod, reduce.reduce_stack_plain("PROD", big), "PROD (K1)")
    same_bits(p_band, reduce.reduce_stack_plain("BAND", ints), "BAND (K1)")
    same_bits(inout, inout_plain, "reduce_local SUM (K2)")
    check_sum(s_fused, mid, rc.all_reduce_fused_plain(mid, N, "sum"),
              "ring SUM 4 MB/rank (K3)")
    check_sum(s_seg, big, rc.all_reduce_seg_plain(big, N, "sum", SEG),
              "ring SUM 16 MB/rank (K4)")
    row3 = rc.bcast_plain(big, N, 3)
    same_bytes(b_builtin, row3, "builtin bcast root 3")
    same_bytes(g_builtin, big, "builtin allgather")
    require(torch.equal(rs_builtin, torch.sum(rs_mid, 0)),
            "builtin reduce_scatter SUM")
    same_bits(rs_prod, reduce.reduce_stack_plain("PROD", rs_mid),
              "builtin reduce_scatter PROD (K1)")
    same_bytes(b_ring, row3, "ring bcast root 3 (K12)")
    same_bytes(g_ring, big, "ring allgather (K10)")
    check_sum(rs_fused, rs_mid, rc.reduce_scatter_plain(rs_mid, N, "sum"),
              "ring reduce_scatter SUM 4 MB/rank (K5)")
    check_sum(rs_seg, rs_big, rc.reduce_scatter_plain(rs_big, N, "sum"),
              "ring reduce_scatter SUM 16 MB/rank (K6)")
    require(exchange["ring"]["k13_general"] == 0,
            "the general perm launched K13 (it must go to coll/builtin)")
    plain = {"alltoall": rc.all_to_all_plain(a2a, N),
             "rotation": rc.right_permute_plain(big, N),
             "general": permuted(big, GENERAL)}
    require(not bool(plain["general"][1].any()), "rank 1 received data")
    want_v = rc.all_to_all_v_plain(moe, routed, N)
    for module, got in exchange.items():
        for name, want in plain.items():
            same_bytes(got[name], want, f"{module} {name}")
        for i in range(N):
            require(got["allgatherv"][i].shape[0] == agv_counts[i],
                    f"{module} allgatherv view {i}")
            same_bytes(got["allgatherv"][i], agv[i, :agv_counts[i]],
                       f"{module} allgatherv view {i}")
            for j in range(N):
                require(got["alltoallv"][i][j].shape[0] == routed[j, i],
                        f"{module} alltoallv view ({i}, {j})")
                same_bytes(got["alltoallv"][i][j], want_v[i, j, :routed[j, i]],
                           f"{module} alltoallv view ({i}, {j})")
    log("main path results: bit-exact with the plain versions (copies byte "
        "for byte, the ragged calls' views over their valid rows); ring SUM "
        "within 2(n-1)·2^-24·Σ|x| of torch.sum; the general perm's rank 1 "
        "holds zeros and left K13's count unchanged")
    check_codec_results(codec, big)
    check_wire16_results(wire, mid, big, rs_mid)
    check_duplex_results(duplex, mid, big, rs_mid, rs_big)
    return launched


#: the meshes of ``run_training_step`` on 8 ranks
STEP_MESHES = {"default": dict(dp=2, pp=1, sp=2, tp=2),
               "pp2": dict(dp=1, pp=2, sp=2, tp=2)}
#: at OTPU_MODEL_SCALE=64 the reference's lr (1e-4) overshoots: the first
#: loss is 1.07e6 (0.5·Σy² grows with the width, and so does its gradient)
#: and the second step's is higher; 1e-5 descends
STEP_LR = 1e-5


def k21_per_step(sizes: dict) -> int:
    """K21 launches of one step: one per ring step, (M + pp - 1)
    pipeline steps x layers_local blocks x sp ring steps; the backward
    recomputes through plain torch and launches none."""
    from ompi_tpu_torch.parallel import train
    from ompi_tpu_torch.parallel.mesh import MeshSpec

    dims = train.model_dims(MeshSpec(**sizes))
    return (dims["M"] + sizes["pp"] - 1) * dims["layers_local"] * sizes["sp"]


def training_path() -> dict:
    """The flagship training step at OTPU_MODEL_SCALE=64 on the card:
    ``run_training_step`` (two descending steps on the default mesh, two on
    the pp = 2 mesh) with every count set to 0 before and read after; then
    the exact K21 count of one step on each mesh and under remat, and the
    step with ``use_flash=False`` against the K21 step."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import dryrun, train
    from ompi_tpu_torch.parallel.mesh import MeshSpec

    per_step = {name: k21_per_step(s) for name, s in STEP_MESHES.items()}
    reset_counts()
    t0 = time.perf_counter()
    loss = dryrun.run_training_step(lr=STEP_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    want = 2 * per_step["default"] + 2 * per_step["pp2"]
    require(launched["flash_block"] == want,
            f"training path launched K21 {launched['flash_block']} times, "
            f"want {want}")
    require(np.isfinite(loss), f"training loss {loss}")
    scale = os.environ.get("OTPU_MODEL_SCALE", "1")
    log(f"training path: run_training_step(lr={STEP_LR}) at "
        f"OTPU_MODEL_SCALE={scale}, 2 steps "
        f"on {STEP_MESHES['default']} and 2 on {STEP_MESHES['pp2']}, loss "
        f"descending on both, in {wall:.3f} s (host clock, includes the "
        f"first-step set-up); K21 launches {launched['flash_block']} = 2 x "
        f"{per_step['default']} + 2 x {per_step['pp2']}")

    for name, sizes in STEP_MESHES.items():
        step, state, _ = dryrun.make_step_and_args(spec=MeshSpec(**sizes),
                                                   lr=STEP_LR)
        _, delta = launch_delta(lambda: step(*state))
        require(delta == {"flash_block": per_step[name]},
                f"one step on {name}: launches {delta}, want "
                f"{per_step[name]} of K21")
    remat = registry.lookup("otpu_parallel_remat")
    remat.set(True)
    try:
        step, state, _ = dryrun.make_step_and_args(lr=STEP_LR)
        _, delta = launch_delta(lambda: step(*state))
    finally:
        remat.set(False)
    require(delta == {"flash_block": 2 * per_step["default"]},
            f"one remat step: launches {delta}, want 2 x {per_step['default']}")

    step, state, _ = dryrun.make_step_and_args(lr=STEP_LR)
    plain_step, plain_state, _ = dryrun.make_step_and_args(use_flash=False,
                                                           lr=STEP_LR)
    (new, loss), (new_p, loss_p) = step(*state), plain_step(*plain_state)
    rel_loss = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    require(rel_loss <= 1e-5, f"use_flash=False loss differs by {rel_loss:.3e}")
    params = state[0]
    worst = 0.0
    for k in params:
        upd, upd_p = params[k] - new[k], params[k] - new_p[k]
        rel = ((upd - upd_p).abs().max() / upd_p.abs().max()).item()
        worst = max(worst, rel)
        require(rel <= 1e-4, f"use_flash=False update of {k} differs by {rel:.3e}")
    log(f"training step with use_flash=False on the card: loss within "
        f"{rel_loss:.3e} (band 1e-5), each leaf's update within {worst:.3e} "
        f"of its largest magnitude (band 1e-4) of the K21 step; K21 per step "
        f"{per_step['default']} (default mesh), {per_step['pp2']} (pp = 2), "
        f"{2 * per_step['default']} under remat: exact")
    variants = {"K21": (step, state),
                "use_flash=False": (plain_step, plain_state)}
    times = step_ms(variants)
    log(json.dumps({"step_ms": {**times, "mesh": STEP_MESHES["default"],
                                "scale": int(scale), "layers": 1}}))
    log(json.dumps({"step_profile": {what: step_profile(*v)
                                     for what, v in variants.items()}}))
    return {"flash_block": launched["flash_block"], "step_ms": times}


def moe_path(gen) -> dict:
    """The MoE device tier on the card, with every count set to 0 before
    and read after: on a world with coll/ring raised, ``expert_ffn_fused``
    at the Mixtral expert shape (float32) through coll/tuned's cell (K20's
    all-reduce form once); with ``otpu_coll_tuned_fused_cells`` forcing the
    reduce-scatter cell, ``expert_ffn_fused`` takes its unfused einsum (no
    K20) and that cell itself (K20's reduce-scatter form once);
    ``dispatch_tokens`` on the MoE dispatch slab without a budget and on a
    dup with ``otpu_quant_budget`` 0.02 (the int32 slab; K15 once each);
    ``run_moe_training_step`` on (dp=2, ep=4).  Exact counts; results held
    against the plain versions and, for the step, a CPU run."""
    import ompi_tpu_torch
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.mca.coll import tuned
    from ompi_tpu_torch.ops import overlap
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.parallel import moe
    from ompi_tpu_torch.runtime import init as rt

    a, b = k20_operands(torch.float32, K20_M, "random", gen)
    x, routed = moe_slab(gen), moe_counts()
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    os.environ["OTPU_MCA_coll_ring_priority"] = "95"
    world = ompi_tpu_torch.init()
    require(owner(world, "alltoallv_array") == "RingCollModule",
            "raised owner of alltoallv_array is not coll/ring")
    fused, d_fused = launch_delta(lambda: moe.expert_ffn_fused(a, b))
    var = registry.lookup("otpu_coll_tuned_fused_cells")
    var.set("matmul_reduce_scatter")
    try:
        unfused, d_unfused = launch_delta(lambda: moe.expert_ffn_fused(a, b))
        cell = tuned.device_cell("matmul_reduce_scatter")
        rs, d_rs = launch_delta(lambda: cell(a, b, N))
    finally:
        var.set("")
    (raw, codec_raw), d_raw = launch_delta(
        lambda: moe.dispatch_tokens(world, x, routed))
    budgeted = world.dup()
    budgeted.info.set("otpu_quant_budget", MOE_BUDGET)
    (packed, codec_packed), d_packed = launch_delta(
        lambda: moe.dispatch_tokens(budgeted, x, routed))
    losses = moe.run_moe_training_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    rt.finalize()
    del os.environ["OTPU_MCA_coll_ring_priority"]

    log(f"MoE path: init (coll/ring raised), expert_ffn_fused twice, the "
        f"reduce-scatter cell, dispatch_tokens twice, run_moe_training_step "
        f"in {wall:.3f} s (host clock, includes the first-call set-up); "
        f"launches {dict((k, v) for k, v in launched.items() if v)}")
    require(d_fused == {"matmul_allreduce": 1},
            f"expert_ffn_fused launched {d_fused}, want K20 (allreduce) once")
    require(d_unfused == {}, f"forced to the reduce-scatter cell, "
            f"expert_ffn_fused launched {d_unfused}, want nothing")
    require(d_rs == {"matmul_reduce_scatter": 1},
            f"the reduce-scatter cell launched {d_rs}, want K20 once")
    require(d_raw == {"all_to_all_v": 1} and d_packed == {"all_to_all_v": 1},
            f"dispatch_tokens launched {d_raw} and {d_packed}, want K15 once each")
    require({k: v for k, v in launched.items() if v} ==
            {"matmul_allreduce": 1, "matmul_reduce_scatter": 1,
             "all_to_all_v": 2}, f"MoE path launches {launched}")

    scale = k20_scale(a, b)
    plain = overlap.matmul_allreduce_plain(a, b, N)
    e_fused, _ = check_k20_band(fused, plain, scale,
                                "expert_ffn_fused vs plain")
    check_k20_band(unfused, plain, scale,
                   "unfused einsum vs K20's plain version")
    check_k20_band(rs, overlap.matmul_reduce_scatter_plain(a, b, N),
                   scale, "reduce-scatter cell vs plain")
    del plain
    require(codec_raw is None and codec_packed == "int8",
            f"codecs {codec_raw}, {codec_packed}")
    want_raw = rc.all_to_all_v_plain(x, routed, N)
    want_packed = moe.decode_dispatch_int8(rc.all_to_all_v_plain(
        moe.encode_dispatch_int8(x), routed, N), HIDDEN)
    worst = 0.0
    for i in range(N):
        for j in range(N):
            c = int(routed[j, i])
            same_bytes(raw[i][j], want_raw[i, j, :c], f"dispatch ({i}, {j})")
            same_bits(packed[i][j], want_packed[i, j, :c],
                      f"int8 dispatch ({i}, {j})")
            if c:
                amax = x[j, i, :c].abs().amax(-1, keepdim=True)
                worst = max(worst, ((packed[i][j] - x[j, i, :c]).abs()
                                    / amax).max().item())
    require(worst <= 0.5 / 127 + 1e-6,
            f"int8 dispatch error {worst} above half a step of the row max")
    cpu = moe.run_moe_training_step(device="cpu")
    rel = max(abs(g - c) / abs(c) for g, c in zip(losses, cpu))
    require(rel <= 1e-5, f"MoE step on the card vs the CPU: {rel:.3e}")
    log(f"MoE path results: expert_ffn_fused (K20) within {e_fused:.3e} "
        f"(band {K20_BANDS[torch.float32]} x {scale:.1f}) of its plain "
        "version, the unfused einsum and the reduce-scatter cell within the "
        "band; dispatch_tokens byte-exact with the plain exchange over the "
        "valid rows, the int8 path bit-exact with the plain exchange of the "
        f"packed slab and within {worst:.3e} of each row's max; the MoE step "
        f"{losses} (descending, bit-stable across two builds), within "
        f"{rel:.3e} of the CPU run")
    return launched


def step_ms(variants: dict, rounds: int = 4, steps: int = 3) -> dict:
    """Host time (ms) of one training step ending in a sync, each variant
    ``(step, state)`` in turns (a b, b a, ...): after two warm-up steps
    each, ``rounds`` rounds of ``steps`` steps from the same state; the
    median and the quartiles of each variant's samples."""
    for step, state in variants.values():
        for _ in range(2):
            step(*state)
    torch.cuda.synchronize()
    samples = {what: [] for what in variants}
    order = list(variants)
    for r in range(rounds):
        for what in order if r % 2 == 0 else order[::-1]:
            step, state = variants[what]
            for _ in range(steps):
                t0 = time.perf_counter()
                step(*state)
                torch.cuda.synchronize()
                samples[what].append((time.perf_counter() - t0) * 1e3)
    return {what: {"median": statistics.median(s),
                   "quartiles": statistics.quantiles(s, n=4)[::2]}
            for what, s in samples.items()}


def step_profile(step, state, top: int = 8) -> dict:
    """One training step (after a warm-up step) under ``torch.profiler``:
    its host time (ms, profiler on), the device time of its kernels (ms;
    one stream, so their sum is the busy time), the device's idle share of
    the step, and the ``top`` kernels by device time with their counts.
    A trace with no device time says so instead."""
    from torch.profiler import ProfilerActivity, profile

    step(*state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        return {"host_ms": wall, "device_ms": "not measured"}
    kernels.sort(key=lambda k: -k[1])
    return {"host_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "kernel_launches": sum(n for _, _, n in kernels),
            "top": [{"kernel": name[:80], "ms": ms, "count": n}
                    for name, ms, n in kernels[:top]]}


def launch_delta(fn) -> tuple:
    """(fn's result, what it added to each launch count)."""
    before = counts()
    out = fn()
    return out, {k: v - before[k] for k, v in counts().items() if v != before[k]}


def codec_calls(world, big) -> dict:
    """The compressed collectives through coll/builtin on dups of
    ``world`` with a budget: their results and their launch deltas."""
    import ompi_tpu_torch

    int8 = world.dup()
    int8.info.set("otpu_quant_budget", "0.01")
    bf16 = world.dup_with_info(int8.get_info())
    bf16.info.set("otpu_quant_budget", "0.005")
    got = {}
    for name, fn in (
            ("int8_allreduce", lambda: int8.allreduce_array(big)),
            ("int8_allgather", lambda: int8.allgather_array(big)),
            ("bf16_allreduce", lambda: bf16.allreduce_array(big)),
            ("bf16_allgather", lambda: bf16.allgather_array(big)),
            ("max", lambda: int8.allreduce_array(big, ompi_tpu_torch.MAX))):
        got[name] = launch_delta(fn)
    return got


def wire16_calls(world, mid, big, rs_mid) -> dict:
    import ompi_tpu_torch

    require(world.c_coll["allreduce_array"].__self__.wire16,
            "OTPU_MCA_coll_ring_wire16=1 did not reach coll/ring")
    return {"ar_mid": launch_delta(lambda: world.allreduce_array(mid)),
            "ar_big": launch_delta(lambda: world.allreduce_array(big)),
            "rs_mid": launch_delta(lambda: world.reduce_scatter_array(
                rs_mid, ompi_tpu_torch.SUM))}


def duplex_calls(world, mid, big, rs_mid, rs_big) -> dict:
    """The raised ring with the duplex var: each call's result and launch
    delta; ``init`` binds the persistent allreduce (one validating call),
    ``persistent`` calls its handle twice."""
    import ompi_tpu_torch

    ring = world.c_coll["allreduce_array"].__self__
    require(ring.bidirectional and not ring.wire16,
            "OTPU_MCA_coll_ring_bidirectional=1 (wire16 off) did not reach "
            "coll/ring")
    got = {"ar_mid": launch_delta(lambda: world.allreduce_array(mid)),
           "ar_big": launch_delta(lambda: world.allreduce_array(big)),
           "rs_mid": launch_delta(lambda: world.reduce_scatter_array(
               rs_mid, ompi_tpu_torch.SUM)),
           "rs_big": launch_delta(lambda: world.reduce_scatter_array(
               rs_big, ompi_tpu_torch.SUM)),
           "ag": launch_delta(lambda: world.allgather_array(big)),
           "init": launch_delta(lambda: world.allreduce_array_init(mid))}
    handle = got["init"][0]
    got["persistent"] = launch_delta(lambda: [handle(mid), handle(mid)])
    return got


def check_duplex_results(duplex: dict, mid, big, rs_mid, rs_big) -> None:
    from ompi_tpu_torch.ops import ring_collectives as rc

    want = {"ar_mid": {"all_reduce_bidi": 1},
            "ar_big": {"all_reduce_seg_bidi": 1},
            "rs_mid": {"reduce_scatter_fused": 1},
            "rs_big": {"reduce_scatter_seg": 1},
            "ag": {"all_gather_bidi": 1},
            "init": {"all_reduce_bidi": 1},
            "persistent": {"all_reduce_bidi": 2}}
    for name, (_, delta) in duplex.items():
        require(delta == want[name], f"duplex {name}: launches {delta}, want "
                f"{want[name]}")
    check_sum(duplex["ar_mid"][0], mid, rc.all_reduce_bidi_plain(mid, N, "sum"),
              "duplex allreduce 4 MB/rank (K8)")
    check_sum(duplex["ar_big"][0], big,
              rc.all_reduce_seg_bidi_plain(big, N, "sum", SEG),
              "duplex allreduce 16 MB/rank (K9)")
    for name, x in (("rs_mid", rs_mid), ("rs_big", rs_big)):
        check_sum(duplex[name][0], x, rc.reduce_scatter_plain(x, N, "sum"),
                  f"duplex on, reduce_scatter {name} (K5/K6)")
    same_bytes(duplex["ag"][0], big, "duplex allgather 16 MB/rank (K11)")
    for out in duplex["persistent"][0]:
        same_bits(out, duplex["ar_mid"][0],
                  "allreduce_array_init handle vs the one-shot call (K8)")
    log("duplex path: 4 MB/rank allreduce -> K8, 16 MB/rank -> K9, "
        "reduce_scatter -> K5/K6 (no duplex key), allgather -> K11, each "
        "once; allreduce_array_init binds with one K8 and its two calls "
        "launch K8 twice, bit-equal to the one-shot call; all bit-exact with "
        "the plain versions and within 2(n-1)·2^-24·Σ|x| of torch.sum")


def codec_band(out, x, codec: str, what: str) -> float:
    """Max |out - exact| over max |exact|, exact = the float64 sum; fails
    above the codec's band."""
    from ompi_tpu_torch.mca.coll.quant import CODEC_BANDS

    exact = torch.sum(x.double(), 0)
    rel = float((out.double() - exact).abs().max() / exact.abs().max())
    require(rel <= CODEC_BANDS[codec], f"{what}: relative error {rel} above "
            f"the {codec} band {CODEC_BANDS[codec]}")
    return rel


def check_codec_results(codec: dict, big) -> None:
    from ompi_tpu_torch.ops import quant as qo

    want = {"int8_allreduce": {"encode_int8": 1, "dequant_accumulate": 1},
            "int8_allgather": {"encode_int8": 1, "decode_int8": 1},
            "bf16_allreduce": {}, "bf16_allgather": {}, "max": {}}
    for name, (_, delta) in codec.items():
        require(delta == want[name], f"{name}: launches {delta}, want "
                f"{want[name]}")
    q, s = qo.encode_int8_plain(big)
    same_bits(codec["int8_allreduce"][0],
              qo.dequant_accumulate_plain(q, s).reshape(big.shape[1:]),
              "int8 allreduce (K17, K18)")
    same_bits(codec["int8_allgather"][0],
              qo.decode_int8_plain(q, s).reshape(big.shape),
              "int8 allgather (K17, K19)")
    wire = big.to(torch.bfloat16).to(torch.float32)
    same_bits(codec["bf16_allreduce"][0], wire.sum(0), "bf16 allreduce")
    same_bits(codec["bf16_allgather"][0], wire, "bf16 allgather")
    require(torch.equal(codec["max"][0], torch.amax(big, 0)),
            "MAX on the budgeted comm is not exact")
    rel8 = codec_band(codec["int8_allreduce"][0], big, "int8", "int8 allreduce")
    rel16 = codec_band(codec["bf16_allreduce"][0], big, "bf16", "bf16 allreduce")
    log(f"codec path: budget 0.01 -> int8 (K17 x2, K18, K19 exactly), "
        f"budget 0.005 -> bf16 and MAX launched no codec kernel; bit-exact "
        f"with the plain versions; relative error vs the float64 sum: int8 "
        f"{rel8:.3e} (band {1 / 127:.3e}), bf16 {rel16:.3e} (band "
        f"{2 ** -8:.3e})")


def check_wire16_results(wire: dict, mid, big, rs_mid) -> None:
    from ompi_tpu_torch.ops import ring_collectives as rc

    want = {"ar_mid": {"all_reduce_wire16": 1},
            "ar_big": {"all_reduce_seg": 1},
            "rs_mid": {"reduce_scatter_wire16": 1}}
    for name, (_, delta) in wire.items():
        require(delta == want[name], f"wire16 {name}: launches {delta}, want "
                f"{want[name]}")
    same_bits(wire["ar_mid"][0], rc.all_reduce_wire16_plain(mid, N, "sum"),
              "wire16 allreduce 4 MB/rank (K7)")
    check_sum(wire["ar_big"][0], big, rc.all_reduce_seg_plain(big, N, "sum", SEG),
              "wire16 on, allreduce 16 MB/rank (K4)")
    same_bits(wire["rs_mid"][0], rc.reduce_scatter_wire16_plain(rs_mid, N, "sum"),
              "wire16 reduce_scatter 4 MB/rank (K5w)")
    for out, x, what in ((wire["ar_mid"][0], mid, "K7"),
                         (wire["rs_mid"][0], rs_mid, "K5w")):
        bound = N * 2.0 ** -8 * x.abs().sum(0)
        bad = ((out - torch.sum(x, 0)).abs() > bound).sum().item()
        require(bad == 0, f"{what}: {bad} elements outside n·2^-8·Σ|x|")
    log("wire16 path: 4 MB/rank allreduce -> K7, 16 MB/rank -> K4 (no K7), "
        "4 MB/rank reduce_scatter -> K5w, each once; bit-exact with the plain "
        "versions and within n·2^-8·Σ|x| of torch.sum")


def exchange_calls(world, big, a2a, moe, routed, agv, agv_counts) -> dict:
    """The exchange tier through ``world``: alltoall, alltoallv (the MoE
    dispatch), allgatherv and ppermute with the rotation and with GENERAL;
    ``k13_general`` is what the general perm added to K13's count."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    got = {"alltoall": world.alltoall_array(a2a),
           "alltoallv": world.alltoallv_array(moe, routed),
           "allgatherv": world.allgatherv_array(agv, agv_counts),
           "rotation": world.ppermute_array(big, ROT)}
    before = rc.launches["right_permute"]
    got["general"] = world.ppermute_array(big, GENERAL)
    got["k13_general"] = rc.launches["right_permute"] - before
    return got


# -- phase 4: times ------------------------------------------------------

def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``reps`` single calls with a cold L2: a 256 MB
    zero fill runs before each call.  The card spins first while the host
    enqueues every timed call: a wrapper's host dispatch can take longer
    than the fill, and would otherwise land between a call's events."""
    flush = torch.empty(256 * MB // 4, device="cuda")
    for _ in range(WARMUP):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(fn) -> float:
    """Host time per call (µs) to enqueue ``fn``, while the card spins, so
    that no device time is in it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    per_call = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return per_call


def measure(gen, launched: dict, err: dict) -> list:
    from ompi_tpu_torch.ops import quant as qo
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc

    big = operands(torch.float32, (N, 16 * MB // 4), gen)
    mid = operands(torch.float32, (N, 4 * MB // 4), gen)
    a = operands(torch.float32, (16 * MB // 4,), gen)
    b = operands(torch.float32, (16 * MB // 4,), gen)
    rs_mid = rs_operands(4 * MB, gen)
    rs_big = rs_operands(16 * MB, gen)
    a2a = operands(torch.float32, (N, N, 524288), gen)
    moe, routed = moe_slab(gen), moe_counts()
    agv = operands(torch.float32, (N, CAPACITY, HIDDEN), gen)
    row = HIDDEN * 4
    seg = SEG
    q, s = qo.encode_int8(big)                  # (8, 32768, 128), (8, 32768)
    q_bytes, s_bytes = q.numel(), s.numel() * 4
    cases = {
        # name: (kernel, plain, library, inputs+output bytes, what[, counts
        # of a ragged kernel, whose error is taken over its valid rows])
        "reduce_stack": (lambda: reduce.reduce_stack("PROD", big),
                         lambda: reduce.reduce_stack_plain("PROD", big),
                         lambda: torch.prod(big, 0),
                         (N + 1) * 16 * MB, "PROD f32 k=8, 16 MB slices"),
        "combine2": (lambda: reduce.combine2("SUM", a, b),
                     lambda: reduce.combine2_plain("SUM", a, b),
                     lambda: torch.add(a, b),
                     3 * 16 * MB, "SUM f32, 16 MB operands"),
        "all_reduce_fused": (lambda: rc.all_reduce(mid, N, "sum", "fused"),
                             lambda: rc.all_reduce_fused_plain(mid, N, "sum"),
                             lambda: torch.sum(mid, 0),
                             (N + 1) * 4 * MB, "SUM f32, 8 ranks x 4 MB"),
        "all_reduce_seg": (lambda: rc.all_reduce(big, N, "sum", "seg", seg),
                           lambda: rc.all_reduce_seg_plain(big, N, "sum", seg),
                           lambda: torch.sum(big, 0),
                           (N + 1) * 16 * MB, "SUM f32, 8 ranks x 16 MB"),
        "reduce_scatter_fused": (
            lambda: rc.reduce_scatter(rs_mid, N, "sum", "fused"),
            lambda: rc.reduce_scatter_plain(rs_mid, N, "sum"),
            lambda: torch.sum(rs_mid, 0),
            (N + 1) * 4 * MB, "SUM f32, (8, 8, 131072): 8 ranks x 4 MB"),
        "reduce_scatter_seg": (
            lambda: rc.reduce_scatter(rs_big, N, "sum", "seg", seg),
            lambda: rc.reduce_scatter_plain(rs_big, N, "sum"),
            lambda: torch.sum(rs_big, 0),
            (N + 1) * 16 * MB, "SUM f32, (8, 8, 524288): 8 ranks x 16 MB"),
        "all_gather": (lambda: rc.all_gather(big, N),
                       lambda: rc.all_gather_plain(big, N),
                       lambda: big.clone(),
                       2 * N * 16 * MB, "f32, 8 ranks x 16 MB"),
        "bcast": (lambda: rc.bcast(big, N, 3),
                  lambda: rc.bcast_plain(big, N, 3),
                  lambda: big[3].expand(N, -1).clone(),
                  (N + 1) * 16 * MB, "f32, root 3, 8 ranks x 16 MB"),
        "right_permute": (lambda: rc.right_permute(big, N),
                          lambda: rc.right_permute_plain(big, N),
                          lambda: torch.roll(big, 1, 0),
                          2 * N * 16 * MB, "f32, 8 ranks x 16 MB"),
        "all_to_all": (lambda: rc.all_to_all(a2a, N),
                       lambda: rc.all_to_all_plain(a2a, N),
                       lambda: a2a.transpose(0, 1).contiguous(),
                       2 * N * 16 * MB, "f32, (8, 8, 524288): 8 ranks x 16 MB"),
        "all_to_all_v": (lambda: rc.all_to_all_v(moe, routed, N),
                         lambda: rc.all_to_all_v_plain(moe, routed, N),
                         lambda: moe.transpose(0, 1).contiguous(),
                         2 * int(routed.sum()) * row,
                         f"f32 MoE dispatch (8, 8, {CAPACITY}, {HIDDEN}), "
                         f"{int(routed.sum())} of {N * N * CAPACITY} rows valid",
                         routed),
        "all_gather_v": (lambda: rc.all_gather_v(agv, routed[0], N),
                         lambda: rc.all_gather_v_plain(agv, routed[0], N),
                         lambda: agv.clone(),
                         2 * int(routed[0].sum()) * row,
                         f"f32 (8, {CAPACITY}, {HIDDEN}), "
                         f"{int(routed[0].sum())} of {N * CAPACITY} rows valid",
                         routed[0]),
        # no one PyTorch call computes the encode or the dequant-accumulate
        "encode_int8": (lambda: qo.encode_int8(big),
                        lambda: qo.encode_int8_plain(big), None,
                        N * 16 * MB + q_bytes + s_bytes,
                        "f32 8 x 16 MB -> int8 (8, 32768, 128) + f32 scales"),
        "dequant_accumulate": (lambda: qo.dequant_accumulate(q, s),
                               lambda: qo.dequant_accumulate_plain(q, s), None,
                               q_bytes + s_bytes + 16 * MB,
                               "k = 8, int8 (8, 32768, 128) -> f32 16 MB"),
        "decode_int8": (lambda: qo.decode_int8(q, s),
                        lambda: qo.decode_int8_plain(q, s),
                        lambda: torch.mul(q, s[..., None]),
                        q_bytes + s_bytes + N * 16 * MB,
                        "int8 (8, 32768, 128) -> f32 8 x 16 MB"),
        # no library call rounds each hop to bf16: K3 and K5 on the same
        # inputs (the same bytes) are timed beside them instead
        "all_reduce_wire16": (lambda: rc.all_reduce(mid, N, "sum", "wire16"),
                              lambda: rc.all_reduce_wire16_plain(mid, N, "sum"),
                              None, (N + 1) * 4 * MB,
                              "SUM f32, 8 ranks x 4 MB, bf16 wire"),
        "reduce_scatter_wire16": (
            lambda: rc.reduce_scatter(rs_mid, N, "sum", "wire16"),
            lambda: rc.reduce_scatter_wire16_plain(rs_mid, N, "sum"), None,
            (N + 1) * 4 * MB, "SUM f32, (8, 8, 131072): 8 ranks x 4 MB, bf16 wire"),
        "all_reduce_bidi": (lambda: rc.all_reduce(mid, N, "sum", "bidi"),
                            lambda: rc.all_reduce_bidi_plain(mid, N, "sum"),
                            lambda: torch.sum(mid, 0), (N + 1) * 4 * MB,
                            "SUM f32, 8 ranks x 4 MB, duplex blocks"),
        "all_reduce_seg_bidi": (
            lambda: rc.all_reduce(big, N, "sum", "seg_bidi", seg),
            lambda: rc.all_reduce_seg_bidi_plain(big, N, "sum", seg),
            lambda: torch.sum(big, 0), (N + 1) * 16 * MB,
            "SUM f32, 8 ranks x 16 MB, duplex blocks, 512 KB window"),
        "all_gather_bidi": (lambda: rc.all_gather(big, N, "bidi"),
                            lambda: rc.all_gather_plain(big, N),
                            lambda: big.clone(), 2 * N * 16 * MB,
                            "f32, 8 ranks x 16 MB"),
    }
    # the same bytes through the one-way kernel, on the same inputs
    beside = {
        "all_reduce_wire16": ("fused (K3/K5)",
                              lambda: rc.all_reduce(mid, N, "sum", "fused")),
        "reduce_scatter_wire16": ("fused (K3/K5)", lambda: rc.reduce_scatter(
            rs_mid, N, "sum", "fused")),
        "all_reduce_bidi": ("fused (K3)",
                            lambda: rc.all_reduce(mid, N, "sum", "fused")),
        "all_reduce_seg_bidi": ("seg (K4)", lambda: rc.all_reduce(
            big, N, "sum", "seg", seg)),
        "all_gather_bidi": ("ring (K10)", lambda: rc.all_gather(big, N))}
    rows, host = [], {}
    for name, (kernel, plain, library, nbytes, what, *ragged) in cases.items():
        route, source, replaces = KERNELS[name]
        ms = time_ms(kernel)
        got_err = (ragged_err(kernel(), plain(), ragged[0]) if ragged
                   else max(max_abs_err(g, w) for g, w in
                            zip(outputs(kernel()), outputs(plain()))))
        row = {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launched[name],
            "max_abs_err": max(err[name], got_err),
            "ms": ms, "plain_ms": time_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(library) if library else None,
        }
        extra = {"shape": what}
        if name in beside:
            label, fn = beside[name]
            extra["beside_ms"] = {label: time_ms(fn)}
        log(json.dumps({**row, **extra}))
        rows.append(row)
        host[name] = {"kernel": host_us(kernel)}
        if library:
            host[name]["library"] = host_us(library)
    # both accumulator regimes on both sides of the vmem_max_bytes
    # crossover (8 MB per rank), for the routing decision on this card
    cross = {
        coll: {f"{mb} MB/rank": {v: time_ms(lambda x=x, v=v: fn(
                   x, N, "sum", v, seg if v == "seg" else None))
                   for v in ("fused", "seg")}
               for mb, x in inputs}
        for coll, fn, inputs in (
            ("all_reduce", rc.all_reduce, ((4, mid), (16, big))),
            ("reduce_scatter", rc.reduce_scatter, ((4, rs_mid), (16, rs_big))))}
    log(json.dumps({"crossover_ms": cross}))
    # the whole int8 allreduce against the exact sum: on one card no link
    # carries the encoded bytes, so the codec is a pass more, not a saving
    codec_bytes = N * 16 * MB + 2 * (q_bytes + s_bytes) + 16 * MB
    log(json.dumps({"codec_path_ms": {
        "int8 allreduce (K17 + K18)": time_ms(
            lambda: qo.dequant_accumulate(*qo.encode_int8(big))),
        "bf16 allreduce (plain torch)": time_ms(
            lambda: big.to(torch.bfloat16).to(torch.float32).sum(0)),
        "torch.sum": time_ms(lambda: torch.sum(big, 0)),
        "int8 bound": codec_bytes / HBM_BYTES_PER_S * 1e3,
        "torch.sum bound": (N + 1) * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "shape": "f32 8 ranks x 16 MB"}}))
    log(json.dumps({"host_us_per_call": host}))
    # the torus schedules at 8 x 16 MB on the (2, 4) grid, each phase one
    # sub-ring launch: against the library call of the same function
    grid = big.view(2, 4, -1)
    log(json.dumps({"torus_ms": {
        "grid": [2, 4], "shape": "f32, 8 ranks x 16 MB",
        "all_reduce_torus": time_ms(lambda: rc.all_reduce_torus(grid, 2, 4)),
        "all_reduce_torus library (torch.sum over both axes)":
            time_ms(lambda: grid.sum((0, 1))),
        "all_reduce_torus bound": (N + 1) * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "reduce_scatter_torus": time_ms(
            lambda: rc.reduce_scatter_torus(rs_big, 2, 4)),
        "reduce_scatter_torus library (torch.sum)":
            time_ms(lambda: torch.sum(rs_big, 0)),
        "reduce_scatter_torus bound": (N + 1) * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "all_gather_torus": time_ms(lambda: rc.all_gather_torus(big, 2, 4)),
        "all_gather_torus library (clone)": time_ms(lambda: big.clone()),
        "all_gather_torus bound": 2 * N * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "launches per call": {
            "all_reduce_torus": launch_delta(
                lambda: rc.all_reduce_torus(grid, 2, 4))[1],
            "reduce_scatter_torus": launch_delta(
                lambda: rc.reduce_scatter_torus(rs_big, 2, 4))[1],
            "all_gather_torus": launch_delta(
                lambda: rc.all_gather_torus(big, 2, 4))[1]}}}))
    return rows


#: peak rates of one H100 SXM (data sheet, dense): float32 on the CUDA
#: cores (K21 uses no TF32) and bfloat16 on the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def flash_row(gen, launches: int, err: tuple, lead, sq, skv, d,
              dtype) -> tuple:
    """K21's kernels-line row at one shape: its time, its plain version's,
    and the bound, the larger of 4·B·sq·skv·d operations over the peak of
    the input dtype and the bytes (q, k, v, num, m, den read once; num, m,
    den written once) over the memory rate.  No PyTorch call returns the
    block update's carries, so library_ms is null.  ``err`` is the (abs,
    rel) error of K21 at this shape and dtype; returns the row and the
    relative error."""
    from ompi_tpu_torch.ops import flash_attention as fa

    q = torch.randn((*lead, sq, d), device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn((*lead, skv, d), device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    state = flash_state(lead, sq, d, dtype, False, gen)
    rows = int(np.prod(lead))
    ops = 4 * rows * sq * skv * d
    nbytes = (rows * (sq + 2 * skv + 2 * sq) * d + 4 * rows * sq) * \
        q.element_size()
    by_ops, by_bytes = ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    route, source, replaces = KERNELS["flash_block"]
    kernel = lambda: fa.update(q, k, v, *state)
    return {"name": "flash_block", "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err[0],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: fa.update_plain(q, k, v, *state)),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": None}, err[1]


def measure_flash(gen, launches: int, err: dict) -> dict:
    """K21 at the step's shape (its kernels-line row) and at the JAX
    bench's shape (a line of its own), with scaled_dot_product_attention
    at the bench shape as a yardstick for a later redesign (it does not
    return the carries, and the port never calls it)."""
    row, rel = flash_row(gen, launches, err["flash_block"], STEP_LEAD,
                         STEP_S, STEP_S, STEP_D, torch.float32)
    log(json.dumps({**row, "max_rel_err": rel, "shape": f"float32 q "
                    f"{(*STEP_LEAD, STEP_S, STEP_D)} (the step's, 32 rows), "
                    "unbiased"}))
    b, h, sq, skv, d = BENCH_FLASH
    bench, rel = flash_row(gen, launches, err["flash_block_bench"], (b, h),
                           sq, skv, d, torch.bfloat16)
    q, k, v = (torch.randn((b, h, n, d), device="cuda", generator=gen,
                           dtype=torch.bfloat16) for n in (sq, skv, skv))
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    log(json.dumps({"flash_block_bench": {**bench, "max_rel_err": rel,
                                          "shape": f"bfloat16 "
                    f"(b, h, sq, skv, d) = {BENCH_FLASH}, unbiased"},
                    "sdpa_ms_yardstick": sdpa}))
    return row


def slow_ms(fn) -> float:
    """``time_ms`` over 25 calls, or over 5 where one call takes above
    50 ms (K20 and its yardsticks in float32)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time_ms(fn, 5 if time.perf_counter() - t0 > 0.05 else REPS)


def k20_row(name: str, a: torch.Tensor, b: torch.Tensor, launches: int,
            err: float) -> dict:
    """K20's row at one shape: its time, its plain version's and
    ``torch.einsum("nmk,nko->mo")``'s (the same product, the reduce-scatter's
    unpadded), and the bound, the larger of 2·M·K·N operations over the
    dtype's peak and the bytes (a, b read once, the output written once)
    over the memory rate."""
    from ompi_tpu_torch.ops import overlap

    kernel, plain = getattr(overlap, name), getattr(overlap, f"{name}_plain")
    m, k_loc = a.shape[1], a.shape[2]
    out_rows = m if name == "matmul_allreduce" else N * -(-m // N)
    ops = 2 * m * N * k_loc * HIDDEN
    nbytes = (a.numel() + b.numel() + out_rows * HIDDEN) * a.element_size()
    by_ops, by_bytes = ops / PEAK_FLOPS[a.dtype], nbytes / HBM_BYTES_PER_S
    route, source, replaces = KERNELS[name]
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": slow_ms(lambda: kernel(a, b, N)),
            "plain_ms": slow_ms(lambda: plain(a, b, N)),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": slow_ms(lambda: torch.einsum("nmk,nko->mo", a, b))}


def measure_fused_matmul(gen, launched: dict, err: dict) -> list:
    """K20's rows at the Mixtral expert shape: float32 (the MoE path's
    dtype) in the kernels line, bfloat16 in a ``fused_matmul_bf16`` line."""
    rows, bf16 = [], []
    for dtype in (torch.float32, torch.bfloat16):
        a, b = k20_operands(dtype, K20_M, "random", gen)
        for name in MOE_KERNELS:
            key = name if dtype == torch.float32 else f"{name}_bf16"
            row = k20_row(name, a, b, launched[name], err[key])
            shape = (f"{str(dtype)[6:]} a (8, {K20_M}, {K20_K}), b (8, "
                     f"{K20_K}, {HIDDEN}): Mixtral-8x7B w2 over 8 ranks")
            if dtype == torch.float32:
                rows.append(row)
                log(json.dumps({**row, "shape": shape}))
            else:
                bf16.append({**row, "band": err[f"{key}_band"],
                             "shape": shape})
        del a, b
    log(json.dumps({"fused_matmul_bf16": bf16}))
    return rows


def outputs(result) -> tuple:
    """A kernel's outputs as a tuple (the encode returns two)."""
    return result if isinstance(result, tuple) else (result,)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import ompi_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ompi_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"nvcc build of {', '.join(_build.LIBRARIES)}: "
        f"{time.perf_counter() - t0:.1f} s")

    # full float32 products in the plain versions (both are the defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = check_kernels(gen)
    launched = main_path(gen)
    os.environ["OTPU_MODEL_SCALE"] = "64"
    trained = training_path()
    moe_launched = moe_path(gen)
    rows = measure(gen, launched, err)
    rows.append(measure_flash(gen, trained["flash_block"], err))
    rows += measure_fused_matmul(gen, moe_launched, err)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
