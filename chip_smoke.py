"""Smoke run of the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. The card: ``nvidia-smi --query-gpu=name,power.limit``.
2. Every kernel of the main path against its plain PyTorch version, on the
   card, bit for bit (the fold order of each is fixed):
   K2 ``combine2`` (Triton) — every op on float32, int32, int8 and bool;
   K1 ``reduce_stack`` (Triton) — k = 8, 16 MB slices, the same ops;
   K3 fused ring all-reduce (CUDA C++) — float32 sum/max/min/prod, 4 MB per
   rank; K4 segmented ring all-reduce (CUDA C++) — the same at 16 MB per rank.
3. The main path, with every launch count set to 0 before and read after:
   ``ompi_tpu_torch.init()`` (8 virtual ranks on ``cuda:0``), then
   ``COMM_WORLD.allreduce_array`` at default priorities — SUM to
   coll/builtin, PROD and BAND to coll/builtin's stack fold (K1) — and
   ``ompi_tpu_torch.reduce_local`` (MPI_Reduce_local, K2); then re-init with
   ``OTPU_MCA_coll_ring_priority=95``: SUM at 4 MB per rank (K3) and at
   16 MB per rank, the headline cell (K4).  Each result is held against the
   plain version (bit-exact) and against ``torch.sum(x, 0)`` (tolerance
   below).
4. Times: CUDA events around single calls, cold L2 (a 256 MB buffer is
   zeroed before each call), median of 25 after 3 warm-up calls, for each
   kernel, its plain version and one PyTorch library call computing the same
   function; ``bound_ms`` is the bytes the function must move (inputs read
   once, output written once) over 3.35 TB/s, the H100 SXM's memory rate.

Prints one JSON line per kernel, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Needs one card; with none it exits 1
before printing anything.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

MB = 1 << 20
N = 8                      # virtual ranks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
REPS, WARMUP = 25, 3
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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def counts():
    from ompi_tpu_torch.ops import reduce, ring_collectives

    return {**reduce.launches, **ring_collectives.launches}


def reset_counts() -> None:
    from ompi_tpu_torch.ops import reduce, ring_collectives

    for table in (reduce.launches, ring_collectives.launches):
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
        seg = 512 * 1024 // 4 if variant == "seg" else None
        for op in ("sum", "max", "min", "prod"):
            plain = (rc.all_reduce_seg_plain(x, N, op, seg) if variant == "seg"
                     else rc.all_reduce_fused_plain(x, N, op))
            same_bits(rc.all_reduce(x, N, op, variant, seg), plain,
                      f"{name} {op} float32 {per_rank // MB} MB/rank")
        err[name] = 0.0
        log(f"{name}: float32 sum/max/min/prod at {per_rank // MB} MB per "
            "rank: bit-exact")
        del x
    torch.cuda.synchronize()
    return err


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
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    world = ompi_tpu_torch.init()
    require(world.size == N and world.rte.device.type == "cuda",
            f"world of {world.size} on {world.rte.device}")
    require(type(world.c_coll["allreduce_array"].__self__).__name__
            == "BuiltinCollModule", "default owner is not coll/builtin")
    s_builtin = world.allreduce_array(big, ompi_tpu_torch.SUM)
    p_prod = world.allreduce_array(big, ompi_tpu_torch.PROD)
    p_band = world.allreduce_array(ints, ompi_tpu_torch.BAND)
    ompi_tpu_torch.reduce_local(inbuf, inout, ompi_tpu_torch.SUM)
    rt.finalize()

    os.environ["OTPU_MCA_coll_ring_priority"] = "95"
    world = ompi_tpu_torch.init()
    require(type(world.c_coll["allreduce_array"].__self__).__name__
            == "RingCollModule", "raised owner is not coll/ring")
    s_fused = world.allreduce_array(mid, ompi_tpu_torch.SUM)
    s_seg = world.allreduce_array(big, ompi_tpu_torch.SUM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    rt.finalize()
    del os.environ["OTPU_MCA_coll_ring_priority"]

    log(f"main path: init + 5 allreduce_array + reduce_local in {wall:.3f} s "
        f"(host clock, includes the first-call builds); launches {launched}")
    for name in KERNELS:
        require(launched[name] > 0, f"{name} was not launched on the main path")

    require(torch.equal(s_builtin, torch.sum(big, 0)), "builtin SUM")
    same_bits(p_prod, reduce.reduce_stack_plain("PROD", big), "PROD (K1)")
    same_bits(p_band, reduce.reduce_stack_plain("BAND", ints), "BAND (K1)")
    same_bits(inout, inout_plain, "reduce_local SUM (K2)")
    check_sum(s_fused, mid, rc.all_reduce_fused_plain(mid, N, "sum"),
              "ring SUM 4 MB/rank (K3)")
    check_sum(s_seg, big, rc.all_reduce_seg_plain(big, N, "sum", 512 * 1024 // 4),
              "ring SUM 16 MB/rank (K4)")
    log("main path results: bit-exact with the plain versions; ring SUM "
        "within 2(n-1)·2^-24·Σ|x| of torch.sum")
    return launched


# -- phase 4: times ------------------------------------------------------

def time_ms(fn) -> float:
    """Median device time of single calls with a cold L2: a 256 MB zero
    fill runs before each call, which also keeps the card busy while the
    host enqueues the call, so host overhead is not timed."""
    flush = torch.empty(256 * MB // 4, device="cuda")
    for _ in range(WARMUP):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def measure(gen, launched: dict, err: dict) -> list:
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc

    big = operands(torch.float32, (N, 16 * MB // 4), gen)
    mid = operands(torch.float32, (N, 4 * MB // 4), gen)
    a = operands(torch.float32, (16 * MB // 4,), gen)
    b = operands(torch.float32, (16 * MB // 4,), gen)
    seg = 512 * 1024 // 4
    cases = {
        # name: (kernel, plain, library, inputs+output bytes, what)
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
    }
    rows = []
    for name, (kernel, plain, library, nbytes, what) in cases.items():
        route, source, replaces = KERNELS[name]
        ms = time_ms(kernel)
        row = {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launched[name],
            "max_abs_err": max(err[name], max_abs_err(kernel(), plain())),
            "ms": ms, "plain_ms": time_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(library),
        }
        log(json.dumps({**row, "shape": what}))
        rows.append(row)
    # both accumulator regimes on both sides of the vmem_max_bytes
    # crossover (8 MB per rank), for the routing decision on this card
    cross = {f"{mb} MB/rank": {v: time_ms(lambda x=x, v=v: rc.all_reduce(
                 x, N, "sum", v, seg if v == "seg" else None))
                 for v in ("fused", "seg")}
             for mb, x in ((4, mid), (16, big))}
    log(json.dumps({"crossover_ms": cross}))
    return rows


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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = check_kernels(gen)
    launched = main_path(gen)
    rows = measure(gen, launched, err)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
