"""cuda_aot — compile every hand-written kernel of the port for sm_90a.

The compile gate, the port's twin of the JAX package's ``pallas_aot``: it
shows every kernel to the compiler that the card would run it with, and
records what the compiler made of it, without running it.

- Each CUDA C++ library of ``ops/_build.LIBRARIES`` is compiled by its own
  ``nvcc`` (the build's flags: ``-gencode arch=compute_90a,code=sm_90a``,
  ``-Xptxas -v``), all started together, into a temporary directory (never
  the build cache).  ``ptxas``'s report gives each kernel instance's
  registers, shared memory, stack frame and spill bytes, keyed by the
  mangled names ``ptxas`` prints; ``cuobjdump -sass`` of the library gives
  the count of each instruction of ``SASS_OPS`` in each instance.
- Each Triton kernel (``ops/reduce.py``'s ``combine2`` and
  ``reduce_stack``, ``ops/quant.py``'s ``encode_int8``,
  ``dequant_accumulate`` and ``decode_int8``) is compiled for every op and
  dtype the port launches it with (``triton_cases``), by worker processes
  with a Triton cache of their own in the same temporary directory; Triton
  compiles for the card it finds, so these rows need one.

One row per kernel instance: name, compiled or not, registers, shared
memory, spill bytes, compile seconds and the SASS counts; then a summary
(``n_kernels``, ``n_compiled``, ``ok``) in the shape of the JAX package's
``PALLAS_AOT.json``, with ``problems`` for the requirements ``chip_smoke.py``
holds the kernels to (``requirements``).  The report goes to stdout, or to
``--out``.  Without ``nvcc`` it exits 1 with the reason and writes no row;
it never reports a kernel as compiled that was not.

    python -m ompi_tpu_torch.tools.cuda_aot [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TARGET = "sm_90a"

#: instructions counted in every kernel instance's SASS: the wgmma body's
#: tensor-core and TMA instructions (K20), mma.sync's, the byte mover's
#: bulk copies, K21's FMAs, 16-byte shared loads and cp.async, and local
#: memory traffic (a spill or a stack array)
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "UBLKCP", "FFMA", "LDS.128",
            "LDGSTS", "STL", "LDL")

#: the kernels each C entry of ``_build.LIBRARIES`` launches, as fragments
#: of their (mangled) names; an entry that launches nothing maps to ()
C_ENTRIES = {
    **{e: ("ring_fused_kernel",) for e in (
        "otpu_ring_fused", "otpu_ring_rs_fused", "otpu_ring_wire16",
        "otpu_ring_rs_wire16", "otpu_ring_bidi", "otpu_ring_sub",
        "otpu_ring_seg", "otpu_ring_rs_seg", "otpu_ring_seg_bidi")},
    **{e: ("mover_kernel", "mover_byte_kernel") for e in (
        "otpu_ring_all_gather", "otpu_ring_right_permute",
        "otpu_ring_all_gather_bidi", "otpu_all_to_all", "otpu_all_to_all_v",
        "otpu_all_gather_v")},
    "otpu_ring_bcast": ("bcast_kernel",),
    "otpu_ring_copy_tickets_dealt": (),
    "otpu_exchange_tickets_dealt": (),
    "otpu_flash_block": ("flash_block_kernel",),
    "otpu_fused_matmul": ("fused_matmul_f32", "fused_matmul_mma_sync",
                          "fused_matmul_wgmma"),
}

#: ranks on the device world's stack: K1's ``K`` (the fold's rows)
STACK_K = 8
#: K18's ``K``: the rank counts ``chip_smoke.py`` drives it with
DEQUANT_K = (2, 8)
#: processes compiling the Triton instances beside the five nvcc
TRITON_WORKERS = 4


#: the Triton source functions of the kernels, by their wrappers' names
TRITON_KERNELS = {"_combine2_src": "combine2", "_stack_src": "reduce_stack",
                  "_encode_src": "encode_int8",
                  "_dequant_acc_src": "dequant_accumulate",
                  "_decode_src": "decode_int8"}


def _fold_cases() -> list:
    """Every (op, dtype) ``ops/reduce.py``'s kernels take (the op
    framework's ``device_fold`` gate)."""
    from ompi_tpu_torch.ops import reduce

    return [(op, str(dt).replace("torch.", ""))
            for op in reduce.supported_ops()
            for dt in reduce._KERNEL_DTYPES
            if reduce._supported_dtype(op, dt)]


def triton_cases() -> list:
    """``(kernel, source module, case)`` of every Triton kernel instance the
    gate compiles; ``kernel`` names the ``triton.jit`` source function."""
    folds = _fold_cases()
    cases = [("_combine2_src", "reduce", {"op": op, "dtype": dt})
             for op, dt in folds]
    cases += [("_stack_src", "reduce", {"op": op, "dtype": dt, "k": STACK_K})
              for op, dt in folds]
    cases += [("_encode_src", "quant", {"dtype": "float32"}),
              ("_decode_src", "quant", {"dtype": "float32"})]
    cases += [("_dequant_acc_src", "quant", {"dtype": "float32", "k": k})
              for k in DEQUANT_K]
    return cases


def _case_name(kernel: str, case: dict) -> str:
    short = TRITON_KERNELS[kernel]
    args = ",".join(str(case[k]) for k in ("op", "dtype", "k") if k in case)
    return f"{short}[{args}]"


# -- nvcc ------------------------------------------------------------------

def parse_ptxas(log: str) -> dict:
    """``{mangled kernel: {registers, shared_bytes, stack_bytes,
    spill_stores, spill_loads}}`` from ``-Xptxas -v`` output."""
    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {"registers": None, "shared_bytes": 0,
                             "stack_bytes": None, "spill_stores": None,
                             "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernels[name]["stack_bytes"] is None:
            k = kernels[name]
            k["stack_bytes"], k["spill_stores"], k["spill_loads"] = map(
                int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            kernels[name]["shared_bytes"] = int(s.group(1)) if s else 0
            name = None
    return kernels


def sass_counts(library: Path) -> dict:
    """The count of each instruction of ``SASS_OPS`` in every kernel of the
    built ``library`` (``cuobjdump -sass``)."""
    from ompi_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def start_nvcc(outdir: Path) -> dict:
    """One ``nvcc`` for each library, all started together: ``{library:
    (process, output path, start time)}``."""
    from ompi_tpu_torch.ops import _build

    compiler = _build.nvcc()
    procs = {}
    for lib, (source, _entries) in _build.LIBRARIES.items():
        out = outdir / f"lib{lib}.so"
        cmd = [compiler, *_build.NVCC_FLAGS, "-o", str(out),
               str(_build.CSRC / source)]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out, time.perf_counter())
    return procs


def finish_nvcc(procs: dict) -> list:
    """The rows of every library's kernel instances; a library that did not
    compile is one row with ``compiled`` False and the compiler's words."""
    rows = []
    for lib, (proc, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = round(time.perf_counter() - t0, 2)
        if proc.returncode != 0 or not out.exists():
            rows.append({"kernel": lib, "library": lib, "route": "cuda",
                         "compiled": False, "compile_s": seconds,
                         "error": log[-2000:]})
            continue
        sass = sass_counts(out)
        for name, k in parse_ptxas(log).items():
            rows.append({"kernel": name, "library": lib, "route": "cuda",
                         "compiled": k["registers"] is not None,
                         "registers": k["registers"],
                         "shared_bytes": k["shared_bytes"],
                         "stack_bytes": k["stack_bytes"],
                         "spill_bytes": (k["spill_stores"] or 0)
                         + (k["spill_loads"] or 0),
                         "compile_s": seconds,
                         "sass": sass.get(name, {})})
    return rows


# -- Triton ------------------------------------------------------------------

def _triton_compile(kernel: str, module: str, case: dict):
    """Compile one instance on the card without launching it; returns the
    compiled kernel."""
    import torch

    from ompi_tpu_torch.ops import quant, reduce

    dev = torch.device("cuda", torch.cuda.current_device())
    if module == "reduce":
        _, k_combine, k_stack = reduce._kernels()
        dtype = getattr(torch, case["dtype"])
        lane = torch.uint8 if dtype == torch.bool else dtype
        op = reduce._OPCODE[case["op"]]
        if kernel == "_combine2_src":
            n = 2 * reduce.BLOCK
            a, b, o = (torch.zeros(n, dtype=lane, device=dev)
                       for _ in range(3))
            return k_combine.warmup(a, b, o, n, OP=op, BLOCK=reduce.BLOCK,
                                    num_warps=4, grid=(1,))
        k, per = case["k"], 4096
        x = torch.zeros((k, per), dtype=lane, device=dev)
        out = torch.zeros(per, dtype=lane, device=dev)
        block = reduce.stack_block(k, x.element_size())
        return k_stack.warmup(
            x, out, per, -(-per // block), K=k, OP=op, BLOCK=block,
            STAGES=reduce.STACK_STAGES, num_warps=reduce.STACK_WARPS,
            num_stages=reduce.STACK_STAGES, grid=(1,))
    k_enc, k_acc, k_dec = quant._kernels()
    rows = 64
    k = case.get("k", 8)
    q = torch.zeros((k, rows, quant.LANES), dtype=torch.int8, device=dev)
    s = torch.zeros((k, rows), dtype=torch.float32, device=dev)
    if kernel == "_encode_src":
        x = torch.zeros((k, rows * quant.LANES), dtype=torch.float32,
                        device=dev)
        return k_enc.warmup(x, q, s, rows * quant.LANES, rows, quant.INV127,
                            ROWS=quant.ROWS, num_warps=4, grid=(1, 1))
    if kernel == "_decode_src":
        out = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        return k_dec.warmup(q, s, out, s.numel(), ROWS=quant.ROWS,
                            num_warps=4, grid=(1,))
    out = torch.zeros((rows, quant.LANES), dtype=torch.float32, device=dev)
    return k_acc.warmup(q, s, out, rows, K=k, ROWS=quant.ROWS, num_warps=4,
                        grid=(1,))


def triton_rows(shard: int, shards: int) -> list:
    """Compile this worker's share of ``TRITON_CASES``: one row each."""
    rows = []
    for i, (kernel, module, case) in enumerate(triton_cases()):
        if i % shards != shard:
            continue
        row = {"kernel": _case_name(kernel, case),
               "library": f"ops/{module}.py", "route": "triton",
               "compiled": False}
        t0 = time.perf_counter()
        try:
            compiled = _triton_compile(kernel, module, case)
            compiled._init_handles()
            row.update(compiled=True, registers=int(compiled.n_regs),
                       shared_bytes=int(compiled.metadata.shared),
                       spill_bytes=int(compiled.n_spills))
        except Exception as exc:       # the row says why, ok turns False
            row["error"] = f"{type(exc).__name__}: {exc}"[-2000:]
        row["compile_s"] = round(time.perf_counter() - t0, 3)
        rows.append(row)
    return rows


def start_triton(outdir: Path, workers: int) -> list:
    """Worker processes compiling the Triton instances, each with a cache
    of its own under ``outdir``."""
    procs = []
    for shard in range(workers):
        env = dict(os.environ,
                   TRITON_CACHE_DIR=str(outdir / f"triton-cache-{shard}"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ompi_tpu_torch.tools.cuda_aot",
             "--triton-worker", str(shard), str(workers)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(Path(__file__).resolve().parents[2])))
    return procs


def finish_triton(procs: list) -> list:
    rows = []
    for shard, proc in enumerate(procs):
        out, err = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("[")]
        if proc.returncode != 0 or not lines:
            rows.append({"kernel": f"triton worker {shard}",
                         "library": "ops", "route": "triton",
                         "compiled": False, "error": err[-2000:]})
            continue
        rows += json.loads(lines[-1])
    return rows


# -- the report ----------------------------------------------------------------

def missing_cases(rows: list) -> list:
    """Each C entry's kernels that no compiled row names, and each Triton
    case that has no compiled row."""
    from ompi_tpu_torch.ops import _build

    missing = []
    for lib, (_source, entries) in _build.LIBRARIES.items():
        names = [r["kernel"] for r in rows
                 if r["library"] == lib and r["compiled"]]
        for entry in entries:
            for frag in C_ENTRIES.get(entry, ("<no case>",)):
                if not any(frag in n for n in names):
                    missing.append(f"{lib}:{entry}:{frag}")
    compiled = {r["kernel"] for r in rows
                if r["route"] == "triton" and r["compiled"]}
    missing += [_case_name(k, c) for k, _m, c in triton_cases()
                if _case_name(k, c) not in compiled]
    return missing


def requirements(rows: list) -> list:
    """What ``chip_smoke.py`` holds the build to: the wgmma body of K20
    issues HGMMA and UTMALDG; each of the byte mover's four
    ``mover_kernel`` instances issues ``UBLKCP`` and no copy kernel spills
    or touches local memory; each of K21's eight ``flash_block_kernel``
    instances issues FFMA, LDS.128 and LDGSTS, and none spills.  Other
    kernels' spills are recorded, not refused.  Returns the problems."""
    problems = []
    lib_rows = {}
    for r in rows:
        if r["route"] == "cuda" and r["compiled"]:
            lib_rows.setdefault(r["library"], []).append(r)
    wgmma = [r for r in lib_rows.get("fused_matmul", [])
             if "wgmma" in r["kernel"]]
    if not (len(wgmma) == 1 and wgmma[0]["sass"].get("HGMMA")
            and wgmma[0]["sass"].get("UTMALDG")):
        problems.append(f"the wgmma body issues no HGMMA or UTMALDG: "
                        f"{[(r['kernel'], r['sass']) for r in wgmma]}")
    copies = lib_rows.get("ring_copy", []) + lib_rows.get("exchange", [])
    bulk = [r for r in copies if "mover_kernel" in r["kernel"]]
    if not (len(bulk) == 4 and all(r["sass"].get("UBLKCP", 0) >= 2
                                   for r in bulk)):
        problems.append(f"a mover kernel issues no bulk copy: "
                        f"{[(r['kernel'], r['sass']) for r in bulk]}")
    for r in copies:
        if (r["spill_bytes"] or r["stack_bytes"]
                or ("mover" in r["kernel"]
                    and (r["sass"].get("STL") or r["sass"].get("LDL")))):
            problems.append(f"a copy kernel spills: {r}")
    flash = [r for r in lib_rows.get("flash_block", [])
             if "flash_block_kernel" in r["kernel"]]
    if len(flash) != 8:
        problems.append(f"{len(flash)} flash_block_kernel instances, not 8")
    for r in lib_rows.get("flash_block", []):
        ops = r["sass"]
        if r["spill_bytes"] or r["stack_bytes"] or (
                "flash_block_kernel" in r["kernel"]
                and not (ops.get("FFMA") and ops.get("LDS.128")
                         and ops.get("LDGSTS") and not ops.get("STL")
                         and not ops.get("LDL"))):
            problems.append(f"a flash_block_kernel instance lacks FFMA, "
                            f"LDS.128 or LDGSTS, or spills: {r}")
    return problems


def run() -> dict:
    """Compile everything; the report.  Raises RuntimeError without
    ``nvcc`` (before any row exists)."""
    from ompi_tpu_torch.ops import _build

    _build.nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cuda-aot-") as tmp:
        outdir = Path(tmp)
        nvccs = start_nvcc(outdir)
        workers = start_triton(outdir, TRITON_WORKERS)
        rows = finish_nvcc(nvccs) + finish_triton(workers)
    missing = missing_cases(rows)
    n_compiled = sum(1 for r in rows if r["compiled"])
    return {"target": TARGET, "grade": "nvcc-ptxas + triton-compile",
            "ok": n_compiled == len(rows) and not missing,
            "n_kernels": len(rows), "n_compiled": n_compiled,
            "elapsed_s": round(time.perf_counter() - t0, 2),
            "missing": missing, "problems": requirements(rows),
            "rows": rows}


def stack_compiled(big):
    """K1's compiled kernel at a row's shape (``big``: the ``(k, ...)``
    stack): registers, spills, shared memory and the persistent grid."""
    import torch

    from ompi_tpu_torch.ops import reduce

    kernel, grid = reduce._launch_stack("PROD", big, torch.empty_like(big[0]))
    return {"n_regs": kernel.n_regs, "n_spills": kernel.n_spills,
            "shared": kernel.metadata.shared, "grid": grid,
            "setting": {"bytes": reduce.STACK_BYTES,
                        "warps": reduce.STACK_WARPS,
                        "stages": reduce.STACK_STAGES}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cuda_aot", description="Compile every hand-written kernel of "
        "the port for sm_90a and report registers, shared memory, spills")
    ap.add_argument("--out", help="write the JSON report here (default: "
                    "stdout)")
    ap.add_argument("--triton-worker", nargs=2, type=int,
                    metavar=("SHARD", "SHARDS"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.triton_worker:
        print(json.dumps(triton_rows(*args.triton_worker)), flush=True)
        return 0
    try:
        report = run()
    except RuntimeError as exc:
        print(f"cuda_aot: {exc}", file=sys.stderr)
        return 1
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"cuda_aot: {report['n_compiled']}/{report['n_kernels']} "
              f"kernel instances compiled for {TARGET} in "
              f"{report['elapsed_s']} s, ok={report['ok']} -> {args.out}")
    else:
        print(text)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
