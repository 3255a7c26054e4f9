"""Build and bind the CUDA C++ kernels of ``ompi_tpu_torch/csrc``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at first use,
into ``ompi_tpu_torch/build/`` (listed in ``.gitignore``); every source is
compiled by its own ``nvcc`` process, all started together.  A library's
file name carries a hash of its sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept beside each
library as ``<name>.log``.  The build runs under an exclusive ``flock`` on
``build/cuda.lock``: the processes of one job (a multi-process device
world's ranks) build a missing library once, and the others load it.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: library -> (source, {C entry point: argtypes}); every entry returns int
LIBRARIES = {
    "ring_fused": ("ring_fused.cu",
                   {"otpu_ring_fused": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                    "otpu_ring_rs_fused": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                   "otpu_ring_wire16": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                   "otpu_ring_rs_wire16": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                   "otpu_ring_bidi": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                   "otpu_ring_sub": [_P, _P, _LL, _LL, _LL, _LL, _I, _I, _I, _I,
                                     _I, _P],
                   "otpu_ring_seg": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                   "otpu_ring_rs_seg": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P],
                   "otpu_ring_seg_bidi": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P]}),
    # the byte mover's entries end (..., vec, counter, stream)
    "ring_copy": ("ring_copy.cu",
                  {"otpu_ring_all_gather": [_P, _P, _LL, _I, _P, _P],
                   "otpu_ring_bcast": [_P, _P, _LL, _I, _I, _I, _P],
                   "otpu_ring_right_permute": [_P, _P, _LL, _I, _I, _P, _P],
                   "otpu_ring_all_gather_bidi": [_P, _P, _LL, _I, _I, _P, _P],
                   "otpu_ring_copy_tickets_dealt": []}),
    "exchange": ("exchange.cu",
                 {"otpu_all_to_all": [_P, _P, _LL, _I, _I, _P, _P],
                  "otpu_all_to_all_v": [_P, _P, _P, _LL, _LL, _I, _I, _P, _P],
                  "otpu_all_gather_v": [_P, _P, _P, _LL, _LL, _I, _I, _P, _P],
                  "otpu_exchange_tickets_dealt": []}),
    "flash_block": ("flash_block.cu",
                    {"otpu_flash_block": [_P] * 10 + [_LL, _I, _I, _I, _LL, _I, _I,
                                                      _I, _I, _I, _P]}),
    "fused_matmul": ("fused_matmul.cu",
                     {"otpu_fused_matmul": [_P, _P, _P] + [_I] * 8 + [_P, _P]}),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit on the machine with the card")
    return str(path)


def library_path(name: str) -> Path:
    source = LIBRARIES[name][0]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every library that is missing, one nvcc each, in parallel."""
    todo = {name: library_path(name) for name in LIBRARIES}
    if all(path.exists() for path in todo.values()):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "cuda.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # another process may have built them while this one waited
        _build({name: path for name, path in todo.items()
                if not path.exists()})


def _build(todo: dict) -> None:
    if not todo:
        return
    compiler = nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built (with all others) at first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]
