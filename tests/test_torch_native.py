"""The port's native core (``ompi_tpu_torch/native``) held against its own
pure-Python lanes and against the JAX package's native core: the datatype
pack loops, the btl/sm ring ops, the atomics and locks, the worker pool of
``threads/native``, the build into ``ompi_tpu_torch/build/`` and the
``OTPU_NATIVE_DISABLE`` switch.  Inputs are seeded numpy; every comparison
is bit for bit.  The native cases need g++ (present wherever the suite
runs; skipped with a reason otherwise)."""
import ctypes
import os
import shutil
import subprocess
import sys
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu import native as jnative
from ompi_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is not on PATH: no native core")


def _types(pkg):
    core = __import__(f"{pkg}.datatype.core", fromlist=["x"])
    return [core.vector(4, 2, 4, core.FLOAT64),
            core.indexed([1, 3, 2], [0, 5, 11], core.FLOAT32),
            core.subarray([6, 8], [3, 4], [1, 2], core.ORDER_C,
                          core.FLOAT64),
            core.contiguous(16, core.INT32),
            core.vector(3, 1, 5, core.INT8)]


def _convertor(pkg, dt, count, mem, use_native):
    cv = __import__(f"{pkg}.datatype.convertor", fromlist=["x"])
    c = cv.Convertor(dt, count)
    c.prepare(mem)
    c._native = use_native
    return c


def test_the_core_builds_into_the_package_build_dir():
    assert native.available(), native.unavailable_reason()
    assert native.unavailable_reason() == ""
    so = native.library_path()
    assert so.exists() and so.parent == REPO / "ompi_tpu_torch" / "build"
    assert so.name.startswith("libotpu_native-") and so.suffix == ".so"
    assert native.reactor_supported()
    # the port's own copy of the source, not the JAX package's file
    assert native._SRC == REPO / "ompi_tpu_torch" / "native" / "otpu_native.cc"


def test_a_failed_build_is_reported(tmp_path):
    """A source that does not compile leaves ``available()`` False with the
    compiler's message as the reason; nothing falls back silently."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    code = ("from pathlib import Path; import ompi_tpu_torch.native as n; "
            f"n._SRC = Path({str(bad)!r}); n.BUILD_DIR = Path({str(tmp_path)!r}); "
            "print(n.available()); print(n.unavailable_reason())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    out = r.stdout.splitlines()
    assert r.returncode == 0, r.stderr
    assert out[0] == "False"
    assert "native core build or load failed" in out[1] and "g++" in out[1]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("count", [1, 3, 7])
def test_pack_unpack_matches_numpy_and_the_reference(case, count):
    """Each datatype case packs to the same bytes through the port's native
    loop, its numpy loop and the JAX package's native loop; the unpacks of
    those bytes write the same memory."""
    rng = np.random.default_rng(100 + case * 10 + count)
    mem = rng.standard_normal(8192).view(np.uint8).copy()
    dt_t, dt_j = _types("ompi_tpu_torch")[case], _types("ompi_tpu")[case]
    packs = {
        "native": _convertor("ompi_tpu_torch", dt_t, count, mem.copy(),
                             True).pack(),
        "numpy": _convertor("ompi_tpu_torch", dt_t, count, mem.copy(),
                            False).pack(),
        "reference": _convertor("ompi_tpu", dt_j, count, mem.copy(),
                                True).pack()}
    assert packs["native"].tobytes() == packs["numpy"].tobytes() == \
        packs["reference"].tobytes()
    outs = {}
    for lane, use_native in (("native", True), ("numpy", False)):
        dst = np.zeros(8192, np.uint8)
        _convertor("ompi_tpu_torch", dt_t, count, dst, use_native).unpack(
            packs[lane])
        outs[lane] = dst
    ref = np.zeros(8192, np.uint8)
    _convertor("ompi_tpu", dt_j, count, ref, True).unpack(packs["reference"])
    assert outs["native"].tobytes() == outs["numpy"].tobytes() == \
        ref.tobytes()


@pytest.mark.parametrize("chunk", [1, 37, 4096])
def test_chunked_pack_resumes_identically(chunk):
    """Packing in chunks that split elements (the resume path) gives the
    same stream through both lanes and the reference."""
    streams = []
    for pkg, flag in (("ompi_tpu_torch", True), ("ompi_tpu_torch", False),
                      ("ompi_tpu", True)):
        core = __import__(f"{pkg}.datatype.core", fromlist=["x"])
        c = _convertor(pkg, core.vector(8, 3, 5, core.FLOAT32), 4,
                       np.arange(4096, dtype=np.uint8), flag)
        parts = []
        while not c.finished:
            parts.append(c.pack(chunk).tobytes())
        streams.append(b"".join(parts))
    assert streams[0] == streams[1] == streams[2]


@pytest.fixture
def native_pool():
    """The process's work pool as an ``init`` leaves it (a finalize run by
    an earlier test bars the lazy pool until the next init re-arms it)."""
    from ompi_tpu_torch.mca.threads import base as threads_base

    threads_base.reopen_pool()
    pool = threads_base.get_pool()
    assert type(pool).__name__ == "NativePool" and pool.parallel_pack
    return pool


def test_big_packs_fan_out_over_the_pool(native_pool):
    """A whole-element job of 2 MB or more goes through the native worker
    pool (``threads/native``); its pack and unpack equal the numpy lane."""
    from ompi_tpu_torch.datatype import convertor as cv
    from ompi_tpu_torch.datatype import core

    dt = core.vector(1 << 16, 2, 3, core.FLOAT32)       # 512 KB an element
    assert dt.size * 4 >= cv._POOL_PACK_MIN
    rng = np.random.default_rng(5)
    mem = rng.standard_normal(dt.extent + 64).astype(np.float32).view(
        np.uint8)
    a = _convertor("ompi_tpu_torch", dt, 4, mem.copy(), True).pack()
    b = _convertor("ompi_tpu_torch", dt, 4, mem.copy(), False).pack()
    assert a.tobytes() == b.tobytes()
    da, db = np.zeros_like(mem), np.zeros_like(mem)
    _convertor("ompi_tpu_torch", dt, 4, da, True).unpack(a)
    _convertor("ompi_tpu_torch", dt, 4, db, False).unpack(b)
    assert da.tobytes() == db.tobytes()


def _ring_buffer(cap):
    """A ring's shared layout in a numpy buffer: head u64 | tail u64 |
    data[cap]."""
    buf = np.zeros(16 + cap, np.uint8)
    return buf, buf.ctypes.data


def test_ring_push_pop_round_trips_across_the_wrap_and_a_full_ring():
    cap = 4096
    buf, addr = _ring_buffer(cap)
    rng = np.random.default_rng(8)
    out = np.empty(cap, np.uint8)
    sent = 0
    for i in range(400):                 # sizes force many wrap-arounds
        p = rng.integers(0, 256, (i * 53) % 1500 + 1, dtype=np.uint8)
        if i % 3 == 0:
            h = rng.integers(0, 256, 7, dtype=np.uint8)
            assert native.ring_push2(addr, cap, h, p)
            want = np.concatenate([h, p])
        else:
            assert native.ring_push(addr, cap, p)
            want = p
        sent += 4 + len(want)
        assert native.ring_peek_len(addr, cap) == len(want)
        assert native.ring_pop(addr, cap, out) == len(want)
        assert out[:len(want)].tobytes() == want.tobytes()
        assert native.ring_peek_len(addr, cap) == -1
    head, tail = buf[:16].view(np.uint64)
    assert head == tail == sent and sent > 10 * cap
    # fill the ring: a push that does not fit is refused, nothing written
    frames = [rng.integers(0, 256, 1000, dtype=np.uint8) for _ in range(4)]
    assert all(native.ring_push(addr, cap, f) for f in frames)
    assert not native.ring_push(addr, cap, frames[0])
    assert native.ring_pop(addr, cap, np.empty(10, np.uint8)) == -2
    for f in frames:
        assert native.ring_pop(addr, cap, out) == 1000
        assert out[:1000].tobytes() == f.tobytes()
    assert native.ring_pop(addr, cap, out) == -1


@pytest.mark.parametrize("writer,reader", [
    ("torch-native", "torch-numpy"), ("torch-numpy", "torch-native"),
    ("torch-native", "jax-native"), ("jax-native", "torch-native")])
def test_sm_rings_of_either_lane_interoperate(writer, reader):
    """btl/sm's frames pushed by one lane (the port's native or numpy lane,
    or the JAX package's native ring) pop whole and byte-exact through the
    other, across the wrap."""
    from ompi_tpu.mca.btl import sm as jsm
    from ompi_tpu_torch.mca.btl import sm as tsm

    shm = shared_memory.SharedMemory(create=True, size=4096 + 16)
    w = r = None
    try:
        def ring(which, owner):
            mod = tsm if which.startswith("torch") else jsm
            rg = mod._Ring(shm, owner=owner)
            if which.endswith("numpy"):
                rg._addr = None
            assert (rg._addr is None) == which.endswith("numpy")
            return rg

        w, r = ring(writer, True), ring(reader, False)
        rng = np.random.default_rng(12)
        for size in (1000, 1500, 3, 2000, 0, 1777, 999, 2500, 3000):
            hdr = rng.integers(0, 255, 40, dtype=np.uint8).tobytes()
            body = rng.integers(0, 255, size, dtype=np.uint8)
            assert w.push_frame(hdr, body)
            frame = r.pop_frame()
            assert bytes(frame[:4]) == len(hdr).to_bytes(4, "little")
            assert bytes(frame[4:44]) == hdr
            assert bytes(frame[44:]) == body.tobytes()
            assert r.pop_frame() is None
        assert not w.push_frame(b"x", np.zeros(5000, np.uint8))
    finally:
        w = r = None
        shm.close()
        shm.unlink()


def test_atomics_and_locks_match_the_reference():
    """The same sequence of atomic and lock calls on a word of each
    package's core gives the same values and outcomes."""
    results = []
    for mod in (native, jnative):
        word = np.zeros(2, np.int64)
        a = word.ctypes.data
        seq = [mod.atomic_add_i64(a, 5), mod.atomic_add_i64(a, -7),
               mod.atomic_cas_i64(a, -2, 40), mod.atomic_cas_i64(a, 0, 1),
               mod.atomic_load_u64(a)]
        mod.atomic_store_u64(a, (1 << 64) - 3)
        seq.append(mod.atomic_load_u64(a))
        lock = a + 8
        seq += [mod.lock_shared_try(lock), mod.lock_shared_try(lock),
                mod.lock_excl_try(lock)]
        mod.lock_shared_release(lock)
        mod.lock_shared_release(lock)
        seq += [mod.lock_excl_try(lock), mod.lock_shared_try(lock)]
        mod.lock_excl_release(lock)
        seq.append(mod.lock_shared_try(lock))
        results.append(seq)
    assert results[0] == results[1]
    assert results[0] == [0, 5, (-2, True), (40, False), 40,
                          (1 << 64) - 3, True, True, False, True, False,
                          True]


def test_atomic_counters_under_threads():
    """Four threads bump one word 2000 times each through the core: no
    increment is lost (the counters coll/sm waits on)."""
    import threading

    word = np.zeros(1, np.int64)

    def bump():
        for _ in range(2000):
            native.atomic_add_i64(word.ctypes.data, 1)

    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert native.atomic_load_u64(word.ctypes.data) == 8000


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
def test_pool_reduce_equals_its_serial_twins(op, dtype):
    """``NativePool.reduce`` over 1 M elements equals the numpy ufunc and
    the JAX package's native pool, bit for bit."""
    from ompi_tpu.mca.threads.native import NativePool as JPool
    from ompi_tpu_torch.mca.threads.native import NativePool

    rng = np.random.default_rng(21)
    if dtype.startswith("float"):
        acc0 = rng.standard_normal(1 << 20).astype(dtype)
        src = rng.standard_normal(1 << 20).astype(dtype)
        acc0[::97] = np.nan
    else:
        acc0 = rng.integers(-50, 50, 1 << 20).astype(dtype)
        src = rng.integers(-50, 50, 1 << 20).astype(dtype)
    ufunc = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
             "min": np.minimum}[op]
    want = ufunc(acc0, src)
    outs = []
    for cls in (NativePool, JPool):
        pool = cls(4)
        acc = acc0.copy()
        pool.reduce(op, acc, src).wait()
        pool.close()
        outs.append(acc)
    assert outs[0].tobytes() == want.tobytes() == outs[1].tobytes()


def test_pool_memcpy_pack_and_unpack_equal_their_serial_twins():
    from ompi_tpu_torch.mca.threads.native import NativePool

    pool = NativePool(4)
    try:
        rng = np.random.default_rng(22)
        src = rng.integers(0, 256, (3 << 20) + 5, dtype=np.uint8)
        dst = np.zeros_like(src)
        w = pool.memcpy(dst, src)
        w.wait()
        assert w.test() and dst.tobytes() == src.tobytes()
        mem = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
        so = np.array([0, 24, 100], np.int64)
        sl = np.array([8, 16, 4], np.int64)
        nelem, extent = 5000, 200
        out = np.zeros(nelem * 28, np.uint8)
        pool.pack(mem, out, so, sl, extent, 3, 7, nelem).wait()
        serial = np.zeros_like(out)
        native.pack_elems(mem, serial, so, sl, extent, 3, 7, nelem)
        idx = np.concatenate([np.arange(o, o + n) for o, n in zip(so, sl)])
        gather = mem[3 + (7 + np.arange(nelem))[:, None] * extent
                     + idx[None, :]].reshape(-1)
        assert out.tobytes() == serial.tobytes() == gather.tobytes()
        back = np.zeros_like(mem)
        pool.unpack(back, out, so, sl, extent, 3, 7, nelem).wait()
        twin = np.zeros_like(mem)
        native.unpack_elems(twin, out, so, sl, extent, 3, 7, nelem)
        assert back.tobytes() == twin.tobytes()
        assert back[3 + 7 * extent:3 + 7 * extent + 8].tobytes() == \
            mem[3 + 7 * extent:3 + 7 * extent + 8].tobytes()
    finally:
        pool.close()


def test_big_host_reductions_fan_out_bit_identically(native_pool):
    """``api/op.py``'s ``_pool_reduce``: an SUM/MAX of 1 MB or more goes
    through the native pool and equals the inline ufunc and the reference's
    op on the same arrays."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.api import op as top

    rng = np.random.default_rng(23)
    a = rng.standard_normal(1 << 19).astype(np.float32)   # 2 MB
    for name in ("SUM", "MAX", "PROD"):
        b1 = rng.standard_normal(1 << 19).astype(np.float32)
        b2 = b1.copy()
        assert top._pool_reduce(getattr(np, {"SUM": "add", "MAX": "maximum",
                                             "PROD": "multiply"}[name]),
                                a, b1)
        getattr(jop, name)(a, b2)
        assert b1.tobytes() == b2.tobytes()
    small = np.ones(8, np.float32)
    assert not top._pool_reduce(np.add, small, small.copy())


def test_the_threads_framework_prefers_native():
    from ompi_tpu_torch.mca.threads import native as tn

    assert tn.COMPONENT.priority == 40 and tn.COMPONENT.open()
    sub = tn.substrate()
    assert sub["available"] and sub["pool"] and sub["reactor"]


def test_the_disable_switch_gives_the_pure_lanes():
    """``OTPU_NATIVE_DISABLE`` keeps every caller of the port on its
    pure-Python lane: no core, the python pool, numpy rings and packs, no
    reactor, coll/sm declining."""
    code = r'''
import numpy as np
from multiprocessing import shared_memory
from ompi_tpu_torch import native
from ompi_tpu_torch.mca.threads import base
from ompi_tpu_torch.mca.btl import sm
from ompi_tpu_torch.datatype import convertor, core
from ompi_tpu_torch.runtime import reactor
shm = shared_memory.SharedMemory(create=True, size=1024)
ring = sm._Ring(shm, owner=True)
c = convertor.Convertor(core.vector(2, 1, 2, core.INT32), 1)
c.prepare(np.zeros(64, np.uint8))
print(native.available(), native.unavailable_reason(),
      type(base.get_pool()).__name__, ring._addr, c._use_native(),
      reactor.engage(), reactor.available())
ring = None
shm.close(); shm.unlink()
'''
    env = dict(os.environ, OTPU_NATIVE_DISABLE="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "OTPU_NATIVE_DISABLE", "is",
                                "set", "PythonPool", "None", "False",
                                "False", "False"]


def test_ctypes_signatures_match_the_source():
    """Every bound entry point exists in the library with the return type
    the source declares (an arity or type slip is silent in ctypes)."""
    lib = native._load()
    src = native._SRC.read_text()
    for name in ("otpu_pack_elems", "otpu_ring_push2", "otpu_pool_reduce",
                 "otpu_reactor_drain", "otpu_atomic_cas_i64"):
        fn = getattr(lib, name)
        assert fn.argtypes is not None and name in src
    assert lib.otpu_ring_peek_len.restype is ctypes.c_int64
