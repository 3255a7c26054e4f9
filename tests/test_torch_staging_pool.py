"""The host staging pool of ``torch_acc`` (the rcache/grdma reuse analog),
held against the JAX package's ``jax_acc``: ``tests/test_staging_pool.py``'s
cases run on both pools, the hit and miss counts (and pooled bytes) equal
to the reference's after every step of the same sequence; the ring
allreduce's reuse across repeated calls on the threads harness; and
concurrent double releases of one adopted owner, which must never repool
two aliases of one block.
"""
import threading

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.mca.accelerator import jax_acc
from ompi_tpu_torch.mca.accelerator import torch_acc

from test_torch_coll_algorithms import spmd

POOLS = {"jax": jax_acc._StagingPool, "torch": torch_acc._StagingPool}


def _addr(a):
    return a.__array_interface__["data"][0]


def _trace(pool_cls, steps):
    """Run ``steps(pool, note)`` on a fresh pool; ``note()`` records the
    counters after each step."""
    seen = []

    def note():
        seen.append((pool.hits, pool.misses, pool._bytes))

    pool = pool_cls(max_bytes=1 << 20)
    steps(pool, note)
    return seen, pool


def _both(steps):
    got = {k: _trace(cls, steps) for k, cls in POOLS.items()}
    assert got["torch"][0] == got["jax"][0]
    return got["torch"][1]


def test_hit_miss_and_reuse():
    def steps(p, note):
        a = p.acquire(100, np.float32)
        note()
        base, ptr = a.base, _addr(a)
        p.release(a)
        note()
        b = p.acquire(100, np.float32)
        assert b.base is base and _addr(b) == ptr
        assert b.shape == (100,) and b.dtype == np.float32
        note()
        p.release(b)
        c = p.acquire(101, np.float32)      # 404 bytes, same 512 B class
        assert c.shape == (101,)
        note()
        p.acquire(100, np.float64)          # 800 bytes -> 1 KB class
        note()

    p = _both(steps)
    assert (p.hits, p.misses) == (2, 2)


def test_noncontiguous_release_warns_once(capfd):
    for cls in POOLS.values():
        p = cls(max_bytes=1 << 20)
        arr = np.empty((8, 8), np.float32)
        p.release(arr.T)                    # non-C-contiguous
        err = capfd.readouterr().err
        assert "non-C-contiguous" in err or "staging" in err
        p.release(arr.T)                    # once per pool
        assert "non-C-contiguous" not in capfd.readouterr().err
        assert p.acquire(64, np.float32) is not None
        assert p.hits == 0


def test_views_never_pooled():
    def steps(p, note):
        a = p.acquire(10, np.float32)
        p.release(a[:5])                # view: its base owns the memory
        note()
        p.acquire(5, np.float32)
        note()

    assert _both(steps).hits == 0


def test_foreign_double_release_never_aliases():
    def steps(p, note):
        owner = np.empty(512, np.uint8)     # a foreign owner, adopted
        p.release(owner)
        note()
        p.release(owner)                    # double release: dropped
        note()
        a = p.acquire(512, np.uint8)
        b = p.acquire(512, np.uint8)
        note()
        assert _addr(a) != _addr(b)

    _both(steps)


def test_eviction_skips_bins_emptied_by_acquire():
    def steps(p, note):
        p.max_bytes = 1024
        a = p.acquire(256, np.uint8)        # 256 B class
        p.release(a)
        p.acquire(256, np.uint8)            # empties the 256 B bin
        note()
        big = [p.acquire(512, np.uint8) for _ in range(4)]
        for b in big:                       # eviction passes
            p.release(b)
            note()
        assert p._bytes <= 1024

    _both(steps)


def test_lru_eviction_bound():
    def steps(p, note):
        p.max_bytes = 1000
        bufs = [p.acquire(100, np.uint8) for _ in range(20)]
        note()
        for b in bufs:
            p.release(b)
            note()
        assert p._bytes <= 1000

    _both(steps)


def test_disabled_passthrough():
    def steps(p, note):
        p.enabled = False
        a = p.acquire(7, np.int32)
        p.release(a)
        b = p.acquire(7, np.int32)
        assert b is not a
        note()

    assert _both(steps).hits == 0


def test_mixed_sequence_counts_like_the_reference():
    """A longer sequence over several classes, odd sizes and adopted
    owners: the counters match the reference's after every step."""
    def steps(p, note):
        rng = np.random.default_rng(5)
        held = []
        for i in range(200):
            if held and rng.random() < 0.45:
                p.release(held.pop(int(rng.integers(len(held)))))
            elif rng.random() < 0.1:
                p.release(np.empty(int(rng.integers(1, 5000)), np.uint8))
            else:
                n = int(rng.integers(1, 70000))
                held.append(p.acquire(n, [np.float32, np.float64,
                                          np.int8][i % 3]))
            note()

    _both(steps)


def test_vars_are_registered_under_the_port():
    from ompi_tpu_torch.base.var import registry

    assert registry.lookup("otpu_accelerator_torch_staging_pool").value is True
    assert int(registry.lookup(
        "otpu_accelerator_torch_staging_pool_bytes").value) == 64 << 20
    assert torch_acc.staging.max_bytes == 64 << 20


def test_concurrent_double_release_never_aliases():
    """Threads releasing the same adopted owner at once, and others
    acquiring its class: the owner is pooled once, so no two live
    checkouts share bytes (the RLock covers the checkout table)."""
    for _ in range(20):
        p = torch_acc._StagingPool(max_bytes=1 << 20)
        owner = np.empty(4096, np.uint8)
        gate = threading.Barrier(8)
        got = []
        lock = threading.Lock()

        def worker(i):
            gate.wait()
            if i % 2:
                p.release(owner)
            else:
                a = p.acquire(4096, np.uint8)
                with lock:
                    got.append(a)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        got += [p.acquire(4096, np.uint8) for _ in range(4)]
        addrs = [_addr(a) for a in got]
        assert len(addrs) == len(set(addrs)), addrs
        assert p.hits <= 1


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": (jw, jax_acc, ompi_tpu),
           "torch": (ompi_tpu_torch.init(device="cpu"), torch_acc,
                     ompi_tpu_torch)}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def test_ring_allreduce_reuses_staging(worlds):
    """Repeated host-path ring allreduces (eight rank threads sharing the
    module's pool): after the first sweep warmed it, later sweeps hit, and
    the results are the reference's bit for bit."""
    x = np.arange(64 * 8, dtype=np.float64)
    out = {}
    for name, (w, acc, pkg) in worlds.items():
        algs = __import__(f"{pkg.__name__}.mca.coll.algorithms",
                          fromlist=["x"])
        acc.staging.clear()
        for _ in range(3):
            res = spmd(w, lambda me, i: algs.allreduce_ring(me, x + i))
        out[name] = [r.tobytes() for r in res]
        assert acc.staging.hits > 0, (name, acc.staging.stats())
        assert acc.staging.misses <= w.size, (name, acc.staging.stats())
    assert out["torch"] == out["jax"]
