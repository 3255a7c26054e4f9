"""The port's OpenSHMEM-style PGAS layer (``ompi_tpu_torch/shmem``: the
symmetric heap over a host, byte-addressed ``Win``, put/get, the atomics,
the strided and non-blocking forms, locks and ``wait_until``, contexts,
active sets, the scoll collectives, ``shmem_ptr`` and ``global_exit``) held
against the JAX package's ``ompi_tpu.shmem`` on the CPU.

* the first-fit allocator: over seeded and generated sequences of allocs
  (sizes and alignments) and frees, every offset, every error and the
  coalesced free list equal the reference allocator's;
* in process, over the device world of ``ompi_tpu_torch.init(device=
  "cpu")``: the heap is a numpy view of the host window, puts, gets and
  atomics land in the target PE's bytes, and ``shmem_ptr`` maps a peer's
  object;
* the reference's ``tpurun`` jobs on the port (``-n 4``, ``-n 3`` for the
  global exit): the PGAS ring (``ompi_tpu_torch/examples/pgas_ring.py``),
  put/get with the atomics and collectives, sync with locks and the
  strided forms, contexts with the bitwise atomics and accessibility, the
  global exit, and the active-set barriers with the info surface, every PE
  checking against numpy.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

REPO = Path(__file__).resolve().parent.parent


def _tpurun(n, args, timeout=120, extra=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", str(n),
         *extra, *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


# ------------------------------------------------------------ the allocator

def _heap(mod, heap_bytes: int):
    heap = mod._Shmem.__new__(mod._Shmem)
    heap.heap_bytes = heap_bytes
    heap.free_list = [(0, heap_bytes)]
    return heap


def _replay(mod, heap_bytes: int, ops) -> list:
    """Run (alloc nbytes align | free k-th live block) ops on a fresh
    heap: each alloc's offset or error class, then the free list."""
    heap = _heap(mod, heap_bytes)
    live, out = [], []
    for op in ops:
        if op[0] == "alloc":
            try:
                off = heap.alloc(op[1], align=op[2])
            except Exception as exc:
                out.append(("err", type(exc).__name__,
                            exc.error_class.name))
                continue
            live.append((off, op[1]))
            out.append(("off", off))
        elif live:
            off, n = live.pop(op[1] % len(live))
            heap.release(off, n)
            out.append(("free", off))
    out.append(("list", [tuple(t) for t in heap.free_list]))
    return out


def test_symmetric_heap_allocator():
    """memheap invariant: collective allocs give identical offsets, and
    free+coalesce reclaims the space (the reference's case, both
    packages)."""
    import ompi_tpu.shmem as jsh
    import ompi_tpu_torch.shmem as tsh

    got = []
    for mod in (tsh, jsh):
        heap = _heap(mod, 1 << 12)
        a = heap.alloc(100)
        b = heap.alloc(200)
        assert a != b and a % 16 == 0 and b % 16 == 0
        heap.release(a, 100)
        heap.release(b, 200)
        c = heap.alloc(1 << 12 - 1)   # coalesced space serves a big block
        assert c == 0
        got.append((a, b, c, heap.free_list))
    assert got[0] == got[1]


_OPS = st.lists(st.one_of(
    st.tuples(st.just("alloc"), st.integers(1, 700),
              st.sampled_from([16, 32, 64, 256, 1024])),
    st.tuples(st.just("free"), st.integers(0, 1 << 20))), max_size=40)


@settings(max_examples=150, deadline=None)
@given(ops=_OPS)
def test_allocator_offsets_match_reference(ops):
    """Any sequence of allocs and frees: the port's offsets, heap-exhausted
    errors and coalesced free list equal the reference's."""
    import ompi_tpu.shmem as jsh
    import ompi_tpu_torch.shmem as tsh

    assert _replay(tsh, 4096, ops) == _replay(jsh, 4096, ops)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_seeded_sequences_match_reference(seed):
    """Long seeded sequences (numpy) over a 64 KiB heap: the same."""
    import ompi_tpu.shmem as jsh
    import ompi_tpu_torch.shmem as tsh

    rng = np.random.default_rng(seed)
    ops = [("alloc", int(rng.integers(1, 4096)),
            int(rng.choice([16, 64, 128, 4096])))
           if rng.random() < 0.6 else ("free", int(rng.integers(0, 1000)))
           for _ in range(400)]
    got = _replay(tsh, 1 << 16, ops)
    assert got == _replay(jsh, 1 << 16, ops)
    assert any(o[0] == "free" for o in got)


# ---------------------------------------------------------------- in process

def test_heap_is_a_host_window_in_the_device_world():
    """Over the device world (every PE in this process): the heap is a
    byte-addressed host window, ``SymArray.local`` a numpy view of it, and
    puts, gets, atomics and ``shmem_ptr`` reach the named PE's bytes."""
    import ompi_tpu_torch
    import ompi_tpu_torch.shmem as shmem
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    shmem.reset_for_testing()
    try:
        ompi_tpu_torch.init(device="cpu")
        ctx = shmem.init(heap_size=1 << 16)
        assert ctx.win.byte_addressed and isinstance(ctx.win.local,
                                                     np.ndarray)
        assert ctx.win.local.dtype == np.uint8
        x = shmem.array(6, np.float64)
        y = shmem.array(3, np.int64)
        assert (x.offset, y.offset) == (0, 48)
        assert isinstance(x.local, np.ndarray)
        assert np.shares_memory(x.local, ctx.win.local)
        vals = np.random.default_rng(5).standard_normal(6)
        shmem.put(x, vals, pe=0)
        np.testing.assert_array_equal(shmem.get(x, 6, pe=0), vals)
        np.testing.assert_array_equal(x.local, vals)
        shmem.atomic_add(y, 7, pe=0, index=2)
        assert shmem.atomic_fetch_add(y, 5, pe=0, index=2) == 7
        assert shmem.atomic_compare_swap(y, 12, 3, pe=0, index=2) == 12
        assert y.local.tolist() == [0, 0, 3]
        ptr = shmem.shmem_ptr(x, 0)
        assert ptr is not None and np.shares_memory(ptr, ctx.win.local)
        shmem.free(y)
        shmem.free(x)
        assert ctx.free_list == [(0, 1 << 16)]
        import ompi_tpu.shmem as jsh

        assert shmem.info_get_version() == jsh.info_get_version()
        assert shmem.info_get_name() == "ompi_tpu_torch-shmem"  # the port's
    finally:
        shmem.finalize()
        shmem.reset_for_testing()
        rt.reset_for_testing()


# ------------------------------------------------------------- tpurun jobs

def test_pgas_ring_example():
    r = _tpurun(4, [sys.executable, "-m", "ompi_tpu_torch.examples.pgas_ring",
                    "--device", "cpu"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "pgas ring OK: 4 PEs, counter 10" in r.stdout


def test_shmem_put_get_atomics_colls(tmp_path):
    script = tmp_path / "shmem_all.py"
    script.write_text(textwrap.dedent("""
        import numpy as np
        import ompi_tpu_torch
        import ompi_tpu_torch.shmem as shmem
        ompi_tpu_torch.init(device="cpu")
        shmem.init()
        me, n = shmem.my_pe(), shmem.n_pes()

        x = shmem.array(4, np.float64)
        x.local[:] = me * 10.0
        shmem.barrier_all()

        # get from right neighbor
        got = shmem.get(x, 4, (me + 1) % n)
        assert got.tolist() == [((me + 1) % n) * 10.0] * 4, got
        shmem.barrier_all()   # everyone done reading before anyone writes

        # put into left neighbor's second element
        shmem.p(x, 500.0 + me, (me - 1) % n, index=1)
        shmem.barrier_all()
        assert x.local[1] == 500.0 + (me + 1) % n, x.local

        # typed atomics on a shared int64 counter at PE 0
        c = shmem.array(1, np.int64)
        c.local[0] = 0
        shmem.barrier_all()
        old = shmem.atomic_fetch_add(c, 1, 0)
        assert 0 <= old < n
        shmem.barrier_all()
        if me == 0:
            assert c.local[0] == n, c.local

        # compare-and-swap: exactly one PE wins the election slot
        e = shmem.array(1, np.int64)
        e.local[0] = -1
        shmem.barrier_all()
        prev = shmem.atomic_compare_swap(e, -1, me, 0)
        shmem.barrier_all()
        winner = int(shmem.g(e, 0))
        assert 0 <= winner < n
        got_it = (prev == -1)
        wins = np.asarray(shmem._get().world.allgather(
            np.array([1 if got_it else 0], np.int64)))
        assert wins.sum() == 1, wins

        # scoll: reductions + collect
        y = shmem.array(2, np.float64)
        y.local[:] = [me + 1.0, me * 2.0]
        shmem.sum_to_all(y)
        assert y.local[0] == n * (n + 1) / 2
        z = shmem.array(1, np.int64)
        z.local[0] = me * me
        coll = shmem.collect(z)
        assert coll.tolist() == [i * i for i in range(n)], coll
        # broadcast
        b = shmem.array(3, np.float64)
        b.local[:] = me
        shmem.broadcast(b, root=2)
        assert b.local.tolist() == [2.0, 2.0, 2.0]

        shmem.barrier_all()
        print(f"shmem OK pe {me}")
    """))
    r = _tpurun(4, [sys.executable, str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("shmem OK") == 4


def test_shmem_sync_locks_strided(tmp_path):
    """wait_until/test, distributed locks, iput/iget, nbi, alltoall,
    bitwise/prod reductions (shmem_lock.c / shmem_iput / wait_until)."""
    script = tmp_path / "shmem_sync.py"
    script.write_text(textwrap.dedent("""
        import numpy as np
        import ompi_tpu_torch
        import ompi_tpu_torch.shmem as shmem
        ompi_tpu_torch.init(device="cpu")
        shmem.init()
        me, n = shmem.my_pe(), shmem.n_pes()

        # wait_until: PE0 signals each peer's flag word in turn
        f = shmem.array(1, np.int64)
        f.local[0] = 0
        shmem.barrier_all()
        if me == 0:
            for pe in range(1, n):
                shmem.p(f, pe * 7, pe)
            shmem.quiet()
        else:
            shmem.wait_until(f, shmem.CMP_EQ, me * 7)
            assert not shmem.test(f, shmem.CMP_NE, me * 7)

        # distributed lock protects a read-modify-write on PE 0
        lock = shmem.array(1, np.int64)
        tot = shmem.array(1, np.int64)
        lock.local[0] = 0
        tot.local[0] = 0
        shmem.barrier_all()
        for _ in range(3):
            shmem.set_lock(lock)
            v = int(shmem.g(tot, 0))
            shmem.p(tot, v + 1, 0)
            shmem.quiet()
            shmem.clear_lock(lock)
        shmem.barrier_all()
        if me == 0:
            assert tot.local[0] == 3 * n, tot.local
            # free lock: try-acquire succeeds; a second try fails until
            # the holder clears it
            assert shmem.test_lock(lock) is True
            assert shmem.test_lock(lock) is False
            shmem.clear_lock(lock)
        shmem.barrier_all()

        # strided iput/iget: write every 2nd slot of the right neighbor
        s = shmem.array(8, np.float64)
        s.local[:] = -1.0
        shmem.barrier_all()
        shmem.iput(s, np.array([me, me, me, me], float), tst=2, sst=1,
                   count=4, pe=(me + 1) % n)
        shmem.barrier_all()
        left = (me - 1) % n
        assert s.local[::2].tolist() == [left] * 4, s.local
        back = shmem.iget(s, tst=1, sst=2, count=4, pe=me)
        assert back.tolist() == [left] * 4

        # nbi put completes by quiet
        q = shmem.array(1, np.float64)
        q.local[0] = 0
        shmem.barrier_all()
        shmem.put_nbi(q, np.array([me + 1.0]), (me + 1) % n)
        shmem.quiet()
        shmem.barrier_all()
        assert q.local[0] == ((me - 1) % n) + 1.0

        # alltoall + prod/bitwise reductions
        a = shmem.array(n, np.int64)
        a.local[:] = [me * n + j for j in range(n)]
        out = shmem.alltoall(a)
        assert out.tolist() == [j * n + me for j in range(n)], out
        pr = shmem.array(1, np.int64)
        pr.local[0] = me + 1
        shmem.prod_to_all(pr)
        import math
        assert pr.local[0] == math.factorial(n)
        bw = shmem.array(1, np.int64)
        bw.local[0] = 1 << me
        shmem.or_to_all(bw)
        assert bw.local[0] == (1 << n) - 1

        shmem.barrier_all()
        print(f"shmem sync OK pe {me}")
    """))
    r = _tpurun(4, [sys.executable, str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("shmem sync OK") == 4


def test_shmem_contexts_bitwise_accessibility(tmp_path):
    """shmem_ctx_* ordering domains, bitwise/set atomics, strided
    alltoalls, pe/addr accessibility, calloc/align/realloc
    (oshmem/include/shmem.h.in:180-207 families)."""
    script = tmp_path / "shmem_new.py"
    script.write_text(textwrap.dedent("""
        import numpy as np
        import ompi_tpu_torch
        import ompi_tpu_torch.shmem as shmem

        ompi_tpu_torch.init(device="cpu")
        shmem.init()
        me, n = shmem.my_pe(), shmem.n_pes()

        # -- contexts: independent issue streams, implicit quiet on destroy
        flags = shmem.calloc(1, np.int64)
        shmem.barrier_all()
        ctx = shmem.ctx_create(shmem.Ctx.PRIVATE)
        ctx.atomic_add(flags, 1, pe=0)
        ctx.quiet()
        shmem.barrier_all()
        if me == 0:
            assert flags.local[0] == n, flags.local
        shmem.ctx_destroy(ctx)
        try:
            ctx.put(flags, 1, 0)
            raise SystemExit("destroyed ctx accepted an op")
        except Exception:
            pass
        # default context is always usable
        shmem.CTX_DEFAULT.fence()

        # -- bitwise + set atomics
        bits = shmem.calloc(1, np.int64)
        shmem.barrier_all()
        shmem.atomic_or(bits, 1 << me, pe=0)
        shmem.quiet()
        shmem.barrier_all()
        if me == 0:
            assert bits.local[0] == (1 << n) - 1, bits.local
        shmem.barrier_all()
        old = shmem.atomic_fetch_and(bits, ~(1 << me), pe=0)
        assert old >= 0
        shmem.barrier_all()
        if me == 0:
            assert bits.local[0] == 0, bits.local
        shmem.barrier_all()   # readers finish before the next mutation
        shmem.atomic_set(bits, 7, pe=0)
        shmem.barrier_all()
        if me == 0:
            assert bits.local[0] == 7
        shmem.barrier_all()
        x = shmem.calloc(1, np.int64)
        shmem.barrier_all()
        shmem.atomic_xor(x, me + 1, pe=(me + 1) % n)
        shmem.quiet()
        shmem.barrier_all()
        assert x.local[0] == ((me - 1) % n) + 1, x.local

        # -- strided alltoalls (spec: src index sst*(j*ne+k))
        ne, sst, dst = 2, 2, 3
        a = shmem.array(dst * n * ne, np.int64)
        a.local[:] = -1
        a.local[: sst * n * ne : sst] = [
            me * 100 + v for v in range(n * ne)]
        shmem.barrier_all()
        got = shmem.alltoalls(a, dst=dst, sst=sst, nelems=ne)
        want = []
        for j in range(n):
            want += [j * 100 + me * ne, j * 100 + me * ne + 1]
        assert got.tolist() == want, (got.tolist(), want)
        assert a.local[: dst * n * ne : dst].tolist() == want

        # -- accessibility + ptr
        assert shmem.pe_accessible(me) and shmem.pe_accessible(0)
        assert not shmem.pe_accessible(n) and not shmem.pe_accessible(-1)
        assert shmem.addr_accessible(a, (me + 1) % n)
        ptr = shmem.shmem_ptr(a, me)
        assert ptr is not None and ptr[0] == a.local[0]

        # -- allocation variants
        c = shmem.calloc(8, np.float32)
        assert c.local.tolist() == [0.0] * 8
        al = shmem.align(256, 4, np.float64)
        assert al.offset % 256 == 0
        al.local[:] = me
        r = shmem.realloc(al, 8)
        assert r.count == 8 and r.local[:4].tolist() == [me] * 4

        print(f"SHMEM NEW OK {me}", flush=True)
        shmem.finalize()
    """))
    r = _tpurun(4, [sys.executable, str(script)])
    assert r.stdout.count("SHMEM NEW OK") == 4, r.stdout + r.stderr
    assert r.returncode == 0, r.stdout + r.stderr


def test_shmem_global_exit(tmp_path):
    """shmem_global_exit terminates every PE with the given status."""
    script = tmp_path / "gexit.py"
    script.write_text(textwrap.dedent("""
        import time
        import ompi_tpu_torch
        import ompi_tpu_torch.shmem as shmem

        ompi_tpu_torch.init(device="cpu")
        shmem.init()
        shmem.barrier_all()
        if shmem.my_pe() == 1:
            shmem.global_exit(3)
        time.sleep(30)   # never reached on any PE if global_exit works
        print("SURVIVED", flush=True)
    """))
    r = _tpurun(3, [sys.executable, str(script)], timeout=60)
    assert "SURVIVED" not in r.stdout, r.stdout + r.stderr
    assert r.returncode != 0


def test_shmem_active_set_barrier_sync_info(tmp_path):
    """shmem_barrier/sync over a (PE_start, logPE_stride, PE_size)
    active set + the info/version and deprecated cache no-op surface."""
    script = tmp_path / "aset.py"
    script.write_text("""
import numpy as np
import ompi_tpu_torch
import ompi_tpu_torch.shmem as sh

ompi_tpu_torch.init(device="cpu")
sh.init()
me, n = sh.my_pe(), sh.n_pes()
assert sh.info_get_version()[0] >= 1
assert "shmem" in sh.info_get_name()
sh.set_cache_inv(); sh.udcflush(); sh.clear_cache_line_inv(0)

flag = sh.array(4, np.int64)
flag.local[:] = 0
# active set = even PEs (stride 2^1): they barrier among themselves
# while odd PEs only make the collective split calls
evens = list(range(0, n, 2))
if me in evens:
    sh.p(flag, me + 1, me, index=me)
    sh.barrier(0, 1, len(evens))     # quiet + subset barrier
    sh.barrier(0, 1, len(evens))     # repeat: cached comm, no re-split
    # after the subset barrier every even PE sees every even PE's put
    for pe in evens:
        got = sh.g(flag, pe, index=pe)
        assert got == pe + 1, (me, pe, got)
else:
    pass   # odd PEs NEVER call: create_group is non-collective over
           # the world — the OpenSHMEM active-set contract
sh.sync_all()
sh.sync(0, 0, n)                     # whole-world active set
sh.barrier()                         # default = all PEs
sh.finalize()
print("aset ok", flush=True)
""")
    r = _tpurun(4, [sys.executable, str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("aset ok") == 4
