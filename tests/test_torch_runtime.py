"""The host tier's runtime pieces held against the JAX package's, on the
same seeded inputs: the containers, the threads framework's python pool,
the request families over the progress engine, and the coordination
service (KV, put-if-absent, fetch-add, fences, events) in one process.
"""
import threading

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch


def _mod(pkg, name):
    return __import__(f"{pkg}.{name}", fromlist=["x"])


PKGS = ("ompi_tpu", "ompi_tpu_torch")


def _both(fn):
    got = [fn(pkg) for pkg in PKGS]
    assert got[1] == got[0]
    return got[1]


def test_containers_match():
    def run(pkg):
        c = _mod(pkg, "base.containers")
        f = c.Fifo()
        for i in range(5):
            f.push(i)
        fifo = [f.pop() for _ in range(6)]
        pa = c.PointerArray(lowest_free=1)
        ids = [pa.add(x) for x in "abc"]
        pa.remove(ids[1])
        ids.append(pa.add("d"))
        b = c.Bitmap(8)
        for bit in (0, 1, 3):
            b.set(bit)
        first = b.find_and_set_first_unset()
        return fifo, ids, list(pa), first, list(b), b.popcount()

    assert _both(run)[3] == 2


@pytest.mark.parametrize("job", ["memcpy", "sum", "max", "prod"])
def test_python_pool_matches(job):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(100_003).astype(np.float32)
    b = rng.standard_normal(100_003).astype(np.float32)

    def run(pkg):
        pool = _mod(pkg, "mca.threads.python").COMPONENT.make_pool(3)
        try:
            acc = a.copy()
            if job == "memcpy":
                work = pool.memcpy(acc, b)
            else:
                work = pool.reduce(job, acc, b)
            work.wait()
            return work.test(), acc.tobytes()
        finally:
            pool.close()

    assert _both(run)[0] is True


def test_pool_after_finalize_is_inline_serial():
    """After the permanent shutdown (finalize) the pool is the threadless
    InlineSerialPool; the next init re-arms the lazy pool (the native
    core's pool where it is built, else the python one)."""
    from ompi_tpu_torch import native
    from ompi_tpu_torch.mca.threads import base as tbase
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    ompi_tpu_torch.init(device="cpu")
    assert type(tbase.get_pool()).__name__ == (
        "NativePool" if native.available() else "PythonPool")
    rt.finalize()
    pool = tbase.get_pool()
    assert isinstance(pool, tbase.InlineSerialPool)
    acc, src = np.arange(6.0), np.ones(6)
    pool.reduce("sum", acc, src).wait()
    assert acc.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    rt.reset_for_testing()


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"ompi_tpu": jw, "ompi_tpu_torch": ompi_tpu_torch.init(device="cpu")}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def test_request_families_match(worlds):
    """waitany / waitsome / testall / testany / testsome over receives
    that complete as their sends arrive, and the empty / inactive cases."""
    def run(pkg):
        w, rq = worlds[pkg], _mod(pkg, "api.request")
        st = lambda s: None if s is None else (s.source, s.tag, s._nbytes)
        bufs = [np.zeros(2) for _ in range(3)]
        reqs = [w.as_rank(1).irecv(b, source=0, tag=40 + i)
                for i, b in enumerate(bufs)]
        seen = [rq.testall(reqs)[0], rq.testany(reqs)[:2],
                rq.testsome(reqs)]
        w.as_rank(0).send(np.array([1.0, 2.0]), dest=1, tag=41)
        i, s = rq.waitany(reqs)
        seen.append((i, st(s)))
        w.as_rank(0).send(np.array([3.0, 4.0]), dest=1, tag=40)
        idx, stats = rq.waitsome(reqs)
        seen.append((idx, [st(s) for s in stats]))
        w.as_rank(0).send(np.array([5.0, 6.0]), dest=1, tag=42)
        ok, stats = rq.testall(reqs)
        seen.append((ok, [st(s) for s in stats]))
        seen.append([b.tolist() for b in bufs])
        inactive = w.as_rank(1).recv_init(np.zeros(1), source=0, tag=49)
        seen += [rq.waitany([inactive])[0], rq.testany([inactive])[:2],
                 rq.waitsome([]), rq.testsome([inactive])]
        return seen

    got = _both(run)
    assert got[3][0] == 1 and got[-5] == [[3.0, 4.0], [1.0, 2.0], [5.0, 6.0]]


def test_coordination_service_matches():
    """One server and three clients in this process: the modex KV (a
    blocking get waits for the put), put-if-absent, fetch-add, a fence
    and the event stream."""
    def run(pkg):
        coord = _mod(pkg, "rte.coord")
        srv = coord.CoordServer(3)
        cs = [coord.CoordClient(addr=srv.addr) for _ in range(3)]
        try:
            late = threading.Timer(0.2, lambda: cs[1].put(1, "ep", [1, 2]))
            late.start()
            got = [cs[0].get(1, "ep"), cs[2].get(2, "none", wait=False)]
            late.join()
            got += [cs[0].put_new(-1, "cid", 7), cs[1].put_new(-1, "cid", 9)]
            got += [cs[r].fetch_add(-1, "ctr", 5) for r in range(3)]
            fenced = []
            ts = [threading.Thread(target=lambda r=r: (
                cs[r].fence("f1", rank=r), fenced.append(r)))
                for r in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            got.append(sorted(fenced))
            cs[2].event_publish("hello", {"x": 1})
            got.append([(n, p) for _, n, p in cs[0].event_poll()])
            got.append(cs[0].event_poll())
            return got
        finally:
            for c in cs:
                c.close()
            srv.close()

    got = _both(run)
    assert got[0] == [1, 2] and got[1] is None and got[2:4] == [7, 7]
