"""coll/libnbc on the CPU lane, held against the JAX package's module: every
``i*`` schedule SPMD over the threads harness on 8 and 5 ranks, each
rank's result bit-identical to the reference's (float64, float32, int32,
and a non-commutative op where the collective reduces); a request left
incomplete until the progress engine advances it, its progress callback
gone once it completes; and several schedules in flight on one comm,
completed out of issue order, without cross-matching.
"""
import numpy as np
import pytest

from ompi_tpu.api import request as jreq
from ompi_tpu.mca.coll import libnbc as jnbc
from ompi_tpu_torch.api import request as treq
from ompi_tpu_torch.mca.coll import libnbc as tnbc

from test_torch_coll_algorithms import (NS, _nc_data, both, comms,  # noqa: F401
                                        rank_data, signed_product, spmd)

NBC = {"jax": jnbc.LibnbcModule(), "torch": tnbc.LibnbcModule()}
WAITALL = {"jax": jreq.waitall, "torch": treq.waitall}
DTYPES = (np.float64, np.float32, np.int32)


def run(comms, nranks, call):
    """``call(nbc, comm, rank, ns)`` returns a request; both packages wait
    on it and their results must be bit-identical."""
    def body(c, r, ns):
        nbc = NBC["jax" if ns is NS["jax"] else "torch"]
        req = call(nbc, c, r, ns)
        req.wait()
        return req.result
    return both(comms, nranks, body)


@pytest.mark.parametrize("nranks", [8, 5])
def test_ibarrier(comms, nranks):
    run(comms, nranks, lambda nbc, c, r, ns: nbc.ibarrier(c))


@pytest.mark.parametrize("nranks,root", [(8, 0), (8, 5), (5, 2)])
def test_ibcast(comms, nranks, root):
    for dt in DTYPES:
        data = rank_data(1, 300, dt, seed=1)[0]
        out = run(comms, nranks, lambda nbc, c, r, ns: nbc.ibcast(
            c, data if r == root else np.zeros_like(data), root))
        np.testing.assert_array_equal(out[nranks - 1], data)


@pytest.mark.parametrize("nranks", [8, 5])
def test_iallreduce(comms, nranks):
    for nelem in (1, nranks, 257):
        for dt in DTYPES:
            data = rank_data(nranks, nelem, dt, seed=nelem)
            run(comms, nranks, lambda nbc, c, r, ns: nbc.iallreduce(
                c, data[r], ns.op.SUM))
        nc = _nc_data(nranks, nelem, seed=nelem + 1)
        run(comms, nranks, lambda nbc, c, r, ns: nbc.iallreduce(
            c, nc[r], signed_product(ns)))


@pytest.mark.parametrize("nranks,root", [(8, 0), (8, 3), (5, 4)])
def test_ireduce(comms, nranks, root):
    for dt in DTYPES:
        data = rank_data(nranks, 50, dt, seed=2)
        out = run(comms, nranks, lambda nbc, c, r, ns: nbc.ireduce(
            c, data[r], ns.op.SUM, root))
        assert all(out[r] is None for r in range(nranks) if r != root)
    nc = _nc_data(nranks, 50, seed=3)
    run(comms, nranks, lambda nbc, c, r, ns: nbc.ireduce(
        c, nc[r], signed_product(ns), root))


@pytest.mark.parametrize("nranks", [8, 5])
def test_iallgather(comms, nranks):
    for shape in ((1,), (9,), (2, 3)):
        data = rank_data(nranks, int(np.prod(shape)), np.float32,
                         seed=4).reshape(nranks, *shape)
        out = run(comms, nranks, lambda nbc, c, r, ns: nbc.iallgather(
            c, data[r]))
        np.testing.assert_array_equal(out[0], data)


@pytest.mark.parametrize("nranks", [8, 5])
def test_ialltoall(comms, nranks):
    data = rank_data(nranks, nranks * 3, np.int32,
                     seed=5).reshape(nranks, nranks, 3)
    out = run(comms, nranks, lambda nbc, c, r, ns: nbc.ialltoall(c, data[r]))
    for r in range(nranks):
        np.testing.assert_array_equal(out[r], data[:, r])


@pytest.mark.parametrize("nranks,root", [(8, 0), (5, 3)])
def test_igather_iscatter(comms, nranks, root):
    data = rank_data(nranks, 7, np.float64, seed=6)
    out = run(comms, nranks, lambda nbc, c, r, ns: nbc.igather(
        c, data[r], root))
    np.testing.assert_array_equal(out[root], data)
    out = run(comms, nranks, lambda nbc, c, r, ns: nbc.iscatter(
        c, data if r == root else np.zeros(7), root))
    for r in range(nranks):
        np.testing.assert_array_equal(out[r], data[r])


@pytest.mark.parametrize("nranks", [8, 5])
def test_ireduce_scatter(comms, nranks):
    for dt in DTYPES:
        data = rank_data(nranks, nranks * 4 + 1, dt, seed=7)
        run(comms, nranks, lambda nbc, c, r, ns: nbc.ireduce_scatter(
            c, data[r], None, ns.op.SUM))
    counts = [(k * 5) % 3 for k in range(nranks)]
    data = rank_data(nranks, sum(counts), np.float64, seed=8)
    run(comms, nranks, lambda nbc, c, r, ns: nbc.ireduce_scatter(
        c, data[r], counts, ns.op.SUM))
    nc = _nc_data(nranks, nranks * 2, seed=9)
    run(comms, nranks, lambda nbc, c, r, ns: nbc.ireduce_scatter(
        c, nc[r], None, signed_product(ns)))


@pytest.mark.parametrize("nranks", [8, 5])
def test_iscan_iexscan(comms, nranks):
    for dt in DTYPES:
        data = rank_data(nranks, 20, dt, seed=10)
        run(comms, nranks, lambda nbc, c, r, ns: nbc.iscan(
            c, data[r], ns.op.SUM))
        run(comms, nranks, lambda nbc, c, r, ns: nbc.iexscan(
            c, data[r], ns.op.SUM))
    nc = _nc_data(nranks, 20, seed=11)
    run(comms, nranks, lambda nbc, c, r, ns: nbc.iscan(
        c, nc[r], signed_product(ns)))
    run(comms, nranks, lambda nbc, c, r, ns: nbc.iexscan(
        c, nc[r], signed_product(ns)))


def test_several_in_flight(comms):
    """Schedules outstanding at once on one comm, completed out of issue
    order: each draws its own tag, so none cross-matches."""
    d1 = rank_data(8, 16, np.float64, seed=12)
    d2 = rank_data(8, 16, np.float64, seed=13)
    d3 = np.arange(64, dtype=np.float64)

    def body(c, r, ns):
        pkg = "jax" if ns is NS["jax"] else "torch"
        nbc = NBC[pkg]
        reqs = [nbc.iallreduce(c, d1[r], ns.op.SUM),
                nbc.iallreduce(c, d2[r], ns.op.MAX),
                nbc.ibcast(c, d3 if r == 2 else np.zeros_like(d3), 2),
                nbc.ibarrier(c),
                nbc.iallgather(c, d1[r][:3])]
        WAITALL[pkg]([reqs[2], reqs[4], reqs[0], reqs[3], reqs[1]])
        return [q.result for q in reqs if q.result is not None]

    out = both(comms, 8, body)
    np.testing.assert_array_equal(out[5][1], d2.max(0))
    np.testing.assert_array_equal(out[5][2], d3)


def test_a_request_waits_for_the_progress_engine(comms):
    """A non-root's ibcast stays incomplete until the root posts and the
    progress engine advances it; once complete, its progress callback is
    gone, so later progress calls do not pay for it."""
    from ompi_tpu_torch.runtime import progress

    seen = {}
    for pkg in ("jax", "torch"):
        w = comms[pkg][8]
        pair = w.create(w.group.incl([0, 1]))
        nbc = NBC[pkg]
        data = np.arange(10, dtype=np.float32)
        n0 = len(progress._callbacks) if pkg == "torch" else None
        req1 = nbc.ibcast(pair.as_rank(1), np.zeros(10, np.float32), 0)
        assert not req1.complete_flag and not req1.test()[0]
        if pkg == "torch":
            assert len(progress._callbacks) == n0 + 1
        req0 = nbc.ibcast(pair.as_rank(0), data, 0)
        assert not req1.complete_flag     # sent, not yet progressed
        req1.wait()
        req0.wait()
        if pkg == "torch":
            progress.progress()
            assert len(progress._callbacks) == n0
        seen[pkg] = req1.result.tobytes()
        pair.free()
    assert seen["torch"] == seen["jax"] == \
        np.arange(10, dtype=np.float32).tobytes()


def test_a_tensor_is_staged_once(comms):
    import torch

    data = rank_data(8, 33, np.float32, seed=14)
    got = spmd(comms["torch"][8], lambda c, r: NBC["torch"].iallgather(
        c, torch.from_numpy(data[r])))
    for q in got:
        q.wait()
        assert isinstance(q.result, np.ndarray)
        np.testing.assert_array_equal(q.result, data)
