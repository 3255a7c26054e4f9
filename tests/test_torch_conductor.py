"""coll/conductor and coll/self_coll on the CPU lane, held against the JAX
package's: the host entry points on numpy stacks (``sendbuf[i]`` is rank
i's contribution) fold with the ops' numpy host kernels in both packages,
so every result is bit-exact; the same entry points on a tensor return what
the device slot returns; a non-commutative user op folds in rank order;
``agree``; the ``i*`` forms; ``coll_init``'s host branch; COMM_SELF.
These are ``tests/test_coll.py``'s test_host_collectives,
test_nonblocking_host, test_agree, test_comm_self_collectives and
test_comm_dup_split, held against the reference's results.
"""
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from test_torch_comm import _np, _owner, _same


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield jw, ompi_tpu_torch.init(device="cpu")
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _op(pkg, name):
    from ompi_tpu.api import op as jop

    return getattr(jop if pkg == "jax" else ompi_tpu_torch, name)


def _stack(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return rng.integers(-50, 50, shape).astype(np.int64)
    return rng.standard_normal(shape).astype(kind)


#: host entry point -> call(world, op lookup, sendbuf)
HOST_CALLS = {
    "allreduce": lambda w, o, x: w.allreduce(x),
    "allreduce_max": lambda w, o, x: w.allreduce(x, o("MAX")),
    "reduce": lambda w, o, x: w.reduce(x, o("MAX"), root=2),
    "reduce_prod": lambda w, o, x: w.reduce(x, o("PROD"), root=0),
    "gather": lambda w, o, x: w.gather(x, root=1),
    "scatter": lambda w, o, x: w.scatter(x, root=3),
    "allgather": lambda w, o, x: w.allgather(x),
    "bcast": lambda w, o, x: w.bcast(x, root=4),
    "alltoall": lambda w, o, x: w.alltoall(x),
    "reduce_scatter": lambda w, o, x: w.reduce_scatter(x),
    "reduce_scatter_counts": lambda w, o, x: w.reduce_scatter(
        x, [2, 2, 1, 3, 2, 2, 2, 2]),
    "reduce_scatter_block": lambda w, o, x: w.reduce_scatter_block(x),
    "scan": lambda w, o, x: w.scan(x),
    "scan_min": lambda w, o, x: w.scan(x, o("MIN")),
    "exscan": lambda w, o, x: w.exscan(x),
    "iallreduce": lambda w, o, x: w.iallreduce(x).result,
    "ireduce": lambda w, o, x: w.ireduce(x, o("SUM"), 1).result,
    "iallgather": lambda w, o, x: w.iallgather(x).result,
    "ibcast": lambda w, o, x: w.ibcast(x, 2).result,
    "iscan": lambda w, o, x: w.iscan(x).result,
    "iexscan": lambda w, o, x: w.iexscan(x).result,
    "igather": lambda w, o, x: w.igather(x, 0).result,
    "iscatter": lambda w, o, x: w.iscatter(x, 0).result,
    "ireduce_scatter": lambda w, o, x: w.ireduce_scatter(x).result,
    "ireduce_scatter_block": lambda w, o, x: w.ireduce_scatter_block(x).result,
    "gatherv": lambda w, o, x: w.gatherv(list(x)),
    "allgatherv": lambda w, o, x: w.allgatherv(list(x)),
    "scatterv": lambda w, o, x: w.scatterv(list(x)),
    "igatherv": lambda w, o, x: w.igatherv(list(x)).result,
    "iallgatherv": lambda w, o, x: w.iallgatherv(list(x)).result,
    "iscatterv": lambda w, o, x: w.iscatterv(list(x)).result,
}
#: entry points on (n, n, ...) stacks
SQUARE = ("scatter", "alltoall")


@pytest.mark.parametrize("kind", ["float64", "float32", "int64"])
@pytest.mark.parametrize("name", list(HOST_CALLS))
def test_host_entry_matches_reference(worlds, name, kind):
    jw, tw = worlds
    shape = (8, 8, 3) if name in SQUARE else (8, 16)
    x = _stack(kind, shape, seed=len(name))
    want = HOST_CALLS[name](jw, lambda n: _op("jax", n), x)
    got = HOST_CALLS[name](tw, lambda n: _op("torch", n), x)
    _same(got, want, name)


@pytest.mark.parametrize("name", ["alltoallv", "alltoallw", "ialltoallv"])
def test_vector_exchanges_match_reference(worlds, name):
    jw, tw = worlds
    rng = np.random.default_rng(5)
    bufs = [[rng.standard_normal(i + j + 1) for j in range(8)] for i in range(8)]
    call = {"alltoallv": lambda w: w.alltoallv(bufs),
            "alltoallw": lambda w: w.alltoallw(
                bufs, [np.int32 if i % 2 else np.float64 for i in range(8)]),
            "ialltoallv": lambda w: w.ialltoallv(bufs).result}[name]
    _same(call(tw), call(jw), name)


def test_reference_host_collectives(worlds):
    """tests/test_coll.py::test_host_collectives on the port."""
    _, w = worlds
    host = np.arange(16, dtype=np.float64).reshape(8, 2)
    np.testing.assert_allclose(w.allreduce(host), host.sum(0))
    np.testing.assert_allclose(w.allgather(host), host)
    np.testing.assert_allclose(w.reduce(host, ompi_tpu_torch.MAX), host.max(0))
    np.testing.assert_allclose(w.scan(host), np.cumsum(host, 0))
    ex = w.exscan(host)
    assert np.all(ex[0] == 0)
    np.testing.assert_allclose(ex[1:], np.cumsum(host, 0)[:-1])
    a2a = np.arange(8 * 8, dtype=np.int64).reshape(8, 8)
    np.testing.assert_array_equal(w.alltoall(a2a), a2a.T)
    rs = w.reduce_scatter(np.ones((8, 16), np.float32))
    assert np.asarray(rs).shape == (8, 2) and np.all(np.asarray(rs) == 8)


def test_nonblocking_host(worlds):
    _, w = worlds
    req = w.iallreduce(np.ones((8, 2), np.float32))
    req.wait()
    np.testing.assert_allclose(req.result, np.full(2, 8.0))
    assert w.ibarrier().test()[0]
    w.ibarrier().wait()


@pytest.mark.parametrize("flag", [0b1011, [0b1111, 0b0111, 0b1101], 0])
def test_agree(worlds, flag):
    jw, tw = worlds
    assert tw.agree(flag) == jw.agree(flag)


def test_agree_on_a_revoked_comm(worlds):
    """agree checks only that the comm is not freed: ULFM's recovery
    primitive runs on a revoked comm, where every collective raises."""
    from ompi_tpu_torch.api.errors import RevokedError

    _, tw = worlds
    d = tw.dup()
    d.revoked = True
    assert d.agree(0b110) == 0b110
    with pytest.raises(RevokedError):
        d.allreduce(np.ones((8, 1)))


def test_non_commutative_user_op_folds_in_rank_order(worlds):
    """A user op with commute=False: the conductor folds right to left with
    ``inout = in (op) inout``, so the result is b0 (op) (b1 (op) (...
    b7)), the rank order, as the reference's."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.api import op as top

    def compose(invec, inoutvec, datatype=None):
        # 2x2 matrix product in rank order: not commutative
        a = invec.reshape(-1, 2, 2)
        b = inoutvec.reshape(-1, 2, 2)
        inoutvec[...] = np.matmul(a, b).reshape(inoutvec.shape)

    jw, tw = worlds
    x = np.random.default_rng(6).integers(-2, 3, (8, 4)).astype(np.int64)
    got = tw.allreduce(x, top.create(compose, commute=False))
    want = jw.allreduce(x, jop.create(compose, commute=False))
    ordered = x[0].reshape(2, 2)
    for i in range(1, 8):
        ordered = ordered @ x[i].reshape(2, 2)
    _same(got, want)
    np.testing.assert_array_equal(got.reshape(2, 2), ordered)
    _same(tw.scan(x, top.create(compose, commute=False)),
          jw.scan(x, jop.create(compose, commute=False)))


TENSOR_CALLS = {
    "allreduce": (lambda w, x: w.allreduce(x), "allreduce_array",
                  lambda w, x: w.allreduce_array(x)),
    "reduce": (lambda w, x: w.reduce(x, ompi_tpu_torch.SUM, 3),
               "allreduce_array", lambda w, x: w.allreduce_array(x)),
    "bcast": (lambda w, x: w.bcast(x, 5), "bcast_array",
              lambda w, x: w.bcast_array(x, 5)),
    "gather": (lambda w, x: w.gather(x, 2), "allgather_array",
               lambda w, x: w.allgather_array(x)),
    "allgather": (lambda w, x: w.allgather(x), "allgather_array",
                  lambda w, x: w.allgather_array(x)),
    "alltoall": (lambda w, x: w.alltoall(x), "alltoall_array",
                 lambda w, x: w.alltoall_array(x)),
    "reduce_scatter": (lambda w, x: w.reduce_scatter(x), "reduce_scatter_array",
                       lambda w, x: w.reduce_scatter_array(x)),
    "iallreduce": (lambda w, x: w.iallreduce(x).result, "allreduce_array",
                   lambda w, x: w.allreduce_array(x)),
    "scan": (lambda w, x: w.scan(x), "scan_array",
             lambda w, x: w.scan_array(x)),
    "exscan": (lambda w, x: w.exscan(x), "exscan_array",
               lambda w, x: w.exscan_array(x)),
}


@pytest.mark.parametrize("name", list(TENSOR_CALLS))
def test_a_tensor_goes_to_the_device_slot(worlds, name, monkeypatch):
    """A torch tensor passed to a host entry point is forwarded to the
    ``*_array`` slot (called once) and the result is what the slot
    returns; the reference forwards a jax.Array the same way."""
    jw, tw = worlds
    call, slot, direct = TENSOR_CALLS[name]
    square = name in ("alltoall", "reduce_scatter")
    host = _stack("float32", (8, 8, 4) if square else (8, 12), seed=7)
    x = torch.from_numpy(host)
    calls = []
    real = tw.c_coll[slot]
    monkeypatch.setitem(tw.c_coll, slot,
                        lambda *a: calls.append(slot) or real(*a))
    got = call(tw, x)
    assert calls == [slot] and isinstance(got, torch.Tensor)
    _same(got, direct(tw, x))
    jx = next(m for m in jw.coll_modules
              if type(m).__name__ == "XlaCollModule").make_world_array(host)
    jcall = {"reduce": lambda w, a: w.reduce(a, _op("jax", "SUM"), 3)}.get(name)
    want = (jcall or call)(jw, jx)
    if name in ("allreduce", "reduce", "iallreduce", "reduce_scatter"):
        return  # float SUM in two orders: test_torch_comm holds the band
    if name in ("scan", "exscan"):
        return  # the reference folds on the host: pinned below
    _same(got, want, name)


def test_a_tensor_scatter_is_the_reshard(worlds):
    """The conductor's device scatter is coll/builtin's ``reshard``: the
    (n, *S) tensor in row-per-rank layout, as the reference's
    device_put."""
    jw, tw = worlds
    host = _stack("float32", (8, 5), seed=8)
    got = tw.scatter(torch.from_numpy(host))
    assert isinstance(got, torch.Tensor)
    jx = next(m for m in jw.coll_modules
              if type(m).__name__ == "XlaCollModule").make_world_array(host)
    _same(got, jw.scatter(jx))
    _same(got, host)


def test_scan_of_a_tensor_divergence_pinned(worlds):
    """Pinned divergence: scan and exscan of a tensor go to the device
    slots and scan along their combine tree, where the reference's
    conductor stages a jax.Array to the host and folds it there in rank
    order, returning numpy.  The port's result is coll/xla's
    ``scan_array``/``exscan_array`` bit for bit; on this float32 input the
    reference's host fold differs from it in the last bits (within 1e-5);
    on int32 the two agree."""
    jw, tw = worlds
    xla = next(m for m in jw.coll_modules
               if type(m).__name__ == "XlaCollModule")
    for kind in ("float32", "int32"):
        host = _stack(kind if kind == "float32" else "int64", (8, 64),
                      seed=9).astype(kind)
        jx = xla.make_world_array(host)
        for name in ("scan", "exscan"):
            got = getattr(tw, name)(torch.from_numpy(host))
            assert isinstance(got, torch.Tensor)
            _same(got, getattr(jw, f"{name}_array")(jx), f"{name} {kind}")
            folded = getattr(jw, name)(jx)
            assert isinstance(folded, np.ndarray)
            _same(folded, getattr(tw, name)(host), f"host {name} {kind}")
            if kind == "int32":
                _same(got, folded, f"{name} {kind}")
            else:
                assert not np.array_equal(_np(got), folded), name
                np.testing.assert_allclose(_np(got), folded, rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("coll,args", [
    ("barrier", ()), ("allreduce", ("SUM",)), ("scan", ("SUM",)),
    ("reduce_scatter_block", ("MAX",))])
def test_coll_init_host_branch(worlds, coll, args):
    """coll_init's host branch: the template None binds barrier; on a comm
    with no device persistent provider (a dup whose ``persistent_coll``
    slot is emptied, in both packages) a host template binds the blocking
    host collective, and each start re-runs it, as in the reference."""
    jw, tw = worlds
    host = _stack("float64", (8, 16), seed=10)
    reqs = []
    for w, pkg in ((jw, "jax"), (tw, "torch")):
        ops = tuple(_op(pkg, a) for a in args)
        if coll == "barrier":
            req = w.coll_init("barrier")
        else:
            d = w.dup()
            del d.c_coll["persistent_coll"]
            req = d.coll_init(coll, host, *ops)
        for _ in range(2):
            req.start()
            req.wait()
        reqs.append(req)
    if coll == "barrier":
        assert reqs[0].result is None and reqs[1].result is None
    else:
        _same(np.asarray(reqs[1].result), np.asarray(reqs[0].result), coll)


def test_coll_init_device_template(worlds):
    """A numpy template with a device provider binds the device collective,
    in both packages: each start returns the allreduce of the template."""
    jw, tw = worlds
    host = np.ones((8, 3), np.float32)
    req = tw.coll_init("allreduce", host)
    req.start()
    req.wait()
    assert isinstance(req.result, torch.Tensor)
    np.testing.assert_array_equal(_np(req.result), np.full(3, 8.0, np.float32))


def test_coll_init_refuses_what_it_cannot_bind(worlds):
    from ompi_tpu_torch.api.errors import ErrorClass, MpiError

    _, tw = worlds
    with pytest.raises(MpiError) as e:
        tw.coll_init("neighbor_allgather")
    assert e.value.error_class is ErrorClass.ERR_UNSUPPORTED_OPERATION


def test_comm_self_collectives(worlds):
    """tests/test_coll.py::test_comm_self_collectives: COMM_SELF has one
    rank, cid 1, and coll/self_coll owns its host slots."""
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    s, js = trt.comm_self(), jrt.comm_self()
    assert s is ompi_tpu_torch.COMM_SELF
    assert s.size == 1 and s.cid == js.cid == 1 and s.rank == 0
    out = s.allreduce(np.array([3.0]))
    assert out[0] == 3.0
    assert _owner(s, "allreduce") == "SelfCollModule"
    x = np.arange(6.0).reshape(1, 6)
    for name in ("reduce", "allreduce", "scan", "exscan", "bcast",
                 "allgather", "gather", "scatter", "alltoall"):
        args = (_op("jax", "SUM"),) if name in ("reduce", "allreduce",
                                                "scan", "exscan") else ()
        targs = (_op("torch", "SUM"),) if args else ()
        _same(getattr(s, name)(x, *targs), getattr(js, name)(x, *args), name)
    assert s.agree(5) == js.agree(5) == 5
    s.barrier()
    assert s.iallreduce(x).result.tolist() == x.tolist()


def test_comm_dup_split(worlds):
    """tests/test_coll.py::test_comm_dup_split on the port."""
    _, w = worlds
    d = w.dup()
    assert d.cid != w.cid and d.size == 8
    halves = w.split(color=0 if w.rank < 4 else 1, key=0)
    assert halves is not None and halves.size == 8
    d.free()
    assert d.freed


def test_conductor_declines_size_one_and_the_host_world():
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.mca.coll import conductor, self_coll
    from ompi_tpu_torch.rte.base import DeviceWorldRte, SingletonRte

    rte = DeviceWorldRte("cpu", world_size=4)
    one = Comm(Group([0]), 7, rte)
    four = Comm(Group(range(4)), 8, rte)
    assert conductor.COMPONENT.comm_query(one) is None
    assert self_coll.COMPONENT.comm_query(one)[0] == 75
    assert self_coll.COMPONENT.comm_query(four) is None
    host = Comm(Group([0, 1]), 9, SingletonRte())
    assert conductor.COMPONENT.comm_query(host) is None
