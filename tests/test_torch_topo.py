"""Process topologies on the CPU lane, held against the JAX package:
``dims_create`` over every ``nnodes`` up to 64 and ``ndims`` up to 4 (fixed
dims included, errors by class), the cartesian coords, shifts and
neighbor lists of periodic and non-periodic grids, graph and
distributed-graph neighbors, and the device world's ``cart_create``,
``cart_sub``, ``graph_create``, ``dist_graph_create_adjacent``,
``split_type`` and neighbor collectives (a periodic size-2 ring, where one
neighbor appears twice, included), all exactly.  Collectives on cart rows
take the raised ring (K3, K4, K12's plain versions here, interpret mode in
the reference) on integer-valued inputs, so their results compare bit for
bit whatever the SUM order.  The divergence of a tensor table (the port
returns clones of its rows on the tensor's device; the reference turns
its ``jax.Array`` into numpy) is pinned.
"""
import itertools

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.api.errors import MpiError as JMpiError
from ompi_tpu.api.status import PROC_NULL as JPROC_NULL
from ompi_tpu.mca import topo as jtopo
from ompi_tpu_torch.api.errors import MpiError as TMpiError
from ompi_tpu_torch.api.status import PROC_NULL
from ompi_tpu_torch.mca import topo as ttopo
from test_torch_comm import _owner, _same
from test_torch_world import ring_worlds  # noqa: F401


def _outcome(fn, *args):
    """A call's result, or its error class."""
    try:
        return fn(*args)
    except (JMpiError, TMpiError) as exc:
        return ("error", int(exc.error_class))


def _fixed_patterns(ndims):
    """dims lists with some entries fixed: each position fixed to 1, 2 or
    3 on its own, and every position fixed to 2."""
    out = [None]
    for i, v in itertools.product(range(ndims), (1, 2, 3)):
        d = [0] * ndims
        d[i] = v
        out.append(d)
    out.append([2] * ndims)
    return out


@pytest.mark.parametrize("ndims", [1, 2, 3, 4])
def test_dims_create_matches_the_reference(ndims):
    assert JPROC_NULL == PROC_NULL
    for nnodes in range(1, 65):
        for dims in _fixed_patterns(ndims):
            want = _outcome(jtopo.dims_create, nnodes, ndims, dims)
            got = _outcome(ttopo.dims_create, nnodes, ndims, dims)
            assert got == want, (nnodes, ndims, dims)


def test_dims_create_refuses_like_the_reference():
    for args in ((8, 2, [2, 3]), (7, 2, [2, 0]), (8, 3, [2, 2]),
                 (8, 2, [-1, 0])):
        want = _outcome(jtopo.dims_create, *args)
        assert want[0] == "error"
        assert _outcome(ttopo.dims_create, *args) == want, args


GRIDS = [([4], [False]), ([4], [True]), ([2], [True]), ([2, 4], [True, False]),
         ([3, 2, 2], [False, True, False]), ([1, 5], [True, True]),
         ([2, 2, 2, 2], [True, False, True, False])]


@pytest.mark.parametrize("dims,periods", GRIDS,
                         ids=[f"{d}-{p}" for d, p in GRIDS])
def test_cart_topology_matches_the_reference(dims, periods):
    j, t = jtopo.CartTopo(dims, periods), ttopo.CartTopo(dims, periods)
    assert (t.size, t.ndims, t.kind) == (j.size, j.ndims, j.kind)
    for r in range(t.size):
        assert t.coords_of(r) == j.coords_of(r)
        assert t.rank_of(t.coords_of(r)) == r
        assert t.neighbors(r) == j.neighbors(r)
        for d in range(t.ndims):
            for disp in (-2, -1, 1, 2, 3):
                assert t.shift(r, d, disp) == j.shift(r, d, disp)
    for coords in itertools.product(*[range(-1, x + 1) for x in dims]):
        assert t.rank_of(coords) == j.rank_of(coords)
    assert _outcome(t.shift, 0, len(dims), 1) == \
        _outcome(j.shift, 0, len(dims), 1)


def test_graph_topologies_match_the_reference():
    index, edges = [2, 4, 6, 8], [1, 3, 0, 2, 1, 3, 0, 2]
    j, t = jtopo.GraphTopo(index, edges), ttopo.GraphTopo(index, edges)
    for r in range(4):
        assert t.neighbors_of(r) == j.neighbors_of(r)
        assert t.neighbors(r) == j.neighbors(r)
    j = jtopo.DistGraphTopo([1, 2], [3], destweights=[5])
    t = ttopo.DistGraphTopo([1, 2], [3], destweights=[5])
    assert (t.neighbors(0), t.sourceweights, t.destweights) == \
        (j.neighbors(0), j.sourceweights, j.destweights)


@pytest.fixture
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


def _shape(c):
    """What a comm's topology looks like from its conductor rank."""
    if c is None:
        return None
    out = {"ranks": list(c.group.world_ranks), "test": c.topo_test(),
           "size": c.size, "epoch": c.epoch}
    if c.topo_test() == "cart":
        out["get"] = c.cart_get()
        out["shift"] = [c.cart_shift(d, 1) for d in range(c.topo.ndims)]
        out["rank"] = c.cart_rank(c.cart_coords())
    return out


CARTS = {
    "2x4 periodic rows": lambda w: w.cart_create([2, 4], periods=[True, False]),
    "2x3 of 8": lambda w: w.cart_create([2, 3]),
    "2x3 of 8 as rank 7": lambda w: w.as_rank(7).cart_create([2, 3]),
    "2x3 of 8 as rank 5": lambda w: w.as_rank(5).cart_create([2, 3]),
    "8 ring": lambda w: w.cart_create([8], periods=[True]),
    "2x2x2 reorder": lambda w: w.cart_create([2, 2, 2], reorder=True),
    "sub rows of 2x4": lambda w: w.cart_create(
        [2, 4], periods=[True, False]).cart_sub([False, True]),
    "sub row of rank 4": lambda w: w.cart_create(
        [2, 4], periods=[True, False]).as_rank(4).cart_sub([False, True]),
    "sub columns of 2x4": lambda w: w.cart_create(
        [2, 4]).as_rank(6).cart_sub([True, False]),
    "sub of 2x2x2": lambda w: w.cart_create(
        [2, 2, 2]).as_rank(5).cart_sub([True, False, True]),
    "graph square": lambda w: w.graph_create([2, 4, 6, 8],
                                             [1, 3, 0, 2, 1, 3, 0, 2]),
    "graph of 5 as rank 6": lambda w: w.as_rank(6).graph_create(
        [1, 2, 3, 4, 5], [1, 2, 3, 4, 0]),
    "dist graph": lambda w: w.dist_graph_create_adjacent([7], [1]),
    "split_type": lambda w: w.split_type("shared"),
}


@pytest.mark.parametrize("make", list(CARTS))
def test_device_world_constructors_match_the_reference(worlds, make):
    jw, tw = worlds
    assert tw.topo_test() == jw.topo_test() == "undefined"
    j, t = CARTS[make](jw), CARTS[make](tw)
    assert _shape(t) == _shape(j)
    if t is not None:
        assert _outcome(t.cart_map, [2, 4]) == _outcome(j.cart_map, [2, 4])
        assert _outcome(t.graph_map, [1, 2], [1, 0]) == \
            _outcome(j.graph_map, [1, 2], [1, 0])


def test_topology_errors_match_the_reference(worlds):
    jw, tw = worlds
    for call in (lambda w: w.cart_create([3, 3]),
                 lambda w: w.cart_coords(),
                 lambda w: w.neighbor_allgather(np.zeros((8, 1))),
                 lambda w: w.graph_create([1], [0]).cart_shift(0),
                 lambda w: w.cart_map([4, 4])):
        assert _outcome(call, tw) == _outcome(call, jw)


def _table(n, width, seed):
    return np.random.default_rng(seed).integers(
        -99, 99, (n, width)).astype(np.int64)


NEIGHBORHOODS = {
    "ring of 8": lambda w: w.cart_create([8], periods=[True]),
    "open line of 8": lambda w: w.cart_create([8]),
    "2x4 torus": lambda w: w.cart_create([2, 4], periods=[True, True]),
    "periodic size-2 ring": lambda w: w.cart_create([2], periods=[True]),
    "graph square": lambda w: w.graph_create([2, 4, 6, 8],
                                             [1, 3, 0, 2, 1, 3, 0, 2]),
}


@pytest.mark.parametrize("hood", list(NEIGHBORHOODS))
def test_neighbor_collectives_match_the_reference(worlds, hood):
    jw, tw = worlds
    j, t = NEIGHBORHOODS[hood](jw), NEIGHBORHOODS[hood](tw)
    n = t.size
    k = len(t.topo.neighbors(0)[1])
    for rank in range(n):
        jr, tr = j.as_rank(rank), t.as_rank(rank)
        table = _table(n, 3, rank)
        blocks = _table(n * k, 2, 50 + rank).reshape(n, k, 2)
        for name, arg in (("neighbor_allgather", table),
                          ("neighbor_allgatherv", table),
                          ("neighbor_alltoall", blocks),
                          ("neighbor_alltoallv", blocks)):
            want = getattr(jr, name)(arg)
            got = getattr(tr, name)(arg)
            assert [g is None for g in got] == [w is None for w in want]
            _same([g for g in got if g is not None],
                  [w for w in want if w is not None], (hood, rank, name))
        got = tr.neighbor_alltoallw(blocks, np.int32)
        want = jr.neighbor_alltoallw(blocks, np.int32)
        _same([g for g in got if g is not None],
              [w for w in want if w is not None], (hood, rank, "w"))
        req = tr.ineighbor_alltoall(blocks)
        req.wait()
        _same([g for g in req.result if g is not None],
              [w for w in jr.neighbor_alltoall(blocks) if w is not None])


def test_a_tensor_table_divergence_pinned(worlds):
    """A tensor table's neighbor rows stay tensors on the table's device
    (clones, no host copy); the reference turns its ``jax.Array`` into
    numpy.  The values are the same."""
    import jax.numpy as jnp

    jw, tw = worlds
    j = jw.cart_create([8], periods=[True]).as_rank(3)
    t = tw.cart_create([8], periods=[True]).as_rank(3)
    table = _table(8, 4, 9).astype(np.float32)
    got = t.neighbor_allgather(torch.from_numpy(table))
    want = j.neighbor_allgather(jnp.asarray(table))
    assert all(isinstance(g, torch.Tensor) for g in got)
    assert all(isinstance(w, np.ndarray) for w in want)
    _same(got, want)
    src = torch.from_numpy(table)
    got[0][0] = 1e9
    assert src[2, 0] == table[2, 0]          # a clone, not a view
    blocks = torch.from_numpy(_table(16, 2, 3).reshape(8, 2, 2))
    got = t.neighbor_alltoall(blocks)
    assert all(isinstance(g, torch.Tensor) for g in got)
    _same(got, j.neighbor_alltoall(np.asarray(blocks)))


def _ints(n, per, seed):
    """Integer-valued float32 rows: their sums are exact in any order."""
    return np.random.default_rng(seed).integers(
        -1000, 1000, (n, per)).astype(np.float32)


@pytest.mark.parametrize(
    "ring_worlds", [{"otpu_coll_ring_vmem_max_bytes": 2048}], indirect=True)
@pytest.mark.parametrize("rank", [0, 4])
def test_ring_collectives_on_cart_rows(ring_worlds, rank, monkeypatch):
    """The 2x4 grid's rows (n = 4) take the raised ring: allreduce (K3,
    and K4 above ``vmem_max_bytes`` a rank), bcast (K12), allgather (K10),
    bit for bit with the reference's rows."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    j = jw.cart_create([2, 4], periods=[True, False]).as_rank(rank) \
        .cart_sub([False, True])
    t = tw.cart_create([2, 4], periods=[True, False]).as_rank(rank) \
        .cart_sub([False, True])
    assert list(t.group.world_ranks) == list(j.group.world_ranks) == \
        list(range(rank, rank + 4))
    assert _owner(t, "allreduce_array") == "RingCollModule"
    seen = []
    real = rc.all_reduce
    monkeypatch.setattr(rc, "all_reduce", lambda *a, **k: seen.append(
        (a[1], k.get("variant"))) or real(*a, **k))
    for per in (300, 1000):          # 1.2 KB (fused) and 4 KB (segmented)
        x = _ints(4, per, per)
        for op in ("SUM", "MAX"):
            _same(t.allreduce_array(x, getattr(ompi_tpu_torch, op)),
                  j.allreduce_array(x, getattr(jop, op)), (per, op))
    _same(t.bcast_array(_ints(4, 300, 1), 2), j.bcast_array(_ints(4, 300, 1), 2))
    _same(t.allgather_array(_ints(4, 64, 2)), j.allgather_array(_ints(4, 64, 2)))
    assert seen == [(4, "fused")] * 2 + [(4, "seg")] * 2, seen
