"""The port's device-world communicator on the CPU lane, held against
``ompi_tpu.init()`` on the 8-virtual-CPU mesh with the same host stacks:
the device slots of ``tests/test_coll.py``'s ``test_device_*`` cases (the
rooted and prefix collectives among them: ``reduce_array``,
``gather_array``, ``scatter_array``, ``scan_array``, ``exscan_array``), the
sub-communicators of ``create``/``split``, ``compare``, ``free`` and
``as_rank``, and ``persistent_coll``'s bindings of the new slots.

Bit-exact: every case but the two whose reduction order differs by
construction, float SUM ``allreduce_array`` and ``reduce_scatter_array``
(XLA's psum and ``torch.sum`` add the ranks in other orders: each is
within (n-1)·2^-24·Σ|x| of the exact sum, so they differ by at most twice
that, element by element).
``reduce_array`` folds along the reference's binomial tree and
``scan_array``/``exscan_array`` along ``lax.associative_scan``'s combine
tree, so their float SUM is bit-exact too, at n = 8, 5 and 3 (sub-comms).
Pinned divergences: the reference's gather and scatter turn -0.0 into
+0.0 (they paste blocks with an add); the port delivers the bytes.
"""
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base import cudaenv
from test_torch_world import _bits



def _sum_band(got, want, host):
    """Two float32 sums of the n rank rows of ``host`` taken in different
    orders: each within (n-1)·u·Σ|x_i| of the exact sum (u = 2^-24), so
    they differ by at most 2(n-1)·u·Σ|x_i|."""
    n = host.shape[0]
    band = 2 * (n - 1) * 2.0 ** -24 * np.abs(host).sum(0)
    assert (np.abs(_np(got) - _np(want)) <= band).all()


@pytest.fixture(scope="module")
def worlds():
    """Both packages' worlds at default priorities (coll/xla against
    coll/builtin), for the whole module."""
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


def _ops(name):
    from ompi_tpu.api import op as jop

    return getattr(jop, name), getattr(ompi_tpu_torch, name)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(out):
    if isinstance(out, list):
        return [_np(o) for o in out]
    return cudaenv.to_numpy(out) if isinstance(out, torch.Tensor) \
        else np.asarray(out)


def _same(got, want, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, what)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _owner(comm, slot):
    return type(comm.c_coll[slot].__self__).__name__


# -- selection ----------------------------------------------------------

def test_selection_order(worlds):
    """coll/builtin (90) owns the array slots and the barrier, as coll/xla
    does; coll/conductor (40) the host slots."""
    jw, tw = worlds
    for slot in ("allreduce_array", "reduce_array", "gather_array",
                 "scatter_array", "scan_array", "exscan_array", "barrier",
                 "device_barrier"):
        assert _owner(jw, slot) == "XlaCollModule", slot
        assert _owner(tw, slot) == "BuiltinCollModule", slot
    for slot in ("allreduce", "reduce", "scan", "iallreduce", "agree"):
        assert _owner(jw, slot) == "ConductorModule", slot
        assert _owner(tw, slot) == "ConductorModule", slot


# -- the device cases of tests/test_coll.py ------------------------------

def _perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


#: test_coll.py's device cases: name -> (call on a world with the ops of its
#: package, host input, bit-exact?)
DEVICE_CASES = {
    "allreduce_sum": (lambda w, o, x: w.allreduce_array(x),
                      _normal((8, 4), 0), False),
    "allreduce_max_min": (lambda w, o, x: [w.allreduce_array(x, o["MAX"]),
                                           w.allreduce_array(x, o["MIN"])],
                          _normal((8, 4), 1), True),
    "allreduce_prod": (lambda w, o, x: w.allreduce_array(x, o["PROD"]),
                       np.full((8, 3), 2.0, np.float32), True),
    "allreduce_band": (lambda w, o, x: w.allreduce_array(x, o["BAND"]),
                       (np.arange(24).reshape(8, 3) % 7 + 1).astype(np.int32),
                       True),
    "bcast": (lambda w, o, x: w.bcast_array(x, root=3), _normal((8, 4), 2),
              True),
    "allgather": (lambda w, o, x: w.allgather_array(x), _normal((8, 4), 3),
                  True),
    "reduce_scatter": (lambda w, o, x: w.reduce_scatter_array(x),
                       _normal((8, 8, 5), 4), False),
    "alltoall": (lambda w, o, x: w.alltoall_array(x),
                 np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2), True),
    "ppermute_ring": (lambda w, o, x: w.ppermute_array(x, _perm(8)),
                      _normal((8, 4), 5), True),
    "reduce_root_semantics": (lambda w, o, x: w.reduce_array(x, root=2),
                              _normal((8, 4), 10), True),
    "gather_root_semantics": (lambda w, o, x: w.gather_array(x, root=5),
                              _normal((8, 4), 11), True),
    "scatter_from_root": (lambda w, o, x: w.scatter_array(x, root=4),
                          _normal((8, 8, 3), 12), True),
    "scan_exscan": (lambda w, o, x: [w.scan_array(x), w.exscan_array(x)],
                    _normal((8, 4), 13), True),
    "allgatherv": (lambda w, o, x: w.allgatherv_array(x, [1, 2, 3, 4, 4, 3, 2, 1]),
                   _normal((8, 4, 2), 14), True),
    "alltoallv": (lambda w, o, x: w.alltoallv_array(
        x, [[(2 * i + j) % 4 for j in range(8)] for i in range(8)]),
        np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3), True),
}

_OP_NAMES = ("SUM", "PROD", "MAX", "MIN", "BAND")


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_case_matches_reference(worlds, case):
    jw, tw = worlds
    call, host, exact = DEVICE_CASES[case]
    jops = {k: _ops(k)[0] for k in _OP_NAMES}
    tops = {k: _ops(k)[1] for k in _OP_NAMES}
    want, got = call(jw, jops, host), call(tw, tops, host)
    if exact:
        _same(got, want, case)
    else:
        _sum_band(got, want, host)


def test_device_barrier(worlds):
    """``barrier`` through coll/builtin's device barrier: an allreduce of
    (n, 1) zeros, then a synchronize; returns nothing, as the reference's."""
    jw, tw = worlds
    assert jw.barrier() is None and tw.barrier() is None
    assert tw.ibarrier().test()[0]


def test_root_semantics(worlds):
    """test_coll.py's contracts: reduce and gather land in root's row, the
    other rows zeros; scatter hands rank i root's block i; exscan's row 0 is
    zeros."""
    _, tw = worlds
    x = _normal((8, 4), 20)
    red = _np(tw.reduce_array(x, root=6))
    assert not red[np.arange(8) != 6].any()
    gat = _np(tw.gather_array(x, root=1))
    _same(gat[1], x)
    assert not gat[np.arange(8) != 1].any()
    z = _normal((8, 8, 3), 21)
    _same(tw.scatter_array(z, root=4), z[4])
    assert not _np(tw.exscan_array(x))[0].any()


# -- bit-exact float SUM through the trees, n = 8, 5, 3 ------------------

def _sub(w, n):
    """The sub-comm of the first n ranks (the world itself for 8)."""
    return w if n == w.size else w.create(w.group.incl(range(n)))


@pytest.mark.parametrize("n", [8, 5, 3])
def test_reduce_sum_is_bit_exact(worlds, n):
    """The binomial tree's fold order at roots 0, 3 and n - 1 (7 for the
    world): bit for bit, and differing from ``x.sum(0)``'s bits somewhere,
    so the order is what is held."""
    jw, tw = worlds
    js, ts = _sub(jw, n), _sub(tw, n)
    x = _normal((n, 999), 30 + n)
    for root in sorted({0, 3 % n, n - 1}):
        got = ts.reduce_array(x, ompi_tpu_torch.SUM, root)
        _same(got, js.reduce_array(x, _ops("SUM")[0], root), f"n {n} root {root}")
        assert _np(got)[root].tobytes() != x.sum(0).tobytes()


@pytest.mark.parametrize("n", [8, 5, 3])
def test_scan_exscan_sum_is_bit_exact(worlds, n):
    """associative_scan's combine tree at an even and two odd counts: bit
    for bit, where a sequential cumsum differs."""
    jw, tw = worlds
    js, ts = _sub(jw, n), _sub(tw, n)
    x = _normal((n, 999), 40 + n)
    _same(ts.scan_array(x), js.scan_array(x), f"scan n {n}")
    _same(ts.exscan_array(x), js.exscan_array(x), f"exscan n {n}")
    if n > 3:
        assert _np(ts.scan_array(x)).tobytes() != np.cumsum(x, 0).tobytes()


INT_OPS = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR", "LAND", "LOR",
           "LXOR")


@pytest.mark.parametrize("name", INT_OPS)
def test_integer_ops_are_bit_exact(worlds, name):
    """reduce_array (root 5), scan_array and exscan_array on int32 with
    every op that takes integers."""
    jw, tw = worlds
    jo, to = _ops(name)
    x = np.random.default_rng(len(name)).integers(-5, 6, (8, 33)).astype(np.int32)
    _same(tw.reduce_array(x, to, 5), jw.reduce_array(x, jo, 5), name)
    _same(tw.scan_array(x, to), jw.scan_array(x, jo), name)
    _same(tw.exscan_array(x, to), jw.exscan_array(x, jo), name)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_gather_scatter_are_bit_exact(worlds, root):
    jw, tw = worlds
    x = _normal((8, 6, 5), 50 + root)
    _same(tw.gather_array(x, root), jw.gather_array(x, root))
    z = _normal((8, 8, 6), 60 + root)
    _same(tw.scatter_array(z, root), jw.scatter_array(z, root))


def test_root_outside_the_comm_follows_the_reference(worlds):
    """A root past the last rank: the reference's reduce and gather leave
    every row zero (no rank is root) and its scatter reads row root % n;
    the port does the same."""
    jw, tw = worlds
    x, z = _normal((8, 4), 70), _normal((8, 8, 4), 71)
    _same(tw.reduce_array(x, root=9), jw.reduce_array(x, root=9))
    _same(tw.gather_array(x, root=9), jw.gather_array(x, root=9))
    _same(tw.scatter_array(z, root=9), jw.scatter_array(z, root=9))


def test_gather_negative_zero_divergence_pinned(worlds):
    """Reference behaviour the port does not copy: coll/xla's gather tree
    pastes each block it receives with an add (``buf + contrib``,
    ``xla.py:492``), and (+0.0) + (-0.0) = +0.0, so every rank's -0.0 but
    root's own arrives as +0.0.  The port delivers the bytes, as MPI_Gather
    does."""
    jw, tw = worlds
    x = _normal((8, 6), 80)
    x[:, :3] = -0.0
    want = _np(jw.gather_array(x, 2))
    got = _np(tw.gather_array(x, 2))
    assert np.signbit(want[2, 2, :3]).all()                 # root's own
    assert not np.signbit(np.delete(want[2], 2, 0)[:, :3]).any()
    assert np.signbit(got[2][:, :3]).all()
    _same(got[2], x)
    np.testing.assert_array_equal(got, want)                # equal as values


def test_scatter_negative_zero_divergence_pinned(worlds):
    """The same for scatter's tree (``xla.py:617``): every -0.0 of root's
    row arrives as +0.0, root's own block included.  The port delivers the
    bytes."""
    jw, tw = worlds
    z = _normal((8, 8, 6), 81)
    z[:, :, :2] = -0.0
    want = _np(jw.scatter_array(z, 4))
    got = _np(tw.scatter_array(z, 4))
    assert not np.signbit(want[:, :2]).any()
    _same(got, z[4])
    np.testing.assert_array_equal(got, want)


def test_fold_tree_launches_one_fold_a_round(worlds, monkeypatch):
    """reduce_array's tree calls the op framework's fold once per round,
    ceil(log2 n) rounds (K2 once per round on the card), each over all of
    the round's pairs; scan and exscan take the plain (fusable) fold."""
    from ompi_tpu_torch.mca.coll import builtin
    from ompi_tpu_torch.api import op as top

    _, tw = worlds
    calls = []
    real = top.torch_fold

    def spy(op, dtype=None, fusable=False):
        fold = real(op, dtype, fusable)
        return lambda a, b: calls.append((fusable, a.shape[0])) or fold(a, b)

    monkeypatch.setattr(top, "torch_fold", spy)
    for n, rounds in ((8, [4, 2, 1]), (5, [1, 2, 1]), (3, [1, 1])):
        ts = _sub(tw, n)
        x = torch.from_numpy(_normal((n, 10), n))
        calls.clear()
        ts.reduce_array(x, ompi_tpu_torch.PROD, 1)
        assert calls == [(False, m) for m in rounds], (n, calls)
        assert builtin.tree_rounds(n) == [4, 2, 1][3 - len(rounds):]
        calls.clear()
        ts.scan_array(x, ompi_tpu_torch.PROD)
        assert calls and all(f for f, _ in calls)


# -- persistent bindings of the new slots --------------------------------

@pytest.mark.parametrize("coll,args", [
    ("reduce", ("SUM", 3)), ("gather", (5,)), ("scan", ("SUM",)),
    ("exscan", ("MAX",))])
def test_persistent_binding_of_the_new_slots(worlds, coll, args):
    """``coll_init`` binds the new slots to the cached callable under the
    reference's key (``_keyfor``, the device added): each start equals the
    one-shot call and the reference's request."""
    from ompi_tpu_torch.mca.coll import builtin

    jw, tw = worlds
    x = _normal((8, 7), 90)
    jargs = tuple(_ops(a)[0] if isinstance(a, str) else a for a in args)
    targs = tuple(_ops(a)[1] if isinstance(a, str) else a for a in args)
    jreq, treq = jw.coll_init(coll, x, *jargs), tw.coll_init(coll, x, *targs)
    for req in (jreq, treq):
        req.start()
        req.wait()
    _same(treq.result, jreq.result, coll)
    _same(treq.result, getattr(tw, coll + "_array")(x, *targs), coll)
    module = next(m for m in tw.coll_modules
                  if type(m).__name__ == "BuiltinCollModule")
    t = cudaenv.make_world_array(x, tw.rte.device)
    key = builtin._keyfor(coll, t, *targs)
    jmod = next(m for m in jw.coll_modules
                if type(m).__name__ == "XlaCollModule")
    jkey = jmod._keyfor(coll, np.asarray(x), *jargs)
    # (coll, op name or root, [root,] shape, dtype) + the device
    assert key[:-3] == jkey[:-2] and tuple(key[-3]) == tuple(jkey[-2])
    assert str(key[-2]) == f"torch.{np.dtype(jkey[-1])}"
    assert key[-1] == tw.rte.device and key in module._cache


# -- sub-communicators ------------------------------------------------------

def _members(comm):
    return None if comm is None else list(comm.group.world_ranks)


def test_create_subcomm_matches_reference(worlds):
    """test_coll.py's test_split_device_subcomm: create over ranks 0, 2, 4,
    6 gives a 4-rank comm whose device module runs on its member rows."""
    jw, tw = worlds
    js = jw.create(jw.group.incl([0, 2, 4, 6]))
    ts = tw.create(tw.group.incl([0, 2, 4, 6]))
    assert ts.size == 4 and _members(ts) == _members(js)
    assert [type(m).__name__ for m in ts.coll_modules] == \
        ["ConductorModule", "RingCollModule", "BuiltinCollModule"]
    assert _owner(ts, "allreduce_array") == "BuiltinCollModule"
    assert _owner(ts, "allreduce") == "ConductorModule"
    host = np.ones((4, 3), np.float32)
    _same(ts.allreduce_array(host), js.allreduce_array(host))
    x = _normal((4, 5), 91)
    for call in (lambda c, o: c.reduce_array(x, o, 2),
                 lambda c, o: c.scan_array(x, o),
                 lambda c, o: c.gather_array(x, 3),
                 lambda c, o: c.bcast_array(x, 1),
                 lambda c, o: c.allreduce(x, o)):
        _same(call(ts, ompi_tpu_torch.SUM), call(js, _ops("SUM")[0]))
    # not a member: None, and a CID taken all the same
    before = tw.dup().cid
    assert tw.create(tw.group.incl([1, 2])) is None
    assert tw.dup().cid == before + 2


def test_create_group_takes_the_next_local_cid(worlds):
    jw, tw = worlds
    ts = tw.create_group(tw.group.incl([0, 5]))
    js = jw.create_group(jw.group.incl([0, 5]))
    assert _members(ts) == _members(js) == [0, 5]
    assert tw.create_group(tw.group.incl([3, 5])) is None
    assert tw.dup().cid == ts.cid + 1


SPLITS = {
    "halves": (lambda r: [0] * 4 + [1] * 4, 0),
    "three colors": (lambda r: [0, 1, 2, 0, 1, 2, 0, 1], 0),
    "key reorders": (lambda r: [0] * 8, [7 - i for i in range(8)]),
    "ties by rank": (lambda r: [i % 2 for i in range(8)], [1, 1, 0, 0, 1, 1, 0, 0]),
    "undefined": (lambda r: [-1, 0, 0, -1, 1, 1, -1, 1], 0),
    "scalar": (lambda r: 5, 3),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_split_matches_reference_for_every_rank(worlds, case):
    """Colors and keys as (size,) arrays or scalars, a negative color
    (None), keys that reorder and keys that tie: ``as_rank(i).split`` gives
    the reference's members for every i, and the world's own split is rank
    0's."""
    jw, tw = worlds
    colors, key = SPLITS[case]
    color = colors(None)
    for i in range(8):
        want = jw.as_rank(i).split(color, key)
        got = tw.as_rank(i).split(color, key)
        assert _members(got) == _members(want), (case, i)
        if got is not None:
            assert got.rank == want.rank and got.size == want.size
    assert _members(tw.split(color, key)) == _members(jw.split(color, key))


def test_split_takes_one_cid_per_color_in_sorted_order(worlds):
    _, tw = worlds
    start = tw.dup().cid + 1
    color = [2, 0, 1, 2, 0, 1, -1, 0]
    # three splits of three colors each, taken by ranks of colors 0, 1, 2
    subs = [tw.as_rank(i).split(color) for i in (1, 2, 0)]
    assert [s.cid for s in subs] == [start, start + 3 + 1, start + 6 + 2]


def test_compare(worlds):
    _, tw = worlds
    from ompi_tpu_torch.api.comm import Comm

    d = tw.dup()
    rev = tw.split(0, [7 - i for i in range(8)])
    half = tw.split([0] * 4 + [1] * 4)
    assert tw.compare(tw) == Comm.IDENT
    assert tw.compare(d) == Comm.CONGRUENT
    assert tw.compare(rev) == Comm.SIMILAR
    assert tw.compare(half) == Comm.UNEQUAL
    assert (Comm.IDENT, Comm.CONGRUENT, Comm.SIMILAR, Comm.UNEQUAL) == (0, 1, 2, 3)


def test_free(worlds):
    """free releases the modules and retires the CID (the next comm takes a
    new one); a second free does nothing; a freed comm raises ERR_COMM,
    agree included."""
    _, tw = worlds
    d = tw.dup()
    cid = d.cid
    d.free()
    assert d.freed and d.c_coll == {} and d.coll_modules == []
    d.free()
    assert tw.dup().cid == cid + 1
    for call in (lambda: d.allreduce_array(np.ones((8, 2), np.float32)),
                 lambda: d.reduce_array(np.ones((8, 2), np.float32)),
                 lambda: d.barrier(), lambda: d.agree(1), lambda: d.dup(),
                 lambda: d.split(0)):
        with pytest.raises(MpiError) as e:
            call()
        assert e.value.error_class is ErrorClass.ERR_COMM


def test_as_rank_names_and_world_rank(worlds):
    _, tw = worlds
    v = tw.as_rank(5)
    assert v.rank == 5 and tw.rank == 0 and v.c_coll is tw.c_coll
    with pytest.raises(MpiError) as e:
        tw.as_rank(8)
    assert e.value.error_class is ErrorClass.ERR_RANK
    sub = tw.split([i % 2 for i in range(8)])
    assert [sub.world_rank(i) for i in range(sub.size)] == [0, 2, 4, 6]
    sub.set_name("evens")
    assert sub.get_name() == "evens"


def test_size_one_split_goes_to_self_coll(worlds):
    """A split that leaves one rank: coll/self_coll (75) owns its host
    slots (the conductor declines size 1), coll/builtin its device slots."""
    jw, tw = worlds
    color = [0] + [1] * 7
    ts, js = tw.split(color), jw.split(color)
    assert ts.size == 1 and _members(ts) == _members(js)
    assert _owner(ts, "allreduce") == "SelfCollModule"
    assert _owner(ts, "allreduce_array") == "BuiltinCollModule"
    x = _normal((1, 4), 92)
    _same(ts.allreduce(x[0]), js.allreduce(x[0]))
    for call in (lambda c, o: c.allreduce_array(x, o),
                 lambda c, o: c.reduce_array(x, o, 0),
                 lambda c, o: c.scan_array(x, o),
                 lambda c, o: c.exscan_array(x, o)):
        _same(call(ts, ompi_tpu_torch.SUM), call(js, _ops("SUM")[0]))


def test_new_modules_are_inside_the_package_boundary():
    """The modules this slice ports exist in the port and import neither
    jax nor ompi_tpu (test_torch_world's boundary check walks them too)."""
    from test_torch_world import ROOT, _imports

    for rel in ("mca/coll/conductor.py", "mca/coll/self_coll.py",
                "mca/accelerator/torch_acc.py", "mca/accelerator/__init__.py",
                "api/comm.py", "api/op.py", "runtime/init.py"):
        path = ROOT / "ompi_tpu_torch" / rel
        assert path.exists(), rel
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "ompi_tpu"), \
                (rel, mod)
