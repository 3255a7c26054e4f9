"""The port's exchange tier end to end on the CPU lane -- ``alltoall_array``,
``alltoallv_array``, ``allgatherv_array`` and ``ppermute_array`` -- held
against ``ompi_tpu.init()`` on the 8-virtual-CPU mesh with the same host
stacks: at default priorities (coll/builtin vs coll/xla) and with the ring
raised (coll/ring vs coll/pallas, with a spy on the ring wrapper to prove
the route).  The ragged calls return lists of views sliced to the counts,
so only valid rows are ever compared.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base import cudaenv
from test_torch_world import _bits, jax_world, ring_worlds, torch_world  # noqa: F401

N = 8
SLOTS = ("alltoall_array", "alltoallv_array", "allgatherv_array",
         "ppermute_array")
KINDS = {"float32": np.float32, "int32": np.int32,
         "bfloat16": ml_dtypes.bfloat16, "int8": np.int8}
ROT = [(i, (i + 1) % N) for i in range(N)]
#: rank 1 is no destination: it must receive zeros
GENERAL = [(i, (i + 2) % N) for i in range(N - 1)]


def _owner(comm, slot):
    return type(comm.c_coll[slot].__self__).__name__


def _module(comm, cls_name):
    return next(m for m in comm.coll_modules if type(m).__name__ == cls_name)


def _stack(kind: str, shape, seed: int):
    rng = np.random.default_rng(seed)
    if kind in ("int32", "int8"):
        return rng.integers(-100, 100, shape).astype(KINDS[kind])
    return rng.standard_normal(shape).astype(KINDS[kind])


def _np(a) -> np.ndarray:
    return cudaenv.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _assert_views(got, want):
    """Two lists (or lists of lists) of views, bit for bit."""
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        if isinstance(g, list):
            _assert_views(g, w)
        else:
            _assert_same(g, w)


def _spy(monkeypatch, name):
    """Record each call of rc.<name>."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    seen, real = [], getattr(rc, name)
    monkeypatch.setattr(rc, name, lambda *a, **k: seen.append(a) or real(*a, **k))
    return seen


def _a2av_counts(rows: int, seed: int) -> np.ndarray:
    """Counts over [0, rows + 3] (above R clamps), with a 0 and an R."""
    c = np.random.default_rng(seed).integers(0, rows + 4, (N, N))
    c[0, :2] = (0, rows)
    return c.astype(np.int32)


# -- selection ----------------------------------------------------------

def test_builtin_owns_the_exchange_slots_by_default(torch_world):
    for slot in SLOTS:
        assert _owner(torch_world, slot) == "BuiltinCollModule", slot


def test_ring_owns_the_exchange_slots_when_raised(ring_worlds):
    jw, tw = ring_worlds
    for slot in SLOTS:
        assert _owner(tw, slot) == "RingCollModule", slot
        assert _owner(jw, slot) == "PallasCollModule", slot


# -- alltoall (K14) ------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_alltoall_builtin_matches_xla(jax_world, torch_world, kind):
    host = _stack(kind, (N, N, 3, 5), seed=20)
    _assert_same(torch_world.alltoall_array(host),
                 jax_world.alltoall_array(host))


@pytest.mark.parametrize("kind", list(KINDS))
def test_alltoall_ring_matches_pallas(ring_worlds, kind, monkeypatch):
    """No arithmetic: every dtype takes the ring's all-to-all (K14 on the
    card) in both packages."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_to_all")
    host = _stack(kind, (N, N, 3, 5), seed=21)
    want = jw.alltoall_array(host)
    _assert_same(tw.alltoall_array(host), want)
    assert len(seen) == 1


# -- alltoallv (K15) -----------------------------------------------------

@pytest.mark.parametrize("kind", ["float32", "int32", "bfloat16"])
def test_alltoallv_builtin_matches_xla(jax_world, torch_world, kind):
    """The padded exchange, returned as views out[i][j] = what rank i got
    from rank j, sliced to counts[j][i]; R = 5 with counts up to R + 3."""
    host = _stack(kind, (N, N, 5, 128), seed=22)
    counts = _a2av_counts(5, seed=23)
    _assert_views(torch_world.alltoallv_array(host, counts),
                  jax_world.alltoallv_array(host, counts))


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_alltoallv_ring_matches_pallas(ring_worlds, kind, monkeypatch):
    """(n, n, R, W) with W = 128 takes the ragged exchange (K15 on the card;
    interpret mode there) in both packages: the views agree bit for bit."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_to_all_v")
    host = _stack(kind, (N, N, 5, 128), seed=24)
    counts = _a2av_counts(5, seed=25)
    want = jw.alltoallv_array(host, counts)
    got = tw.alltoallv_array(host, counts)
    assert len(seen) == 1
    _assert_views(got, want)
    for i in range(N):
        for j in range(N):
            assert got[i][j].shape[0] == min(counts[j][i], 5)


def test_alltoallv_counts_may_be_a_tensor(torch_world):
    host = _stack("float32", (N, N, 4, 128), seed=26)
    counts = _a2av_counts(4, seed=27)
    _assert_views(torch_world.alltoallv_array(host, torch.from_numpy(counts)),
                  torch_world.alltoallv_array(host, counts.tolist()))


# -- allgatherv (K16) ----------------------------------------------------

@pytest.mark.parametrize("kind", ["float32", "int32", "bfloat16"])
def test_allgatherv_builtin_matches_xla(jax_world, torch_world, kind):
    host = _stack(kind, (N, 6, 128), seed=28)
    counts = [0, 6, 3, 9, 1, 2, 6, 4]
    _assert_views(torch_world.allgatherv_array(host, counts),
                  jax_world.allgatherv_array(host, counts))


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_allgatherv_ring_matches_pallas(ring_worlds, kind, monkeypatch):
    """Any dtype takes the ragged all-gather (K16) in both packages."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_gather_v")
    host = _stack(kind, (N, 6, 256), seed=29)
    counts = [0, 6, 3, 9, 1, 2, 6, 4]
    want = jw.allgatherv_array(host, counts)
    got = tw.allgatherv_array(host, counts)
    assert len(seen) == 1
    _assert_views(got, want)
    assert [g.shape[0] for g in got] == [0, 6, 3, 6, 1, 2, 6, 4]


@pytest.mark.parametrize("slot", ["alltoallv_array", "allgatherv_array"])
def test_ragged_width_not_128_falls_through(ring_worlds, slot, monkeypatch):
    """W = 100 is not a whole number of 128 lanes: both rings hand the call
    to their builtin module, and the views still agree."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    for name in ("all_to_all_v", "all_gather_v"):
        monkeypatch.setattr(rc, name, lambda *a, **k: pytest.fail("ring took it"))
    if slot == "alltoallv_array":
        host, counts = _stack("float32", (N, N, 3, 100), 30), _a2av_counts(3, 31)
    else:
        host, counts = _stack("float32", (N, 3, 100), 30), [1, 2, 3, 0, 1, 2, 3, 0]
    _assert_views(getattr(tw, slot)(host, counts), getattr(jw, slot)(host, counts))


# -- ppermute (K13) ------------------------------------------------------

@pytest.mark.parametrize("perm", [ROT, GENERAL, ROT[::-1], [(3, 5)], []],
                         ids=["rotation", "general", "shuffled", "one", "none"])
@pytest.mark.parametrize("kind", ["float32", "int32"])
def test_ppermute_builtin_matches_xla(jax_world, torch_world, kind, perm):
    """lax.ppermute semantics: out[d] = x[s] for each pair, zeros on every
    rank that is no destination."""
    host = _stack(kind, (N, 3, 5), seed=32)
    got = _np(torch_world.ppermute_array(host, perm))
    _assert_same(got, jax_world.ppermute_array(host, perm))
    dests = {d for _, d in perm}
    for r in range(N):
        if r not in dests:
            assert not got[r].any(), r


def test_ppermute_rotation_takes_the_ring(ring_worlds, monkeypatch):
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "right_permute")
    host = _stack("float32", (N, 3, 5), seed=33)
    _assert_same(tw.ppermute_array(host, ROT), jw.ppermute_array(host, ROT))
    assert len(seen) == 1


@pytest.mark.parametrize("perm,kind", [(GENERAL, "float32"),
                                       (ROT[::-1], "float32"),
                                       (ROT, "int32")],
                         ids=["general", "shuffled-rotation", "int32"])
def test_ppermute_delegation(ring_worlds, perm, kind, monkeypatch):
    """Only the exact +1 rotation tuple on a float payload goes to K13: a
    general perm, the rotation with its pairs in another order, and an int32
    payload go to the builtin module in both packages."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    monkeypatch.setattr(rc, "right_permute", lambda *a, **k: pytest.fail("K13"))
    host = _stack(kind, (N, 3, 5), seed=34)
    _assert_same(tw.ppermute_array(host, perm), jw.ppermute_array(host, perm))


# -- the error contract --------------------------------------------------

def test_malformed_alltoall_raises_err_buffer(ring_worlds):
    """(8, 7, 5) is not (n, n, ...): MpiError(ERR_BUFFER) from coll/xla, and
    from the port through coll/builtin and through coll/ring, which hands
    it to coll/builtin, as coll/pallas hands it to coll/xla."""
    from ompi_tpu.api.errors import MpiError as JaxMpiError

    jw, tw = ring_worlds
    bad = np.ones((N, 7, 5), np.float32)
    for call in (jw.alltoall_array,
                 lambda x: _module(jw, "XlaCollModule").alltoall_array(jw, x)):
        with pytest.raises(JaxMpiError) as je:
            call(bad)
        assert je.value.error_class.name == "ERR_BUFFER"
    for call in (tw.alltoall_array,
                 lambda x: _module(tw, "BuiltinCollModule").alltoall_array(tw, x)):
        with pytest.raises(MpiError) as e:
            call(bad)
        assert e.value.error_class is ErrorClass.ERR_BUFFER


def test_wrong_counts_shape_raises_err_buffer(ring_worlds):
    """A counts table of the wrong shape: the port raises MpiError(ERR_BUFFER)
    through both modules, as coll/pallas does for alltoallv and both
    reference modules do for allgatherv.  coll/xla's alltoallv instead
    indexes the table (ROADMAP C): IndexError for an (n-1, n) table,
    TypeError for a flat list."""
    from ompi_tpu.api.errors import MpiError as JaxMpiError

    jw, tw = ring_worlds
    x4 = np.ones((N, N, 2, 128), np.float32)
    x3 = np.ones((N, 2, 128), np.float32)
    xla = _module(jw, "XlaCollModule")
    with pytest.raises(JaxMpiError) as je:
        jw.alltoallv_array(x4, np.ones((N - 1, N), np.int32))
    assert je.value.error_class.name == "ERR_BUFFER"
    with pytest.raises(IndexError):
        xla.alltoallv_array(jw, x4, np.ones((N - 1, N), np.int32))
    with pytest.raises(TypeError):
        xla.alltoallv_array(jw, x4, [1] * N)
    for module in (jw, xla):
        with pytest.raises(JaxMpiError):
            module.allgatherv_array(*((jw,) if module is xla else ()), x3, [1] * 7)
    builtin = _module(tw, "BuiltinCollModule")
    for call in (tw.alltoallv_array,
                 lambda x, c: builtin.alltoallv_array(tw, x, c)):
        for counts in (np.ones((N - 1, N), np.int32), [1] * N):
            with pytest.raises(MpiError) as e:
                call(x4, counts)
            assert e.value.error_class is ErrorClass.ERR_BUFFER
    for call in (tw.allgatherv_array,
                 lambda x, c: builtin.allgatherv_array(tw, x, c)):
        with pytest.raises(MpiError) as e:
            call(x3, [1] * 7)
        assert e.value.error_class is ErrorClass.ERR_BUFFER


def test_ppermute_bad_perms_raise(ring_worlds):
    """A repeated source or destination raises ValueError in both packages
    (lax.ppermute's check); a rank out of range raises ValueError in the
    port where lax.ppermute raises IndexError (ROADMAP C)."""
    jw, tw = ring_worlds
    host = np.ones((N, 3), np.float32)
    for perm in ([(0, 1), (2, 1)], [(0, 1), (0, 2)]):
        with pytest.raises(ValueError, match="unique"):
            jw.ppermute_array(host, perm)
        with pytest.raises(ValueError, match="unique"):
            tw.ppermute_array(host, perm)
    with pytest.raises(IndexError):
        jw.ppermute_array(host, [(0, N + 1)])
    with pytest.raises(ValueError, match="lie in"):
        tw.ppermute_array(host, [(0, N + 1)])
