"""The port's bcast_array, allgather_array and reduce_scatter_array end to
end on the CPU lane, held against ``ompi_tpu.init()`` on the 8-virtual-CPU
mesh with the same host stacks: at default priorities (coll/builtin vs
coll/xla) and with the ring raised (coll/ring vs coll/pallas).
"""
import ml_dtypes
import numpy as np
import pytest

import ompi_tpu_torch
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base import cudaenv
from test_torch_world import _bits, jax_world, ring_worlds, torch_world  # noqa: F401

SLOTS = ("bcast_array", "allgather_array", "reduce_scatter_array",
         "psum_scatter_array")
KINDS = {"float32": np.float32, "int32": np.int32, "bfloat16": ml_dtypes.bfloat16}
#: per-rank payloads of the bcast cases: below and above coll/xla's
#: bcast_sa_min_bytes (256 KB), the switch between its two regimes
BCAST_BYTES = (64, 512 << 10)


def _owner(comm, slot):
    return type(comm.c_coll[slot].__self__).__name__


def _stack(kind: str, shape, seed: int):
    """Values near 1 (no zeros, one sign): float sums in another order stay
    within a few ulps, and PROD stays finite."""
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-3, 4, shape).astype(np.int32)
    return (1.0 + 0.05 * rng.standard_normal(shape)).astype(KINDS[kind])


def _rows(kind: str, per_rank_bytes: int):
    return (8, per_rank_bytes // np.dtype(KINDS[kind]).itemsize)


def _jop(name):
    from ompi_tpu.api import op as jop

    return getattr(jop, name)


def _spy(monkeypatch, name):
    """Record the variant keywords of each call to rc.<name>."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    seen, real = [], getattr(rc, name)
    monkeypatch.setattr(rc, name, lambda *a, **k: seen.append(k) or real(*a, **k))
    return seen


# -- selection ----------------------------------------------------------

def test_builtin_owns_the_new_slots_by_default(torch_world):
    for slot in SLOTS:
        assert _owner(torch_world, slot) == "BuiltinCollModule", slot


def test_ring_owns_the_new_slots_when_raised(ring_worlds):
    jw, tw = ring_worlds
    for slot in SLOTS:
        assert _owner(tw, slot) == "RingCollModule", slot
        assert _owner(jw, slot) == "PallasCollModule", slot


# -- bcast ----------------------------------------------------------------

@pytest.mark.parametrize("nbytes", BCAST_BYTES)
@pytest.mark.parametrize("kind", ["float32", "int32", "bfloat16"])
def test_bcast_builtin_matches_xla(jax_world, torch_world, kind, nbytes):
    """Both of coll/xla's regimes deliver root's values when root's row
    holds no -0.0: bit-exact."""
    host = _stack(kind, _rows(kind, nbytes), seed=7)
    want = np.asarray(jax_world.bcast_array(host, root=2))
    got = cudaenv.to_numpy(torch_world.bcast_array(host, root=2))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(np.broadcast_to(host[2], host.shape)))


@pytest.mark.parametrize("nbytes", BCAST_BYTES)
@pytest.mark.parametrize("kind", ["float32", "int32", "bfloat16"])
def test_bcast_ring_matches_pallas(ring_worlds, kind, nbytes, monkeypatch):
    """Any dtype takes the ring's bcast (K12 on the card) in both packages,
    bf16 included: bit-exact."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "bcast")
    host = _stack(kind, _rows(kind, nbytes), seed=8)
    want = np.asarray(jw.bcast_array(host, root=2))
    got = cudaenv.to_numpy(tw.bcast_array(host, root=2))
    assert len(seen) == 1
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _module(comm, cls_name):
    return next(m for m in comm.coll_modules if type(m).__name__ == cls_name)


def test_bcast_negative_zero_divergence_pinned(ring_worlds):
    """Reference behaviour the port does not copy: above bcast_sa_min_bytes
    (256 KB per rank) coll/xla's bcast is a masked psum_scatter plus an
    all_gather, and (-0.0) + 0.0 = +0.0, so root's -0.0 arrives as +0.0.
    coll/pallas (a copy) keeps -0.0, as MPI_Bcast delivers root's bytes; the
    port keeps it through coll/ring and coll/builtin alike (the modules
    below each world's raised ring are called directly)."""
    jw, tw = ring_worlds
    host = _stack("float32", _rows("float32", 512 << 10), seed=9)
    host[3, :4] = -0.0
    xla = np.asarray(_module(jw, "XlaCollModule").bcast_array(jw, host, 3))
    pallas = np.asarray(jw.bcast_array(host, root=3))
    ring = cudaenv.to_numpy(tw.bcast_array(host, root=3))
    builtin = cudaenv.to_numpy(
        _module(tw, "BuiltinCollModule").bcast_array(tw, host, 3))
    assert not np.signbit(xla[:, :4]).any()            # the reference quirk
    root_rows = _bits(np.broadcast_to(host[3], host.shape))
    for got in (pallas, ring, builtin):
        assert np.signbit(got[:, :4]).all()
        np.testing.assert_array_equal(_bits(got), root_rows)


# -- allgather ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float32", "int32"])
def test_allgather_builtin_matches_xla(jax_world, torch_world, kind):
    host = _stack(kind, (8, 3, 5), seed=10)
    want = np.asarray(jax_world.allgather_array(host))
    got = cudaenv.to_numpy(torch_world.allgather_array(host))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["float32", "int32"])
def test_allgather_ring_matches_pallas(ring_worlds, kind, monkeypatch):
    """float32 takes the ring's all-gather (K10 on the card); int32 is not a
    ring payload in the reference and falls through in both packages."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_gather")
    host = _stack(kind, (8, 3, 5), seed=11)
    want = np.asarray(jw.allgather_array(host))
    got = cudaenv.to_numpy(tw.allgather_array(host))
    assert len(seen) == (1 if kind == "float32" else 0)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- reduce_scatter -------------------------------------------------------

#: (op, host dtype, bit-exact?).  SUM is a psum_scatter in XLA and torch.sum
#: here: two reduction orders, so float SUM is held to one ulp of f32 per
#: rank (rtol 8 * 2**-24); every other row is exact.
RS_CASES = [("SUM", "float32", False), ("MAX", "float32", True),
            ("MIN", "float32", True), ("PROD", "float32", True),
            ("BAND", "int32", True), ("SUM", "int32", True)]


@pytest.mark.parametrize("op,kind,exact", RS_CASES)
def test_reduce_scatter_builtin_matches_xla(jax_world, torch_world, op, kind,
                                            exact):
    host = _stack(kind, (8, 8, 3, 5), seed=12)
    want = np.asarray(jax_world.reduce_scatter_array(host, _jop(op)))
    got = cudaenv.to_numpy(
        torch_world.reduce_scatter_array(host, getattr(ompi_tpu_torch, op)))
    assert got.dtype == want.dtype and got.shape == want.shape == (8, 3, 5)
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, rtol=8 * 2.0 ** -24, atol=0)


def test_psum_scatter_is_the_sum_reduce_scatter(torch_world):
    host = _stack("float32", (8, 8, 6), seed=13)
    fn = torch_world.c_coll["psum_scatter_array"]
    np.testing.assert_array_equal(
        _bits(cudaenv.to_numpy(fn(torch_world, host))),
        _bits(cudaenv.to_numpy(torch_world.reduce_scatter_array(host))))


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD"])
def test_reduce_scatter_ring_matches_pallas(ring_worlds, op, monkeypatch):
    """Raised priorities: float payloads take the fused ring reduce-scatter
    in both packages (K5; plain version here, interpret mode there):
    bit-exact, as both start block b's fold on rank b+1."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "reduce_scatter")
    host = _stack("float32", (8, 8, 3, 5), seed=14)
    want = np.asarray(jw.reduce_scatter_array(host, _jop(op)))
    got = cudaenv.to_numpy(
        tw.reduce_scatter_array(host, getattr(ompi_tpu_torch, op)))
    assert [k["variant"] for k in seen] == ["fused"]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize(
    "ring_worlds", [{"otpu_coll_ring_vmem_max_bytes": 1024}], indirect=True)
def test_reduce_scatter_small_vmem_max_routes_to_seg(ring_worlds, monkeypatch):
    """Per rank is x.nbytes // n = 8 * 50 * 4 bytes, above 1024: the
    segmented kernel (K6), window seg_bytes / 4, in both packages."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "reduce_scatter")
    host = _stack("float32", (8, 8, 50), seed=15)
    want = np.asarray(jw.reduce_scatter_array(host, _jop("SUM")))
    got = cudaenv.to_numpy(tw.reduce_scatter_array(host, ompi_tpu_torch.SUM))
    assert [(k["variant"], k["seg_elems"]) for k in seen] == [("seg", 131072)]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("slot,kind", [("reduce_scatter_array", "int32"),
                                       ("allgather_array", "bfloat16")])
def test_non_ring_dtypes_fall_through(ring_worlds, slot, kind, monkeypatch):
    """int32 reduce-scatter and bf16 allgather are not ring payloads in the
    reference (numpy kind is not 'f'): the raised ring delegates them to
    coll/builtin, bit-exact with coll/xla."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    for name in ("reduce_scatter", "all_gather"):
        monkeypatch.setattr(rc, name, lambda *a, **k: pytest.fail("ring took it"))
    shape = (8, 8, 5) if slot == "reduce_scatter_array" else (8, 5)
    host = _stack(kind, shape, seed=16)
    want = np.asarray(getattr(jw, slot)(host))
    got = cudaenv.to_numpy(getattr(tw, slot)(host))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_malformed_reduce_scatter_raises(ring_worlds):
    """(8, 7, 5) is not (n, n, ...): MpiError(ERR_BUFFER) from coll/xla, and
    from the port through coll/builtin and through coll/ring, which hands
    the call to coll/builtin (coll/pallas raises a reshape TypeError)."""
    from ompi_tpu.api.errors import MpiError as JaxMpiError

    jw, tw = ring_worlds
    bad = np.ones((8, 7, 5), np.float32)
    with pytest.raises(JaxMpiError) as je:
        _module(jw, "XlaCollModule").reduce_scatter_array(jw, bad)
    assert je.value.error_class.name == "ERR_BUFFER"
    for call in (tw.reduce_scatter_array,
                 lambda x: _module(tw, "BuiltinCollModule")
                 .reduce_scatter_array(tw, x)):
        with pytest.raises(MpiError) as e:
            call(bad)
        assert e.value.error_class is ErrorClass.ERR_BUFFER
