"""The port's ring reduce-scatter, all-gather and bcast
(ompi_tpu_torch/ops/ring_collectives.py) held against the JAX package's
Pallas ring kernels (ompi_tpu/ops/pallas_collectives.py) on the
8-virtual-CPU mesh.

Same numpy inputs to both; the JAX side runs its kernels in interpret mode,
the port its plain versions (CPU tensors).  The reduce-scatter keeps the
reference's fold order (each block's partial starts on rank b+1), and
all-gather and bcast move bytes, so every comparison is bit-exact (float32,
NaN and -0.0 included).
"""
import numpy as np
import pytest
import torch

from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu_torch.ops import ring_collectives as rc

OPS = ("sum", "max", "min", "prod")


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs), ("x",))


def _payload(shape, op, seed):
    rng = np.random.default_rng(seed)
    if op == "prod":   # keep the product well-conditioned
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    # spread over decades, so that another fold order changes the bits
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-4, 5, shape)).astype(np.float32)


def _run(fn, x, *args, **kw):
    import jax

    return np.asarray(fn(jax.device_put(x), *args, **kw))


def _assert_bits_equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- reduce-scatter (K5, K6) ---------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("payload,variant,seg", [
    ((6,), "fused", None), ((3, 5), "fused", None), ((50,), "seg", 16)])
def test_reduce_scatter_matches_reference(mesh, payload, variant, seg, op):
    """Fused on (6,) and (3, 5), segmented on (50,) with a 16-element
    window (as tests/test_pallas_coll.py): bit-exact, kernel wrapper and
    plain version alike."""
    x = _payload((8, 8, *payload), op, seed=4)
    want = _run(pc.reduce_scatter, x, mesh, "x", op, variant=variant,
                seg_elems=seg)
    t = torch.from_numpy(x)
    _assert_bits_equal(rc.reduce_scatter(t, 8, op, variant, seg), want)
    _assert_bits_equal(rc.reduce_scatter_plain(t, 8, op), want)


def test_reduce_scatter_fold_starts_on_the_next_rank():
    """Block b is x[b,b] + (x[b-1,b] + (... + (x[b+2,b] + x[b+1,b]))): with
    non-associative float sums the result pins that order."""
    n, big = 4, 2.0 ** 24
    x = torch.zeros(n, n, 3, dtype=torch.float32)
    # block 1 starts on rank 2 (+big), then ranks 3 (+1), 0 (-big), 1 (+1):
    # ((big + 1) - big) + 1 = 1 in float32; the all-reduce's start, rank 1,
    # would give ((1 + big) + 1) - big = 0
    x[2, 1], x[3, 1], x[0, 1], x[1, 1] = big, 1.0, -big, 1.0
    for variant in ("fused", "seg"):
        got = rc.reduce_scatter(x, n, "sum", variant)
        assert got.shape == (n, 3) and torch.all(got[1] == 1.0)
        assert torch.all(got[[0, 2, 3]] == 0.0)


def test_reduce_scatter_single_rank_is_a_copy():
    x = torch.arange(6.0).reshape(1, 1, 6)
    got = rc.reduce_scatter(x, 1, "max")
    assert got.shape == (1, 6) and torch.equal(got, x[0])
    assert got.data_ptr() != x.data_ptr()


# -- all-gather (K10) ------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 6), (8, 3, 5), (8, 1)])
def test_all_gather_matches_reference(mesh, shape):
    x = _payload(shape, "sum", seed=3)
    x.reshape(8, -1)[2, 0] = np.nan
    want = _run(pc.all_gather, x, mesh, "x")
    got = rc.all_gather(torch.from_numpy(x), 8)
    _assert_bits_equal(got, want)
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()


# -- bcast (K12) -----------------------------------------------------------

@pytest.mark.parametrize("root", [0, 3, 7])
@pytest.mark.parametrize("shape,seg", [((8, 1000), 64), ((8, 40), 4096)])
def test_bcast_matches_reference(mesh, shape, seg, root):
    """Many segments (1000 elements, 64-element window) and one segment;
    root's row holds -0.0 and NaN, which a copy keeps bit for bit."""
    x = _payload(shape, "sum", seed=10 + root)
    x[root, :3] = (-0.0, np.nan, -np.inf)
    want = _run(pc.bcast, x, mesh, "x", root=root, seg_elems=seg)
    _assert_bits_equal(rc.bcast(torch.from_numpy(x), 8, root), want)
    _assert_bits_equal(rc.bcast_plain(torch.from_numpy(x), 8, root), want)


def test_bcast_any_dtype_and_root_modulo_n():
    for dt in (torch.bool, torch.int8, torch.bfloat16, torch.int64):
        x = torch.arange(8 * 5).reshape(8, 5).to(dt)
        got = rc.bcast(x, 8, 11)             # root 11 is rank 3
        assert got.dtype == dt and torch.equal(got, x[3].expand(8, 5))


# -- shared checks ---------------------------------------------------------

def test_vec_needs_whole_packs_per_ring_block():
    """The 16-byte path needs blk to be a multiple of the pack: with
    blk = 15 float32 elements a pack of 4 would straddle two blocks."""
    x = torch.zeros(8, 8 * 15)
    assert rc._vec(x, 15) == 1
    assert rc._vec(torch.zeros(8, 8 * 16), 16) == 4
    assert rc._vec(torch.zeros(8, 8 * 16, dtype=torch.float16), 16) == 8
    assert rc._vec(torch.zeros(8, 8 * 4, dtype=torch.float16), 4) == 1
    assert rc._vec(torch.zeros(8, 128 * 8, dtype=torch.float64), 128) == 2
    assert rc._vec(torch.zeros(8, 23), 128) == 1     # row pitch 92 bytes


def test_not_ported_variants_raise(mesh):
    """The duplex variants, once not ported, now match the reference: a
    reduce-scatter asked for seg_bidi is the one-way ring (the reference
    builds the fused one, the port the segmented one: the same values), and
    the duplex all-gather delivers x; an unknown variant still raises."""
    x = _payload((8, 8, 4), "sum", seed=5)
    t = torch.from_numpy(x)
    before = dict(rc.launches)
    _assert_bits_equal(rc.reduce_scatter(t, 8, variant="seg_bidi"),
                       _run(pc.reduce_scatter, x, mesh, "x",
                            variant="seg_bidi"))
    _assert_bits_equal(rc.all_gather(t, 8, variant="bidi"),
                       _run(pc.all_gather, x, mesh, "x", variant="bidi"))
    with pytest.raises(ValueError):
        rc.all_gather(t, 8, variant="tree")
    assert rc.launches == before


def test_wrapper_argument_checks():
    before = dict(rc.launches)
    with pytest.raises(ValueError):
        rc.reduce_scatter(torch.ones(8, 7, 5), 8)   # not (n, n, ...)
    with pytest.raises(ValueError):
        rc.reduce_scatter(torch.ones(8), 8)
    with pytest.raises(TypeError):
        rc.reduce_scatter(torch.ones(8, 8, 2, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        rc.bcast(torch.ones(4, 3), 8)
    with pytest.raises(ValueError):
        rc.all_gather(torch.ones(3, 8).t(), 8)      # not contiguous
    with pytest.raises(TypeError):
        rc.bcast(np.ones((8, 3)), 8)
    assert rc.launches == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K5, K6, K10 and K12 against their plain versions on the card, bit for
    bit (run on a machine with a card; skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dt in (torch.float16, torch.float32, torch.float64):
        for payload in ((6,), (3, 5), (1001,), (4096,)):
            x = torch.from_numpy(_payload((8, 8, *payload), "prod", 11)).to(dt)
            for op in OPS:
                for variant in ("fused", "seg"):
                    got = rc.reduce_scatter(x.cuda(), 8, op, variant).cpu()
                    assert torch.equal(got, rc.reduce_scatter_plain(x, 8, op)), \
                        (dt, payload, op, variant)
    for dt in (torch.int8, torch.float32, torch.bool):
        for per in (1, 1001, 4096):
            x = torch.arange(8 * per).reshape(8, per).to(dt)
            assert torch.equal(rc.all_gather(x.cuda(), 8).cpu(), x)
            for root in (0, 5):
                assert torch.equal(rc.bcast(x.cuda(), 8, root).cpu(),
                                   rc.bcast_plain(x, 8, root))
