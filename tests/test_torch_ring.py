"""The port's ring all-reduce (ompi_tpu_torch/ops/ring_collectives.py) held
against the JAX package's Pallas ring kernels
(ompi_tpu/ops/pallas_collectives.py) on the 8-virtual-CPU mesh.

Same numpy inputs to both; the JAX side runs its fused and segmented ring
kernels in interpret mode, the port its plain versions (CPU tensors).  The
port keeps the reference's ring-block partition, padding and fold order, so
every comparison is bit-exact (float32).
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
    return rng.standard_normal(shape).astype(np.float32)


def _reference(mesh, x, op, **kw):
    import jax

    return np.asarray(pc.all_reduce(jax.device_put(x), mesh, "x", op, **kw))


def _assert_bits_equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("payload", [(24,), (23,), (5, 7)])
def test_fused_matches_reference(mesh, payload, op):
    x = _payload((8, *payload), op, seed=1)
    want = _reference(mesh, x, op)
    _assert_bits_equal(rc.all_reduce(torch.from_numpy(x), 8, op), want)
    _assert_bits_equal(rc.all_reduce_fused_plain(torch.from_numpy(x), 8, op),
                       want)


@pytest.mark.parametrize("op", OPS)
def test_segmented_matches_reference(mesh, op):
    """1000 elements per rank and a 32-element window: both the ring-block
    pad and the window pad are exercised (as in test_pallas_coll)."""
    x = _payload((8, 1000), op, seed=7)
    want = _reference(mesh, x, op, variant="seg", seg_elems=32)
    _assert_bits_equal(
        rc.all_reduce(torch.from_numpy(x), 8, op, "seg", seg_elems=32), want)
    _assert_bits_equal(
        rc.all_reduce_seg_plain(torch.from_numpy(x), 8, op, seg_elems=32),
        want)


def test_fold_order_is_the_ring_order():
    """Block b is fold(x[b-1], ... fold(x[b+1], x[b])): with non-associative
    float sums the result pins that order, not just the value set."""
    n, blk = 4, 128
    x = torch.zeros(n, n * blk, dtype=torch.float32)
    big = 2.0 ** 24
    # block 1 starts on rank 1 (+big), then ranks 2 (+1), 3 (-big), 0 (+1):
    # ((big + 1) - big) + 1 = 1 in float32, as big + 1 rounds to big; rank
    # order 0..3 would give ((1 + big) + 1) - big = 0
    b1 = slice(blk, 2 * blk)
    x[1, b1], x[2, b1], x[3, b1], x[0, b1] = big, 1.0, -big, 1.0
    got = rc.all_reduce(x, n, "sum")
    assert torch.all(got[b1] == 1.0)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("size", [1, 23, 128, 1000, 4096, 100003])
def test_ring_block_partition_matches_reference(n, size):
    """The block partition decides which rank a block's fold starts on; it
    follows _jit_all_reduce (blk = ceil(size/n) in 128-lane rows, the seg
    variant rounding rows up to whole windows)."""
    rows = pc._rows_for(-(-size // n))
    assert rc.ring_block_elems(size, n, "fused") == rows * 128
    for seg in (None, 32, 1000, 131072):
        assert rc.ring_block_elems(size, n, "seg", seg) == \
            pc._seg_rows(rows, seg)[1] * 128


@pytest.mark.parametrize("op", OPS)
def test_pad_value_matches_reference(op):
    import ml_dtypes

    for np_dt, t_dt in ((np.float32, torch.float32),
                        (np.float16, torch.float16),
                        (ml_dtypes.bfloat16, torch.bfloat16),
                        (np.int32, torch.int32), (np.int8, torch.int8)):
        assert float(rc._pad_value(op, t_dt)) == \
            float(pc._pad_value(op, np_dt)), (op, np_dt)


def test_wrapper_argument_checks(mesh):
    """K3/K4 wrappers raise on what the kernels do not take (the checks are
    shared by the CPU path and the card path); the duplex variants, once not
    ported, match the reference."""
    x = torch.ones(8, 16)
    before = dict(rc.launches)
    with pytest.raises(TypeError):
        rc.all_reduce(x.to(torch.int32), 8)
    with pytest.raises(TypeError):
        rc.all_reduce(x.to(torch.bfloat16), 8)
    with pytest.raises(ValueError):
        rc.all_reduce(x, 4)                        # leading axis is not n
    with pytest.raises(ValueError):
        rc.all_reduce(torch.ones(16, 8).t(), 8)    # not contiguous
    with pytest.raises(ValueError):
        rc.all_reduce(x, 8, "band")
    with pytest.raises(ValueError):
        rc.all_reduce(x, 8, variant="tree")
    for variant in ("bidi", "seg_bidi"):
        _assert_bits_equal(rc.all_reduce(x, 8, variant=variant),
                           _reference(mesh, x.numpy(), "sum", variant=variant))
    assert rc.launches == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K3 and K4 against their plain versions on the card, bit for bit
    (run on a machine with a card; skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dt in (torch.float16, torch.float32, torch.float64):
        for size in (23, 1000, 65536):
            x = torch.from_numpy(_payload((8, size), "prod", 11)).to(dt)
            for op in OPS:
                for variant, seg in (("fused", None), ("seg", 32)):
                    got = rc.all_reduce(x.cuda(), 8, op, variant, seg).cpu()
                    assert torch.equal(got, rc.all_reduce(x, 8, op, variant, seg)), \
                        (dt, size, op, variant)


#: per-rank sizes of the single-pass cases: odd lengths, and 16 MB
SEG_SIZES = (23, 407, 999, "16MB")


def _card_operands(dt, per, seed):
    """A (8 * per + 1,) tensor on the card: its first 8 * per elements (an
    aligned view) and its last (a pointer 1 element off)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(8 * per + 1, device="cuda", generator=gen)
    base = (1.0 + 0.05 * base).to(dt)   # products stay well-conditioned
    return base[:-1].view(8, per), base[1:].view(8, per)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float16, torch.float32, torch.float64])
@pytest.mark.parametrize("size", SEG_SIZES)
def test_single_pass_seg_matches_plain_on_card(dt, size):
    """K4 (all_reduce seg) and K6 (reduce_scatter seg), one pass with the
    accumulator on chip, against their plain versions on the card, bit for
    bit: every op, aligned and unaligned (run on a machine with a card;
    skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    per = (16 << 20) // dt.itemsize if size == "16MB" else size
    for x in _card_operands(dt, per, per):
        for op in OPS:
            for seg in (32, None):
                assert torch.equal(rc.all_reduce(x, 8, op, "seg", seg),
                                   rc.all_reduce_seg_plain(x, 8, op, seg)), \
                    (dt, per, op, seg, x.data_ptr() % 16)
    # the reduce-scatter's blocks are the payload: (8, 8, per / 8) and ragged
    rs_per = per // 8 if per % 8 == 0 else per
    for x in _card_operands(dt, 8 * rs_per, per + 1):
        y = x.reshape(8, 8, rs_per)
        for op in OPS:
            assert torch.equal(rc.reduce_scatter(y, 8, op, "seg"),
                               rc.reduce_scatter_plain(y, 8, op)), \
                (dt, rs_per, op, y.data_ptr() % 16)
