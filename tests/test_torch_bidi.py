"""The port's duplex ring (ompi_tpu_torch/ops/ring_collectives.py: K8 ``bidi``,
K9 ``seg_bidi``, K11 all-gather ``bidi``) held against the JAX package's
Pallas kernels (ompi_tpu/ops/pallas_collectives.py) on the 8-virtual-CPU mesh.

Same numpy inputs to both; the JAX side runs its kernels in interpret mode,
the port its plain versions (CPU tensors).  The port keeps the reference's
duplex block partition (``hrows = ceil(rows/2)``, window-rounded for
seg_bidi), its padding and both halves' fold orders, so every comparison is
bit-exact.  float64 cannot go through the reference here (with x64 off JAX
makes it float32; with x64 on the kernels fail to trace, ``lax.rem`` of an
int32 axis index and an int64 constant), so float64 is held, bit for bit,
against a numpy run of the reference kernel's own steps (``pc:987-1010``).
"""
import numpy as np
import pytest
import torch

from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu_torch.ops import ring_collectives as rc

OPS = ("sum", "prod", "max", "min")
DTYPES = {"float16": np.float16, "float32": np.float32}


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs), ("x",))


def _payload(shape, op, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if op == "prod":   # keep the product well-conditioned
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(dtype)
    # spread over decades, so that another fold order changes the bits
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 4, shape)).astype(dtype)


def _run(fn, x, *args, **kw):
    import jax

    return np.asarray(fn(jax.device_put(x), *args, **kw))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _assert_bits_equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- K8 and K9: the duplex all-reduce ----------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bidi_matches_reference(mesh, dtype, op):
    """(8, 407): an odd payload exercises the even half-split pad
    (tests/test_pallas_coll.py:279-288); kernel wrapper and plain version."""
    x = _payload((8, 407), op, seed=8, dtype=DTYPES[dtype])
    want = _run(pc.all_reduce, x, mesh, "x", op, variant="bidi")
    t = torch.from_numpy(x)
    _assert_bits_equal(rc.all_reduce(t, 8, op, "bidi"), want)
    _assert_bits_equal(rc.all_reduce_bidi_plain(t, 8, op), want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_seg_bidi_matches_reference(mesh, dtype, op):
    """(8, 999) with a 32-element window: the half-split and the window
    pads (tests/test_pallas_coll.py:242-256)."""
    x = _payload((8, 999), op, seed=21, dtype=DTYPES[dtype])
    want = _run(pc.all_reduce, x, mesh, "x", op, variant="seg_bidi",
                seg_elems=32)
    t = torch.from_numpy(x)
    _assert_bits_equal(rc.all_reduce(t, 8, op, "seg_bidi", seg_elems=32), want)
    _assert_bits_equal(rc.all_reduce_seg_bidi_plain(t, 8, op, seg_elems=32),
                       want)


@pytest.mark.parametrize("op", ["max", "min"])
def test_extrema_every_variant_matches_reference(mesh, op):
    """The extrema loop of tests/test_pallas_coll.py:784-805 on the port's
    narrowest ring dtype (float16; the ring takes no bfloat16): the pad
    neutral is the dtype's extremum in every variant."""
    x = (np.random.default_rng(41).standard_normal((8, 37)) * 3
         ).astype(np.float16)
    for variant, seg in (("fused", None), ("seg", 16), ("bidi", None),
                         ("seg_bidi", 16)):
        want = _run(pc.all_reduce, x, mesh, "x", op, variant=variant,
                    seg_elems=seg)
        _assert_bits_equal(rc.all_reduce(torch.from_numpy(x), 8, op, variant,
                                         seg), want)


def test_odd_ring_matches_reference():
    """n = 5: the mirrored rings on an odd ring."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:5]
    if len(devs) < 5:
        pytest.skip("needs 5 virtual devices")
    m5 = Mesh(np.array(devs), ("x",))
    x = _payload((5, 300), "sum", seed=5)
    for variant, seg in (("bidi", None), ("seg_bidi", 32)):
        want = _run(pc.all_reduce, x, m5, "x", "sum", variant=variant,
                    seg_elems=seg)
        _assert_bits_equal(rc.all_reduce(torch.from_numpy(x), 5, "sum",
                                         variant, seg), want)


def _reference_steps(x: np.ndarray, op: str, hrows: int) -> np.ndarray:
    """The reference kernel's schedule in numpy, device by device: every
    device holds its (n, 2, h) accumulator; at step k it sends block my-k's
    first half right and block my+k's second half left, and folds what
    arrives into block my-1-k's first half and block my+1+k's second half,
    ``fold(own, incoming)`` (pc:987-1010); device my ends with block my+1's
    first half and block my-1's second (pc:814-815)."""
    fold = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
            "min": np.minimum}[op]
    n, size = x.shape
    h = hrows * 128
    flat = np.full((n, n * 2 * h), rc._pad_value(op, torch.float64), x.dtype)
    flat[:, :size] = x
    acc = flat.reshape(n, n, 2, h).copy()
    for k in range(n - 1):
        sent = [(acc[(my - 1) % n][(my - 1 - k) % n, 0].copy(),
                 acc[(my + 1) % n][(my + 1 + k) % n, 1].copy())
                for my in range(n)]
        for my in range(n):
            cw, ccw = sent[my]
            r_cw, r_ccw = (my - 1 - k) % n, (my + 1 + k) % n
            acc[my][r_cw, 0] = fold(acc[my][r_cw, 0], cw)
            acc[my][r_ccw, 1] = fold(acc[my][r_ccw, 1], ccw)
    out = np.empty((n, 2, h), x.dtype)
    for my in range(n):
        out[(my + 1) % n, 0] = acc[my][(my + 1) % n, 0]
        out[(my - 1) % n, 1] = acc[my][(my - 1) % n, 1]
    return out.reshape(-1)[:size]


@pytest.mark.parametrize("op", OPS)
def test_float64_follows_the_reference_steps(op):
    """float64 bit for bit against the reference kernel's steps, run in
    numpy (see the module docstring), for both duplex variants."""
    x = _payload((8, 999), op, seed=31, dtype=np.float64)
    t = torch.from_numpy(x)
    for variant, seg in (("bidi", None), ("seg_bidi", 32)):
        hrows = rc.ring_block_elems(999, 8, variant, seg) // 256
        want = _reference_steps(x, op, hrows)
        _assert_bits_equal(rc.all_reduce(t, 8, op, variant, seg), want)


def test_duplex_halves_walk_opposite_ways():
    """Block b's first half is fold(x[b-1], ... fold(x[b+1], x[b])), its
    second half fold(x[b+1], ... fold(x[b-1], x[b])): with non-associative
    float sums the result pins both walks."""
    n, h = 4, 128                 # size 1024: rows 2, hrows 1, blocks of 2h
    x = torch.zeros(n, n * 2 * h, dtype=torch.float32)
    big = 2.0 ** 24
    blk1 = slice(2 * h, 4 * h)    # block 1, both halves
    # both walks start on rank 1 (+big); the clockwise one then meets ranks
    # 2 (+1), 3 (+1), 0 (-big): big + 1 + 1 rounds to big, minus big is 0;
    # the counter-clockwise one meets rank 0 first: (big - big) + 1 + 1 = 2
    x[1, blk1], x[2, blk1], x[3, blk1], x[0, blk1] = big, 1.0, 1.0, -big
    got = rc.all_reduce(x, n, "sum", "bidi")
    assert torch.all(got[2 * h:3 * h] == 0.0)
    assert torch.all(got[3 * h:4 * h] == 2.0)
    assert torch.all(rc.all_reduce(x, n, "sum", "fused")[blk1] == 0.0)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("size", [1, 23, 128, 407, 999, 100003])
def test_duplex_block_partition_matches_reference(n, size):
    """The duplex blocks follow _jit_all_reduce (pc:1586-1599): hrows =
    ceil(rows/2), rounded to whole windows for seg_bidi first."""
    rows = pc._rows_for(-(-size // n))
    hrows = -(-rows // 2)
    assert rc.ring_block_elems(size, n, "bidi") == 2 * hrows * 128
    for seg in (None, 32, 1000, 131072):
        assert rc.ring_block_elems(size, n, "seg_bidi", seg) == \
            2 * pc._seg_rows(hrows, seg)[1] * 128


def test_single_rank_and_empty_payload():
    x = torch.arange(6.0).reshape(1, 6)
    for variant in ("bidi", "seg_bidi"):
        got = rc.all_reduce(x, 1, "max", variant)
        assert torch.equal(got, x[0]) and got.data_ptr() != x.data_ptr()
        assert rc.all_reduce(torch.ones(8, 0), 8, "sum", variant).shape == (0,)


# -- K11: the duplex all-gather -------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 6), (8, 3, 5), (8, 1)])
def test_all_gather_bidi_matches_reference(mesh, shape):
    """tests/test_pallas_coll.py:43-55; a NaN rides along bit for bit."""
    x = _payload(shape, "sum", seed=3)
    x.reshape(8, -1)[2, 0] = np.nan
    want = _run(pc.all_gather, x, mesh, "x", variant="bidi")
    got = rc.all_gather(torch.from_numpy(x), 8, "bidi")
    _assert_bits_equal(got, want)
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()


def test_all_gather_bidi_odd_ring():
    """tests/test_pallas_coll.py:58-74: n = 5 pairs every step."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:5]
    if len(devs) < 5:
        pytest.skip("needs 5 virtual devices")
    x = _payload((5, 4), "sum", seed=5)
    want = _run(pc.all_gather, x, Mesh(np.array(devs), ("x",)), "x",
                variant="bidi")
    _assert_bits_equal(rc.all_gather(torch.from_numpy(x), 5, "bidi"), want)


def test_wrappers_launch_nothing_on_the_cpu():
    before = dict(rc.launches)
    x = torch.ones(8, 300)
    rc.all_reduce(x, 8, "sum", "bidi")
    rc.all_reduce(x, 8, "sum", "seg_bidi", 32)
    rc.all_gather(x, 8, "bidi")
    with pytest.raises(TypeError):
        rc.all_reduce(x.to(torch.int32), 8, "sum", "bidi")
    with pytest.raises(ValueError):
        rc.all_reduce(x, 8, "band", "seg_bidi")
    assert rc.launches == before


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_k8_matches_plain_on_card():
    """K8 against its plain version on the card, bit for bit, with an
    unaligned view (run on a machine with a card; skipped here)."""
    _card()
    for dt in (torch.float16, torch.float32, torch.float64):
        for n, size in ((2, 23), (5, 407), (8, 999), (8, 65536)):
            x = torch.from_numpy(_payload((n * size + 1,), "prod", 11)).to(dt)
            x = x.cuda()
            for t in (x[:n * size].view(n, size), x[1:].view(n, size)):
                for op in OPS:
                    assert torch.equal(rc.all_reduce(t, n, op, "bidi").cpu(),
                                       rc.all_reduce_bidi_plain(t.cpu(), n, op)), \
                        (dt, n, size, op, t.data_ptr() % 16)


@pytest.mark.cuda
def test_k9_matches_plain_on_card():
    """K9 against its plain version on the card, bit for bit."""
    _card()
    for dt in (torch.float16, torch.float32, torch.float64):
        for n, size in ((2, 23), (5, 999), (8, 65536)):
            x = torch.from_numpy(_payload((n, size), "prod", 12)).to(dt)
            for op in OPS:
                for seg in (32, None):
                    got = rc.all_reduce(x.cuda(), n, op, "seg_bidi", seg).cpu()
                    assert torch.equal(
                        got, rc.all_reduce_seg_bidi_plain(x, n, op, seg)), \
                        (dt, n, size, op, seg)


@pytest.mark.cuda
def test_k11_matches_plain_on_card():
    """K11 against its plain version on the card, byte for byte."""
    _card()
    for dt in (torch.int8, torch.float32, torch.bool):
        for n, per in ((3, 1001), (5, 4096), (8, 1)):
            x = torch.arange(n * per).reshape(n, per).to(dt)
            assert torch.equal(rc.all_gather(x.cuda(), n, "bidi").cpu(),
                               rc.all_gather_plain(x, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float16, torch.float32, torch.float64])
@pytest.mark.parametrize("size", [23, 407, 999, "16MB"])
def test_k9_single_pass_matches_plain_on_card(dt, size):
    """K9 in one pass with the accumulator on chip against its plain version
    on the card, bit for bit: every op, window-rounded and default halves,
    from an aligned and an unaligned pointer (run on a machine with a card;
    skipped here)."""
    _card()
    per = (16 << 20) // dt.itemsize if size == "16MB" else size
    gen = torch.Generator(device="cuda").manual_seed(per)
    base = 1.0 + 0.05 * torch.randn(8 * per + 1, device="cuda", generator=gen)
    base = base.to(dt)
    for x in (base[:-1].view(8, per), base[1:].view(8, per)):
        for op in OPS:
            for seg in (32, None):
                assert torch.equal(rc.all_reduce(x, 8, op, "seg_bidi", seg),
                                   rc.all_reduce_seg_bidi_plain(x, 8, op, seg)), \
                    (dt, per, op, seg, x.data_ptr() % 16)
