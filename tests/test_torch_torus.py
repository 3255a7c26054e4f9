"""The port's torus schedules (ompi_tpu_torch/ops/ring_collectives.py:
``all_reduce_torus``, ``reduce_scatter_torus``, ``all_gather_torus``) held
against the JAX package's (ompi_tpu/ops/pallas_collectives.py) on a 2-D
reshape of the 8-virtual-CPU mesh, both axes orders.

The reference runs the 1-D ring kernels as sub-rings of the flattened
``(n0, n1)`` grid in interpret mode; the port its plain versions.  ``axes``
picks which mesh axis is n0: ``axes=("y", "x")`` on an ``("x", "y")`` mesh of
shape (a, b) is the port's call with ``n0, n1 = b, a``.  The sub-rings keep
the reference's blocks, padding and fold orders, so every comparison is
bit-exact (float32; float16 on one case).
"""
import numpy as np
import pytest
import torch

from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu_torch.ops import ring_collectives as rc

SHAPES = [(2, 4), (4, 2)]
AXES = [("x", "y"), ("y", "x")]


def _mesh2d(shape):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs).reshape(shape), ("x", "y"))


def _lengths(mesh2d, axes):
    return mesh2d.shape[axes[0]], mesh2d.shape[axes[1]]


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


def _assert_bits_equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                  want.view(f"u{want.itemsize}"))


@pytest.mark.parametrize("op", ["sum", "max", "prod"])
@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("shape", SHAPES)
def test_all_reduce_torus_matches_reference(shape, axes, op):
    """tests/test_pallas_coll.py:303-322 with both axes orders: 1000
    elements per rank pad both phases' blocks."""
    mesh2d = _mesh2d(shape)
    n0, n1 = _lengths(mesh2d, axes)
    x = _payload((n0, n1, 1000), op, seed=17)
    want = _run(pc.all_reduce_torus, x, mesh2d, axes, op)
    t = torch.from_numpy(x)
    _assert_bits_equal(rc.all_reduce_torus(t, n0, n1, op), want)
    _assert_bits_equal(rc.all_reduce_torus_plain(t, n0, n1, op), want)


def test_all_reduce_torus_float16_matches_reference():
    mesh2d = _mesh2d((4, 2))
    x = _payload((4, 2, 37, 5), "sum", seed=18, dtype=np.float16)
    want = _run(pc.all_reduce_torus, x, mesh2d, ("x", "y"), "sum")
    _assert_bits_equal(rc.all_reduce_torus(torch.from_numpy(x), 4, 2), want)


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("shape", SHAPES)
def test_reduce_scatter_torus_matches_reference(shape, axes):
    """tests/test_pallas_coll.py:325-345: rank i0*n1+i1 ends with global
    block i0*n1+i1; sum and max."""
    mesh2d = _mesh2d(shape)
    n0, n1 = _lengths(mesh2d, axes)
    x = _payload((8, 8, 200), "sum", seed=21)
    t = torch.from_numpy(x)
    for op in ("sum", "max"):
        want = _run(pc.reduce_scatter_torus, x, mesh2d, axes, op=op)
        _assert_bits_equal(rc.reduce_scatter_torus(t, n0, n1, op), want)
        _assert_bits_equal(rc.reduce_scatter_torus_plain(t, n0, n1, op), want)


@pytest.mark.parametrize("axes", AXES)
def test_all_gather_torus_matches_reference(axes):
    """tests/test_pallas_coll.py:348-361: the flat rank order is kept."""
    mesh2d = _mesh2d((2, 4))
    n0, n1 = _lengths(mesh2d, axes)
    g = _payload((8, 3, 5), "sum", seed=23)
    want = _run(pc.all_gather_torus, g, mesh2d, axes)
    got = rc.all_gather_torus(torch.from_numpy(g), n0, n1)
    _assert_bits_equal(got, want)
    assert got.data_ptr() != torch.from_numpy(g).data_ptr()


@pytest.mark.parametrize("axes", AXES)
def test_torus_degenerate_axis_is_the_ring(axes):
    """tests/test_pallas_coll.py:364-381: a 1-wide axis is the 1-D ring,
    whichever order the axes come in."""
    mesh1 = _mesh2d((1, 8))
    n0, n1 = _lengths(mesh1, axes)
    x = _payload((8, 8, 40), "sum", seed=29)
    _assert_bits_equal(rc.reduce_scatter_torus(torch.from_numpy(x), n0, n1),
                       _run(pc.reduce_scatter_torus, x, mesh1, axes))
    g = _payload((8, 12), "sum", seed=31)
    _assert_bits_equal(rc.all_gather_torus(torch.from_numpy(g), n0, n1),
                       _run(pc.all_gather_torus, g, mesh1, axes))
    a = _payload((n0, n1, 300), "sum", seed=37)
    _assert_bits_equal(rc.all_reduce_torus(torch.from_numpy(a), n0, n1),
                       _run(pc.all_reduce_torus, a, mesh1, axes, "sum"))


def test_torus_fold_order_is_rows_of_columns():
    """An element is the row-ring fold (start: its phase-2 block) of the
    column-ring folds (start: i0+1): with non-associative float sums the
    result pins it.  (n0, n1) = (2, 2), one element per rank: blocks of
    128, so the element lies in column block 0 and row block 0."""
    big = 2.0 ** 24
    x = torch.zeros(2, 2, 1)
    # columns start on i0 = 1: column i1=0 is x[0,0] + x[1,0], column 1 the
    # same; then the row ring from i1 = 0: col1 + col0
    x[1, 0], x[0, 0] = big, 1.0          # column 0: 1 + big = big
    x[1, 1], x[0, 1] = -big, 1.0         # column 1: 1 - big = -(big - 1)
    # rows: col0 + col1 = big - (big - 1) = 1; another order of the four
    # (big + 1 + 1 - big, say) would give 0 or 2
    assert rc.all_reduce_torus(x, 2, 2).item() == 1.0


def test_torus_wrappers_check_and_launch_nothing_on_the_cpu():
    before = dict(rc.launches)
    with pytest.raises(ValueError):
        rc.all_reduce_torus(torch.ones(2, 3, 5), 2, 4)
    with pytest.raises(ValueError):
        rc.reduce_scatter_torus(torch.ones(8, 7, 5), 2, 4)
    with pytest.raises(TypeError):
        rc.all_reduce_torus(torch.ones(2, 4, 5, dtype=torch.int32), 2, 4)
    with pytest.raises(ValueError):
        rc.all_reduce_torus(torch.ones(2, 4, 5), 2, 4, "band")
    rc.all_reduce_torus(torch.ones(2, 4, 5), 2, 4)
    rc.reduce_scatter_torus(torch.ones(8, 8, 5), 4, 2)
    assert rc.launches == before


@pytest.mark.cuda
def test_torus_matches_plain_on_card():
    """The sub-ring launches of K3/K5 against the plain composition on the
    card, bit for bit (run on a machine with a card; skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dt in (torch.float16, torch.float32, torch.float64):
        for n0, n1 in ((2, 4), (4, 2), (3, 2)):
            for size in (23, 1000, 4096):
                x = torch.from_numpy(_payload((n0, n1, size), "prod", 3)).to(dt)
                for op in ("sum", "prod", "max", "min"):
                    assert torch.equal(
                        rc.all_reduce_torus(x.cuda(), n0, n1, op).cpu(),
                        rc.all_reduce_torus_plain(x, n0, n1, op)), (dt, n0, n1, size, op)
            y = torch.from_numpy(_payload((n0 * n1,) * 2 + (200,), "sum", 4)).to(dt)
            for op in ("sum", "max"):
                assert torch.equal(
                    rc.reduce_scatter_torus(y.cuda(), n0, n1, op).cpu(),
                    rc.reduce_scatter_torus_plain(y, n0, n1, op)), (dt, n0, n1, op)
