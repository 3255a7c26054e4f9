"""The port's exchange tier (ompi_tpu_torch/ops/ring_collectives.py:
right_permute, all_to_all, all_to_all_v, all_gather_v) held against the JAX
package's Pallas kernels (ompi_tpu/ops/pallas_collectives.py) on the
8-virtual-CPU mesh.

Same numpy inputs to both; the JAX side runs its kernels in interpret mode,
the port its plain versions (CPU tensors).  All four move bytes, so every
comparison is bit-exact, on float32, int32, bfloat16 and int8.  The ragged
pair is compared over the valid rows only: in interpret mode the reference
moves whole blocks (``_ragged_nchunks``, ``pallas_collectives.py:1449-1464``),
so its rows past a count are x's rows, while on hardware -- and in the port
-- they are unspecified.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import ring_collectives as rc

N = 8
KINDS = {"float32": np.float32, "int32": np.int32,
         "bfloat16": ml_dtypes.bfloat16, "int8": np.int8}


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != N:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs), ("x",))


def _stack(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind in ("int32", "int8"):
        return rng.integers(-100, 100, shape).astype(KINDS[kind])
    return rng.standard_normal(shape).astype(KINDS[kind])


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = cudaenv.to_numpy(a)
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _run(fn, x, *args, **kw) -> np.ndarray:
    import jax

    return np.asarray(fn(jax.device_put(x), *args, **kw))


def _torch(x: np.ndarray) -> torch.Tensor:
    return cudaenv.make_world_array(x, "cpu")


def _counts(shape, rows: int, seed: int) -> np.ndarray:
    """Counts over [-2, rows + 3], with a 0, an R, an R + 3 and a negative
    count forced in."""
    c = np.random.default_rng(seed).integers(-2, rows + 4, shape)
    flat = c.reshape(-1)
    flat[:4] = (0, rows, rows + 3, -1)
    return c.astype(np.int32)


# -- right_permute (K13) and all_to_all (K14) -------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("payload", [(6,), (3, 5)])
def test_right_permute_matches_reference(mesh, kind, payload):
    x = _stack(kind, (N, *payload), seed=1)
    want = _run(pc.right_permute, x, mesh, "x")
    got = rc.right_permute(_torch(x), N)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(rc.right_permute_plain(_torch(x), N)),
                                  _bits(want))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("payload", [(3,), (2, 5)])
def test_all_to_all_matches_reference(mesh, kind, payload):
    x = _stack(kind, (N, N, *payload), seed=2)
    want = _run(pc.all_to_all, x, mesh, "x")
    got = rc.all_to_all(_torch(x), N)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(rc.all_to_all_plain(_torch(x), N)),
                                  _bits(want))


# -- the ragged pair (K15, K16) ----------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("rows", [5, 16])
def test_all_to_all_v_matches_reference(mesh, kind, rows):
    """R = 5 is not a whole number of chunk_rows (8): the reference pads it
    and slices the padding off; R = 16 is two chunks."""
    x = _stack(kind, (N, N, rows, 128), seed=3)
    counts = _counts((N, N), rows, seed=4)
    want = _run(pc.all_to_all_v, x, counts, mesh, "x")
    got = cudaenv.to_numpy(rc.all_to_all_v(_torch(x), counts, N))
    plain = cudaenv.to_numpy(rc.all_to_all_v_plain(_torch(x), counts, N))
    assert got.shape == want.shape == x.shape
    clamped = np.clip(counts, 0, rows)
    for i in range(N):
        for j in range(N):
            c = clamped[i, j]
            for out in (got, plain):
                np.testing.assert_array_equal(_bits(out[j, i, :c]),
                                              _bits(want[j, i, :c]))
            np.testing.assert_array_equal(_bits(got[j, i, :c]),
                                          _bits(x[i, j, :c]))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("rows", [5, 16])
def test_all_gather_v_matches_reference(mesh, kind, rows):
    x = _stack(kind, (N, rows, 256), seed=5)
    counts = _counts((N,), rows, seed=6)
    want = _run(pc.all_gather_v, x, counts, mesh, "x")
    got = cudaenv.to_numpy(rc.all_gather_v(_torch(x), counts, N))
    plain = cudaenv.to_numpy(rc.all_gather_v_plain(_torch(x), counts, N))
    assert got.shape == want.shape == x.shape
    for i, c in enumerate(np.clip(counts, 0, rows)):
        for out in (got, plain):
            np.testing.assert_array_equal(_bits(out[i, :c]), _bits(want[i, :c]))
        np.testing.assert_array_equal(_bits(got[i, :c]), _bits(x[i, :c]))


def test_ragged_counts_are_clamped():
    """A count above R moves R rows and a negative one none; the table is
    clamped to [0, R] before any copy, as the reference clips it."""
    table = rc._ragged_counts([[-4, 2], [9, 3]], (2, 2), 3, "all_to_all_v")
    assert table.dtype == torch.int32 and table.tolist() == [[0, 2], [3, 3]]
    x = torch.arange(2 * 2 * 3 * 128, dtype=torch.float32).reshape(2, 2, 3, 128)
    out = rc.all_to_all_v(x, [[-4, 2], [9, 3]], 2)
    assert torch.equal(out[1, 0, :2], x[0, 1, :2])
    assert torch.equal(out[0, 1], x[1, 0])              # 9 clamps to R = 3
    dev = torch.tensor([5, -1], dtype=torch.int64)
    assert rc._ragged_counts(dev, (2,), 3, "all_gather_v").tolist() == [3, 0]


@pytest.mark.parametrize("what", ["all_to_all_v", "all_gather_v"])
def test_ragged_shape_errors_match_reference(mesh, what):
    """Both packages raise ValueError on a row width that is not a whole
    number of 128 lanes, on a malformed layout and on a counts table of the
    wrong shape."""
    a2av = what == "all_to_all_v"
    ok_shape, counts = ((N, N, 4, 128), np.ones((N, N), np.int32)) if a2av \
        else ((N, 4, 128), np.ones(N, np.int32))
    bad_width = ok_shape[:-1] + (100,)
    bad_layout = (N, 7, 4, 128) if a2av else (N, 4, 128, 1)
    bad_counts = np.ones(N + 1, np.int32)
    ref, port = getattr(pc, what), getattr(rc, what)
    for shape, c in ((bad_width, counts), (bad_layout, counts),
                     (ok_shape, bad_counts)):
        x = np.zeros(shape, np.float32)
        with pytest.raises(ValueError):
            ref(x, c, mesh, "x")
        with pytest.raises(ValueError):
            port(torch.from_numpy(x), c, N)


def test_all_to_all_layout_errors_match_reference(mesh):
    for shape in ((N, 7, 3), (N,)):
        x = np.zeros(shape, np.float32)
        with pytest.raises(ValueError):
            pc.all_to_all(x, mesh, "x")
        with pytest.raises(ValueError):
            rc.all_to_all(torch.from_numpy(x), N)


def test_degenerate_calls_return_x():
    """n == 1 returns x for all four wrappers, and R == 0 or W == 0 returns
    x for the ragged pair (after the counts table is checked), as in the
    reference."""
    one, row = torch.ones(1, 1, 2, 128), torch.ones(1, 2, 128)
    for fn, x, c in ((rc.right_permute, row, None),
                     (rc.all_to_all, one, None),
                     (rc.all_to_all_v, one, [[1]]),
                     (rc.all_gather_v, row, [1])):
        got = fn(x, 1) if c is None else fn(x, c, 1)
        assert got is x
    empty = torch.zeros(N, N, 0, 128)
    assert rc.all_to_all_v(empty, np.ones((N, N)), N) is empty
    assert rc.all_gather_v(torch.zeros(N, 4, 0), np.ones(N), N).shape == (N, 4, 0)
    with pytest.raises(ValueError):
        rc.all_to_all_v(empty, np.ones(N), N)


def test_chunk_rows_fixes_no_value():
    x = torch.from_numpy(_stack("float32", (N, N, 11, 128), seed=7))
    counts = _counts((N, N), 11, seed=8)
    c = np.clip(counts, 0, 11)
    outs = [rc.all_to_all_v(x, counts, N, chunk_rows=k) for k in (1, 8, 64)]
    for i in range(N):
        for j in range(N):
            for out in outs[1:]:
                assert torch.equal(out[j, i, :c[i, j]], outs[0][j, i, :c[i, j]])


def test_cpu_calls_launch_nothing():
    before = dict(rc.launches)
    x = torch.ones(N, N, 2, 128)
    rc.right_permute(x, N)
    rc.all_to_all(x, N)
    rc.all_to_all_v(x, np.ones((N, N)), N)
    rc.all_gather_v(x[0], np.ones(N), N)
    assert rc.launches == before
    with pytest.raises(TypeError):
        rc.all_to_all(np.ones((N, N)), N)


# -- the kernels on the card ---------------------------------------------------

def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.uint8), b.cpu().view(torch.uint8))


@pytest.mark.cuda
def test_dense_kernels_match_plain_on_card():
    """K13 and K14 against their plain versions on the card, byte for byte,
    on aligned and odd lengths (run on a machine with a card; skipped
    here)."""
    _on_card()
    for dt in (torch.float32, torch.float16, torch.int8, torch.bool):
        for per in (1, 1001, 4096):
            x = torch.arange(N * N * per).reshape(N, N, per).to(dt).cuda()
            assert _same(rc.right_permute(x[0].contiguous(), N),
                         rc.right_permute_plain(x[0], N)), (dt, per)
            assert _same(rc.all_to_all(x, N), rc.all_to_all_plain(x, N)), (dt, per)


@pytest.mark.cuda
def test_ragged_kernels_match_plain_on_card():
    """K15 and K16 against their plain versions over the valid rows, with
    counts from a host table and from a device tensor (skipped here)."""
    _on_card()
    for dt in (torch.float32, torch.int32, torch.bfloat16, torch.int8):
        for rows in (5, 16):
            x = torch.from_numpy(_stack("float32", (N, N, rows, 128), 9)).to(dt).cuda()
            counts = _counts((N, N), rows, seed=10)
            c = np.clip(counts, 0, rows)
            for table in (counts, torch.from_numpy(counts).cuda()):
                got = rc.all_to_all_v(x, table, N)
                want = rc.all_to_all_v_plain(x, counts, N)
                assert all(_same(got[j, i, :c[i, j]], want[j, i, :c[i, j]])
                           for i in range(N) for j in range(N)), (dt, rows)
                got = rc.all_gather_v(x[0], table[0], N)
                assert all(_same(got[i, :c[0, i]], x[0, i, :c[0, i]])
                           for i in range(N)), (dt, rows)
