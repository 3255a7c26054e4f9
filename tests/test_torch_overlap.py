"""The collective matmul K20 (ompi_tpu_torch/ops/overlap.py) held against the
JAX package's ``ompi_tpu.ops.pallas_overlap``.

Same numpy inputs go through both: the reference's Pallas kernel in
interpret mode on the 8-virtual-CPU mesh (as tests/test_pallas_coll.py runs
it), the port's plain version on the CPU.  Bands, stated per comparison:

* integer-valued inputs (|a|, |b| <= 12): bit-exact.  Every float32
  partial is then an exact integer (up to 1152, past bfloat16's 256), so
  what is compared is the schedule: each partial rounded to the dtype
  before it is folded, and the ring fold order (in bfloat16 both round at
  every step);
* random normal inputs: within 1e-5 (float32) and 2^-7 (bfloat16) of the
  largest ``Σ|a||b|``, and bfloat16 within (n + 1)·2^-8 of ``max|C|`` as
  well (half an ulp for each of the n partials and the folds): the two
  packages take each partial's products in other orders, and in bfloat16
  a partial that lands near a rounding boundary may round the other way.

The ``cuda``-marked cases hold the kernel against its plain version on the
card (skipped here).
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ompi_tpu.ops import pallas_overlap as po
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import overlap

N, K, NC = 8, 64, 16
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
#: bands on random inputs, in units of the largest Σ|a||b|; bfloat16 is
#: also held within the schedule's roundings, half an ulp (2^-8 relative)
#: of at most max|C| for each of the n partials and the folds
BANDS = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
FOLD_BAND = (N + 1) * 2.0 ** -8
FORMS = {"allreduce": (po.matmul_allreduce, overlap.matmul_allreduce),
         "reduce_scatter": (po.matmul_reduce_scatter,
                            overlap.matmul_reduce_scatter)}


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs), ("x",))


def _operands(m, kind, dtype, seed, n=N, k=K, nc=NC):
    rng = np.random.default_rng(seed)
    if kind == "int":
        a = rng.integers(-12, 13, (n, m, k // n))
        b = rng.integers(-12, 13, (n, k // n, nc))
    else:
        a = rng.standard_normal((n, m, k // n))
        b = rng.standard_normal((n, k // n, nc))
    return a.astype(DTYPES[dtype]), b.astype(DTYPES[dtype])


def _t(x):
    return cudaenv.make_world_array(x, "cpu")


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(f"u{x.dtype.itemsize}")


def _scale(a, b):
    """The largest Σ|a||b| of an output element."""
    a, b = np.abs(a.astype(np.float64)), np.abs(b.astype(np.float64))
    return float(np.einsum("nmk,nko->mo", a, b).max())


def _band(dtype: str, scale: float, c_max: float) -> float:
    band = BANDS[dtype] * scale
    return min(band, FOLD_BAND * c_max) if dtype == "bfloat16" else band


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("form, m", [("allreduce", 32), ("allreduce", 33),
                                     ("reduce_scatter", 32),
                                     ("reduce_scatter", 30)])
def test_matches_reference(mesh, form, m, kind, dtype):
    ref_fn, port_fn = FORMS[form]
    a, b = _operands(m, kind, dtype, seed=m + len(form))
    want = np.asarray(ref_fn(jax.device_put(a), jax.device_put(b), mesh, "x"))
    got = cudaenv.to_numpy(port_fn(_t(a), _t(b), N))
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "int":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        want = want.astype(np.float64)
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= _band(dtype, _scale(a, b), np.abs(want).max()), err


@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_version_is_the_wrapper_on_the_cpu(form):
    a, b = _operands(33, "int", "bfloat16", seed=5)
    plain = getattr(overlap, f"matmul_{form}_plain")
    got, want = FORMS[form][1](_t(a), _t(b), N), plain(_t(a), _t(b), N)
    assert torch.equal(got, want)


def test_bf16_rounds_each_partial_and_each_fold():
    """Integer partials past 256 are not bf16 numbers: the schedule's
    roundings make the result differ from the exact sum rounded once."""
    a, b = _operands(32, "int", "bfloat16", seed=3)
    got = overlap.matmul_allreduce(_t(a), _t(b), N).float()
    exact = torch.einsum("nmk,nko->mo", _t(a).double(), _t(b).double())
    assert not torch.equal(got, exact.to(torch.bfloat16).float())
    assert (got - exact).abs().max() <= 2.0 ** -7 * exact.abs().max() * N


@pytest.mark.parametrize("form", sorted(FORMS))
def test_n1_is_the_plain_product(form):
    devs = jax.devices()
    mesh1 = Mesh(np.array(devs[:1]), ("x",))
    a, b = _operands(5, "random", "float32", seed=7, n=1, k=8)
    want = np.asarray(FORMS[form][0](jax.device_put(a), jax.device_put(b),
                                     mesh1, "x"))
    got = FORMS[form][1](_t(a), _t(b), 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    a16, b16 = _operands(5, "int", "bfloat16", seed=8, n=1, k=8)
    want16 = np.asarray(FORMS[form][0](jax.device_put(a16),
                                       jax.device_put(b16), mesh1, "x"))
    got16 = cudaenv.to_numpy(FORMS[form][1](_t(a16), _t(b16), 1))
    np.testing.assert_array_equal(_bits(got16), _bits(want16))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_mixed_dtypes_promote_outside_the_kernel(mesh, form):
    a, _ = _operands(16, "int", "float32", seed=9)
    _, b = _operands(16, "int", "bfloat16", seed=10)
    want = np.asarray(FORMS[form][0](jax.device_put(a), jax.device_put(b),
                                     mesh, "x"))
    got = FORMS[form][1](_t(a), _t(b), N)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_contraction_mismatch_raises(mesh, form):
    a = np.zeros((8, 4, 8), np.float32)
    b = np.zeros((8, 7, 5), np.float32)
    with pytest.raises(ValueError, match="contraction mismatch"):
        FORMS[form][0](jax.device_put(a), jax.device_put(b), mesh, "x")
    with pytest.raises(ValueError, match="contraction mismatch"):
        FORMS[form][1](_t(a), _t(b), N)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_rank_layout_is_checked(form):
    a, b = _operands(8, "int", "float32", seed=11)
    with pytest.raises(ValueError, match=r"needs a \(4, M, K/n\)"):
        FORMS[form][1](_t(a), _t(b), 4)
    with pytest.raises(TypeError):
        FORMS[form][1](a, b, N)


def test_reduce_scatter_keeps_the_padded_tail():
    """M = 30 over 8 ranks: blocks of 4 rows, the last two rows zero."""
    a, b = _operands(30, "int", "float32", seed=12)
    out = overlap.matmul_reduce_scatter(_t(a), _t(b), N)
    assert out.shape == (N, 4, NC)
    assert not out.reshape(32, NC)[30:].any()
    full = overlap.matmul_allreduce(_t(a), _t(b), N)
    assert torch.equal(out.reshape(32, NC)[:30], full)


def test_no_launch_on_the_cpu():
    before = dict(overlap.launches)
    a, b = _operands(32, "int", "float32", seed=13)
    overlap.matmul_allreduce(_t(a), _t(b), N)
    overlap.matmul_reduce_scatter(_t(a), _t(b), N)
    assert overlap.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m", [32, 33, 300, 1027])
@pytest.mark.parametrize("k, nc", [(40, 200), (37, 203)])
def test_kernel_matches_plain_on_card(form, dtype, m, k, nc):
    """K20 on the card against its plain version: bit-equal on integer
    inputs, within the band on random ones; k and nc multiples of 8 (the
    bfloat16 kernel's 16-byte copies) and not (its element loads) (run on
    a machine with a card; skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(m)
    kernel = FORMS[form][1]
    plain = getattr(overlap, f"matmul_{form}_plain")
    for kind in ("int", "random"):
        if kind == "int":
            a = torch.randint(-4, 5, (N, m, k), generator=gen, device="cuda")
            b = torch.randint(-4, 5, (N, k, nc), generator=gen, device="cuda")
        else:
            a = torch.randn((N, m, k), generator=gen, device="cuda")
            b = torch.randn((N, k, nc), generator=gen, device="cuda")
        a, b = a.to(dtype), b.to(dtype)
        key = f"matmul_{form}"
        before = overlap.launches[key]
        got, want = kernel(a, b, N), plain(a, b, N)
        torch.cuda.synchronize()
        assert overlap.launches[key] == before + 1
        if kind == "int":
            assert torch.equal(got, want)
        else:
            scale = torch.einsum("nmk,nko->mo", a.abs().float(),
                                 b.abs().float()).max()
            band = _band(str(dtype)[6:], scale.item(),
                         want.float().abs().max().item())
            assert (got.float() - want.float()).abs().max() <= band


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.ones((N, 8, 4), dtype=torch.float16, device="cuda")
    b = torch.ones((N, 4, 8), dtype=torch.float16, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        overlap.matmul_allreduce(a, b, N)
