"""The port's op host kernels, the op framework's ``fusable`` flag and the
accelerator's residency test (``ompi_tpu_torch/api/op.py``,
``mca/op/base.py``, ``mca/accelerator/torch_acc.py``), held against
``ompi_tpu/api/op.py``, ``ompi_tpu/mca/op`` and
``ompi_tpu/mca/accelerator/jax_acc.py``.

The host kernels are numpy on both sides: the same inputs give the same
bits.  ``fusable=True`` (scan and exscan) makes the kernel component
decline in both packages, so those folds never launch K2.
"""
import numpy as np
import pytest
import torch

from ompi_tpu.api import op as jop
from ompi_tpu_torch.api import op as top
from ompi_tpu_torch.api.errors import ErrorClass, MpiError

OPS = ("SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR",
       "BXOR", "REPLACE", "NO_OP")


def _operands(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return (rng.integers(-9, 10, (4, 33)).astype(np.int32),
                rng.integers(-9, 10, (4, 33)).astype(np.int32))
    return (rng.standard_normal((4, 33)).astype(kind),
            rng.standard_normal((4, 33)).astype(kind))


#: (op, dtype): every op on int32, all but the bitwise ones on floats
HOST_CASES = [(name, kind) for name in OPS
              for kind in ("int32", "float32", "float64")
              if kind == "int32" or name not in ("BAND", "BOR", "BXOR")]


@pytest.mark.parametrize("name,kind", HOST_CASES)
def test_host_kernel_matches_reference(name, kind):
    """``op(invec, inoutvec)`` writes ``invec (op) inoutvec`` into
    ``inoutvec`` in place, bit for bit as the reference's kernel."""
    a, b = _operands(kind, seed=len(name))
    want, got = b.copy(), b.copy()
    getattr(jop, name)(a, want)
    getattr(top, name)(a, got)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                  want.view(f"u{want.itemsize}"))
    np.testing.assert_array_equal(
        getattr(top, name).reduce_arrays(a, b),
        getattr(jop, name).reduce_arrays(a, b))


@pytest.mark.parametrize("name", ["MAXLOC", "MINLOC"])
def test_loc_ops_match_reference(name):
    pair = np.dtype([("v", np.float64), ("i", np.int32)])
    rng = np.random.default_rng(3)
    a, b = np.zeros(16, pair), np.zeros(16, pair)
    a["v"], b["v"] = rng.integers(0, 3, 16), rng.integers(0, 3, 16)
    a["i"], b["i"] = rng.integers(0, 8, 16), rng.integers(0, 8, 16)
    want, got = b.copy(), b.copy()
    getattr(jop, name)(a, want)
    getattr(top, name)(a, got)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(MpiError) as e:
        getattr(top, name)(np.ones(3), np.ones(3))
    assert e.value.error_class is ErrorClass.ERR_OP


def test_user_op_is_not_commutative_and_keeps_argument_order():
    """``create(fn, commute)``: fn(invec, inoutvec, datatype) with the
    reference's argument order, named per function, its commute flag kept;
    it has no device lowering."""
    def sub(invec, inoutvec, datatype=None):
        inoutvec[...] = invec - inoutvec

    mine, ref = top.create(sub, commute=False), jop.create(sub, commute=False)
    assert mine.name == ref.name and mine.commute is False and not mine.builtin
    a, b = np.arange(4.0), np.ones(4)
    np.testing.assert_array_equal(mine.reduce_arrays(a, b),
                                  ref.reduce_arrays(a, b))
    with pytest.raises(MpiError) as e:
        top.torch_fold(mine, torch.float32)
    assert e.value.error_class is ErrorClass.ERR_OP


def test_an_op_without_a_kernel_is_not_callable():
    op = top.Op("ORDERED_SUM", commute=False, torch_reduce="sum")
    with pytest.raises(MpiError) as e:
        op(np.ones(2), np.ones(2))
    assert e.value.error_class is ErrorClass.ERR_OP


@pytest.mark.parametrize("name", ["SUM", "MAX", "BAND"])
def test_fusable_fold_comes_from_the_builtin_component(name):
    """``fusable=True`` declines the kernel component (cuda_vpu, as
    pallas_vpu declines in the reference): the fold is the builtin torch
    one, also where cuda_vpu would win."""
    from ompi_tpu_torch.mca.op import base as op_base
    from ompi_tpu_torch.mca.op import builtin_op, cuda_vpu

    dtype = torch.int32 if name == "BAND" else torch.float32
    assert cuda_vpu.COMPONENT.query_fold(name, dtype, fusable=True) is None
    assert cuda_vpu.COMPONENT.query_fold(name, dtype) is not None
    assert op_base.select_fold(name, dtype, fusable=True) is \
        builtin_op.COMPONENT.query_fold(name, dtype)
    fold = top.torch_fold(getattr(top, name), dtype, fusable=True)
    a = torch.arange(6, dtype=dtype)
    assert torch.equal(fold(a, a + 1), builtin_op._TABLE[name](a, a + 1))


def test_reference_fusable_fold_declines_the_kernel_too():
    from ompi_tpu.mca.op import pallas_vpu

    assert pallas_vpu.COMPONENT.query_fold("SUM", np.float32,
                                           fusable=True) is None


def test_every_tensor_is_a_device_array():
    """As any jax.Array counts in the reference, CPU-backed ones included,
    any torch tensor counts, whatever its device; numpy does not."""
    import jax.numpy as jnp
    from ompi_tpu.mca.accelerator import jax_acc
    from ompi_tpu_torch.mca.accelerator import torch_acc

    assert torch_acc.is_device_array(torch.ones(2))
    assert jax_acc.is_device_array(jnp.ones(2))
    for host in (np.ones(2), [1.0, 2.0], 3.0):
        assert not torch_acc.is_device_array(host)
        assert not jax_acc.is_device_array(host)


def test_to_host_and_from_host_round_trip():
    import ml_dtypes
    from ompi_tpu_torch.mca.accelerator import torch_acc

    for arr in (np.arange(6, dtype=np.int32).reshape(2, 3),
                np.linspace(-1, 1, 5).astype(ml_dtypes.bfloat16)):
        t = torch_acc.from_host(arr, "cpu")
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        back = torch_acc.to_host(t)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(torch_acc.to_host([1, 2]), np.array([1, 2]))
