"""The port's fold kernels (ompi_tpu_torch/ops/reduce.py, op/cuda_vpu) held
against the JAX package's Pallas kernels (ompi_tpu/ops/pallas_reduce.py).

Inputs come from numpy with a fixed seed and go through both packages; the
JAX side runs its Pallas kernels in interpret mode on the CPU, the port its
plain versions (CPU tensors).  Folds are elementwise, so every comparison is
bit-exact, bfloat16 included (both round each fold once, to nearest even).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ompi_tpu.ops import pallas_reduce as pr
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import reduce

OPS = reduce.supported_ops()
DTYPES = {
    "float32": (np.float32, torch.float32),
    "int32": (np.int32, torch.int32),
    "int8": (np.int8, torch.int8),
    "bool": (np.bool_, torch.bool),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
}


def _operands(np_dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np_dtype is np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    if np.issubdtype(np_dtype, np.integer):
        info = np.iinfo(np_dtype)
        # with zeros, so the logical ops see both truth values
        return rng.integers(max(info.min, -40), min(info.max, 40) + 1,
                            shape).astype(np_dtype)
    # values near 1 keep PROD away from overflow and underflow
    x = 1.0 + 0.25 * rng.standard_normal(shape)
    x[..., ::7] = 0.0
    return x.astype(np_dtype)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(f"u{a.dtype.itemsize}")


def _supported(op, dname):
    return pr.device_fold(op, jnp.dtype(DTYPES[dname][0])) is not None


#: (op, dtype) pairs both packages' kernels take
CASES = [(op, d) for op in OPS for d in DTYPES if _supported(op, d)]


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_dtype_gate_matches_reference(op, dname):
    """The port's device_fold answers None exactly where pallas_reduce's
    does, so the op framework falls through the same way."""
    np_dt, t_dt = DTYPES[dname]
    assert (reduce.device_fold(op, t_dt) is None) == (not _supported(op, dname))


@pytest.mark.parametrize("op,dname", CASES)
def test_combine2_matches_reference(op, dname):
    np_dt, _ = DTYPES[dname]
    a = _operands(np_dt, (5, 41), seed=1)
    b = _operands(np_dt, (5, 41), seed=2)
    want = np.asarray(pr.combine2(op, jnp.asarray(a), jnp.asarray(b)))
    got = cudaenv.to_numpy(reduce.combine2(
        op, cudaenv.make_world_array(a, "cpu"),
        cudaenv.make_world_array(b, "cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("op,dname", CASES)
def test_reduce_stack_matches_reference(op, dname):
    """k = 8, the world size, folded left to right in both packages."""
    np_dt, _ = DTYPES[dname]
    x = _operands(np_dt, (8, 3, 45), seed=3)
    want = np.asarray(pr.reduce_stack(op, jnp.asarray(x)))
    got = cudaenv.to_numpy(reduce.reduce_stack(
        op, cudaenv.make_world_array(x, "cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("op,dname", [("SUM", "float32"), ("PROD", "float32"),
                                      ("MAX", "float32"), ("BXOR", "int32"),
                                      ("LOR", "int8")])
def test_reduce_local_matches_reference(op, dname):
    """MPI_Reduce_local, inoutbuf = inbuf (op) inoutbuf: the JAX package's
    host kernel against the port's op-framework fold."""
    from ompi_tpu import datatype
    from ompi_tpu.api import op as jop

    import ompi_tpu_torch

    np_dt, _ = DTYPES[dname]
    a = _operands(np_dt, (6, 11), seed=8)
    b = _operands(np_dt, (6, 11), seed=9)
    want = b.copy()
    datatype.reduce_local(a, want, getattr(jop, op))
    inout = cudaenv.make_world_array(b, "cpu")
    got = ompi_tpu_torch.reduce_local(cudaenv.make_world_array(a, "cpu"),
                                      inout, getattr(ompi_tpu_torch, op))
    assert got is inout
    np.testing.assert_array_equal(_bits(cudaenv.to_numpy(got)), _bits(want))


def test_unsigned_wide_ints_fall_through():
    """torch's uint16/32/64 have little CUDA support: the kernels do not take
    them (the JAX package's do), so the component answers None and the
    builtin fold serves them."""
    from ompi_tpu_torch.mca.op import cuda_vpu

    for dt in (torch.uint16, torch.uint32, torch.uint64):
        assert reduce.device_fold("SUM", dt) is None
        assert cuda_vpu.COMPONENT.query_stack("BAND", dt) is None


@pytest.fixture
def cpu_world():
    import ompi_tpu_torch
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    yield ompi_tpu_torch.init(device="cpu")
    rt.reset_for_testing()


def test_op_selection_on_cpu_lane(cpu_world):
    """CPU world: op/cuda_vpu drops to priority 5 below op/builtin's 10, so
    builtin serves the folds; the stack reduction still comes from
    cuda_vpu (builtin has none), as pallas_vpu's does off-TPU."""
    from ompi_tpu_torch.api import op as op_mod
    from ompi_tpu_torch.mca.op import base as op_base, builtin_op, cuda_vpu

    fold = op_base.select_fold("SUM", torch.float32)
    assert fold is builtin_op._TABLE["SUM"]
    assert cuda_vpu.COMPONENT.priority == 5
    stack = op_mod.torch_stack_reduce(op_mod.PROD, torch.float32)
    assert stack.func is reduce.reduce_stack and stack.args == ("PROD",)
    # "not mine" answers None, so selection falls through
    assert cuda_vpu.COMPONENT.query_fold("BAND", torch.float32) is None
    assert cuda_vpu.COMPONENT.query_stack("LAND", torch.bool) is None
    assert cuda_vpu.COMPONENT.query_fold("MAXLOC", torch.float32) is None
    assert builtin_op.COMPONENT.query_fold("MAXLOC", torch.float32) is None
    assert op_mod.torch_stack_reduce(op_mod.MAXLOC, torch.float32) is None
    # LAND on bool: no kernel; the builtin torch fold serves it
    land = op_mod.torch_fold(op_mod.LAND, torch.bool)
    a = torch.tensor([True, False, True])
    b = torch.tensor([True, True, False])
    assert land(a, b).tolist() == [True, False, False]
    with pytest.raises(Exception, match="no device lowering"):
        op_mod.torch_fold(op_mod.MAXLOC, torch.float32)


def test_wrapper_argument_checks():
    """K1/K2 wrappers raise on what the kernels do not take; the checks are
    shared by the CPU path and the card path."""
    before = dict(reduce.launches)
    f = torch.ones(4)
    with pytest.raises(TypeError):
        reduce.combine2("BAND", f, f)                      # float bitwise
    with pytest.raises(TypeError):
        reduce.combine2("SUM", f, f.double())              # mixed dtypes
    with pytest.raises(ValueError):
        reduce.combine2("SUM", f, torch.ones(5))           # shapes differ
    with pytest.raises(ValueError):
        reduce.combine2("NOPE", f, f)                      # unknown op
    with pytest.raises(TypeError):
        reduce.reduce_stack("SUM", torch.ones(8, 3, dtype=torch.uint32))
    with pytest.raises(ValueError):
        reduce.reduce_stack("SUM", torch.ones(3, 8).t())   # not contiguous
    with pytest.raises(TypeError):
        reduce.reduce_stack("SUM", np.ones((8, 3), np.float32))
    assert reduce.launches == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1 and K2 against their plain versions on the card (run on a machine
    with a card; skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for op, dname in CASES:
        np_dt = DTYPES[dname][0]
        a = cudaenv.make_world_array(_operands(np_dt, (3, 1001), 4), "cpu")
        b = cudaenv.make_world_array(_operands(np_dt, (3, 1001), 5), "cpu")
        got = reduce.combine2(op, a.cuda(), b.cuda()).cpu()
        assert torch.equal(got, reduce.combine2_plain(op, a, b)), (op, dname)
        got = reduce.reduce_stack(op, a.cuda()).cpu()
        assert torch.equal(got, reduce.reduce_stack_plain(op, a)), (op, dname)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 8, 9])
def test_stack_edges_on_card(k):
    """K1 bit for bit against its plain version at every op and dtype of
    CASES, at per = 1, 15, 16, 17, one block +- 1 and one more than the
    persistent grid covers in one sweep (grid x block + 1), so that a
    program takes a second block (skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # more blocks than the SMs hold programs (2048 threads an SM at most), so
    # the probe's grid is the persistent one
    most = reduce._sm_count(torch.cuda.current_device()) * (
        2048 // (32 * reduce.STACK_WARPS))
    for op, dname in CASES:
        np_dt, t_dt = DTYPES[dname]
        block = reduce.stack_block(k, torch.empty(0, dtype=t_dt).element_size())
        probe = torch.zeros((k, most * block + 1), dtype=t_dt, device="cuda")
        _, grid = reduce._launch_stack(op, probe, torch.empty_like(probe[0]))
        del probe
        for per in (1, 15, 16, 17, block - 1, block + 1, grid * block + 1):
            x = cudaenv.make_world_array(_operands(np_dt, (k, per), per), "cpu")
            got = reduce.reduce_stack(op, x.cuda()).cpu()
            assert torch.equal(got, reduce.reduce_stack_plain(op, x)), \
                (op, dname, k, per)
        out = torch.empty(per, dtype=t_dt, device="cuda")
        assert reduce._launch_stack(op, x.cuda(), out)[1] == grid, \
            (op, dname, k)
