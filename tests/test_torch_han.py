"""coll/han's device half on the CPU lane, held against the JAX package's
``XlaHierarchicalColl`` on its 8-device CPU mesh as ('dcn', 'ici') = (2, 4):
``allreduce`` over both of the reference's branches (rows whose first
axis the low level divides: reduce-scatter, up-level sum, gather; any other
shape: two levels of whole-row sums; the port sums whole rows for both)
and ``reduce_scatter``.  The sums run in another
order than XLA's, so floats hold within a stated band; integer-valued data
is exact.  Also: the world's device is the card unless the caller asks for
the CPU, the layout checks, and ``Comm.free`` calling each coll module's
``comm_unquery`` (han's host half frees its sub-communicators there; its
jobs are in ``tests/test_torch_multiprocess.py``).
"""
import numpy as np
import pytest
import torch

from ompi_tpu_torch.mca.coll.han import HierarchicalColl

#: float32 band of a sum of 8 rows in another order: 8 roundings of the
#: largest partial sum
BAND = 8 * 2.0 ** -24


def _ref(n_up, n_low):
    import jax

    from ompi_tpu.mca.coll.han import XlaHierarchicalColl

    devs = jax.devices()[:8]
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return XlaHierarchicalColl(devs, n_up=n_up, n_low=n_low)


def _close(got, want, scale):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BAND * scale


@pytest.mark.parametrize("n_up,n_low", [(2, 4), (4, 2)])
@pytest.mark.parametrize("shape", [(16,), (8, 3), (4, 5), (7,), (3, 4), ()],
                         ids=lambda s: "x".join(map(str, s)) or "scalar")
def test_allreduce_matches_the_reference(n_up, n_low, shape):
    """(16,), (8, 3), (4, 5) take the reference's scatter/gather branch at
    n_low 4 or 2; (7,), (3, 4) and 1-element rows its whole-row branch.
    The port takes one path for all."""
    rng = np.random.default_rng(sum(shape) + n_low)
    x = rng.standard_normal((8, *shape)).astype(np.float32)
    h = HierarchicalColl(n_up, n_low, device="cpu")
    got = h.allreduce(x).numpy()
    want = np.asarray(_ref(n_up, n_low).allreduce(x))
    _close(got, want, np.abs(x).sum(0).max())
    ints = rng.integers(-50, 50, (8, *shape)).astype(np.float32)
    assert h.allreduce(ints).numpy().tobytes() == \
        np.asarray(_ref(n_up, n_low).allreduce(ints)).tobytes()


@pytest.mark.parametrize("n_up,n_low", [(2, 4), (4, 2)])
@pytest.mark.parametrize("tail", [(4,), (3, 2), ()],
                         ids=lambda s: "x".join(map(str, s)) or "scalar")
def test_reduce_scatter_matches_the_reference(n_up, n_low, tail):
    rng = np.random.default_rng(len(tail) + n_up)
    x = rng.standard_normal((8, 8, *tail)).astype(np.float32)
    h = HierarchicalColl(n_up, n_low, device="cpu")
    got = h.reduce_scatter(x).numpy()
    want = np.asarray(_ref(n_up, n_low).reduce_scatter(x))
    _close(got, want, np.abs(x).sum(0).max())
    ints = rng.integers(-50, 50, (8, 8, *tail)).astype(np.int32)
    assert h.reduce_scatter(ints).numpy().tobytes() == \
        np.asarray(_ref(n_up, n_low).reduce_scatter(ints)).tobytes()


def test_tensors_and_dtypes_are_kept():
    h = HierarchicalColl(2, 4, device="cpu")
    x = torch.arange(8 * 12, dtype=torch.int32).reshape(8, 12)
    out = h.allreduce(x)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    assert torch.equal(out, x.sum(0, dtype=torch.int32))
    w = h.make_world_array(np.ones((8, 3), np.float64))
    assert w.dtype == torch.float64 and tuple(w.shape) == (8, 3)


def test_the_layout_is_checked():
    h = HierarchicalColl(2, 4, device="cpu")
    for bad in (np.ones((6, 4), np.float32), torch.ones(7, 2)):
        with pytest.raises(ValueError, match="leading axis 8"):
            h.allreduce(bad)
    with pytest.raises(ValueError, match=r"\(8, 8, \.\.\.\)"):
        h.reduce_scatter(np.ones((8, 4), np.float32))


def test_the_card_unless_the_caller_asks_for_the_cpu():
    if torch.cuda.is_available():
        assert HierarchicalColl(2, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HierarchicalColl(2, 4)


@pytest.mark.cuda
def test_device_half_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h = HierarchicalColl(2, 4)
    x = torch.randn(8, 4096, device="cuda")
    plain = HierarchicalColl(2, 4, device="cpu").allreduce(x.cpu())
    assert (h.allreduce(x).cpu() - plain).abs().max() <= \
        BAND * x.abs().sum(0).max().item()


def test_free_calls_each_modules_comm_unquery():
    """``Comm.free`` (and finalize) run each coll module's
    ``comm_unquery`` before dropping it, as the reference's
    ``release_coll_modules`` does — coll/han frees its sub-communicators
    there; a module whose unquery raises does not stop the others."""
    import ompi_tpu_torch
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    try:
        w = ompi_tpu_torch.init(device="cpu")
        c = w.dup()
        seen = []

        class Module:
            def __init__(self, fail):
                self.fail = fail

            def comm_unquery(self, comm):
                seen.append((comm is c, self.fail))
                if self.fail:
                    raise RuntimeError("unquery failed")

        c.coll_modules += [Module(True), Module(False)]
        c.free()
        assert seen == [(True, True), (True, False)]
        assert c.coll_modules == [] and c.c_coll == {}
    finally:
        rt.reset_for_testing()
