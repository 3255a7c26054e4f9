"""The port's device world end to end on the CPU lane:
``ompi_tpu_torch.init(device="cpu")`` then ``COMM_WORLD.allreduce_array``,
held against ``ompi_tpu.init()`` on the 8-virtual-CPU mesh with the same
host stacks, at default priorities (coll/builtin vs coll/xla) and with the
ring raised (coll/ring vs coll/pallas).  Plus the package boundary: no
import of jax or ompi_tpu under ompi_tpu_torch/, components discovered from
ompi_tpu_torch.mca, and no silent CPU fallback.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu_torch.base import cudaenv

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_world():
    from ompi_tpu.runtime import init as rt

    rt.reset_for_testing()
    w = ompi_tpu.init()
    if w.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield w
    rt.reset_for_testing()


@pytest.fixture
def torch_world():
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    yield ompi_tpu_torch.init(device="cpu")
    rt.reset_for_testing()


def _set_vars(registry, framework_open, values: dict):
    """Set registered vars by value, as the pallas_world fixture of
    tests/test_pallas_coll.py does; returns the undo."""
    framework_open()
    saved = {}
    for name, value in values.items():
        var = registry.lookup(name)
        assert var is not None, f"{name} was not registered"
        saved[name] = var._value
        var._value = value
    return lambda: [setattr(registry.lookup(k), "_value", v)
                    for k, v in saved.items()]


@pytest.fixture
def ring_worlds(request):
    """Both packages' worlds with the ring component raised above the
    builtin one (coll_pallas_priority / coll_ring_priority 95), plus any
    extra var values given by indirect parametrization."""
    from ompi_tpu.base.var import registry as jreg
    from ompi_tpu.mca.coll.base import coll_framework as jfw
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.base.var import registry as treg
    from ompi_tpu_torch.mca.coll.base import coll_framework as tfw
    from ompi_tpu_torch.runtime import init as trt

    extra = getattr(request, "param", {})
    undo_j = _set_vars(jreg, lambda: jfw().select_all(), {
        "otpu_coll_pallas_priority": 95,
        **{k.replace("coll_ring", "coll_pallas"): v for k, v in extra.items()}})
    undo_t = _set_vars(treg, lambda: tfw().select_all(), {
        "otpu_coll_ring_priority": 95, **extra})
    jrt.reset_for_testing()
    trt.reset_for_testing()
    try:
        jw = ompi_tpu.init()
        if jw.size != 8:
            pytest.skip("needs 8 virtual devices")
        yield jw, ompi_tpu_torch.init(device="cpu")
    finally:
        jrt.reset_for_testing()
        trt.reset_for_testing()
        undo_j()
        undo_t()


def _owner(comm):
    return type(comm.c_coll["allreduce_array"].__self__).__name__


def _host_stack(kind: str, shape=(8, 37), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "float32":
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    if kind == "int32":
        return rng.integers(-3, 4, shape).astype(np.int32)
    import ml_dtypes

    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


# -- boot and selection -------------------------------------------------

def test_cpu_world_has_eight_virtual_ranks(torch_world):
    w = torch_world
    assert w.size == 8 and w.rank == 0
    assert w.rte.is_device_world and w.rte.device == torch.device("cpu")
    assert ompi_tpu_torch.COMM_WORLD is w
    # the default selection: coll/builtin (90) owns the slot over coll/ring
    # (85); coll/conductor (40) fills the host slots
    assert _owner(w) == "BuiltinCollModule"
    assert [type(m).__name__ for m in w.coll_modules] == \
        ["ConductorModule", "RingCollModule", "BuiltinCollModule"]


def test_virtual_ranks_var_sizes_the_world():
    from ompi_tpu_torch.base import var
    from ompi_tpu_torch.runtime import init as rt

    v = var.registry.lookup("otpu_rte_virtual_ranks")
    old = v._value
    v._value = 4
    rt.reset_for_testing()
    try:
        w = ompi_tpu_torch.init(device="cpu")
        assert w.size == 4
        out = w.allreduce_array(np.arange(12, dtype=np.float32).reshape(4, 3))
        assert out.tolist() == [18.0, 22.0, 26.0]
    finally:
        rt.reset_for_testing()
        v._value = old


def test_init_without_card_raises():
    """No silent CPU fallback: with no card, init() needs device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ompi_tpu_torch.init()
    assert not rt.initialized()


def test_ring_owns_allreduce_when_raised(ring_worlds):
    jw, tw = ring_worlds
    assert type(jw.c_coll["allreduce_array"].__self__).__name__ == \
        "PallasCollModule"
    assert _owner(tw) == "RingCollModule"


def test_unfilled_slots_raise(torch_world):
    from ompi_tpu_torch.api.errors import ErrorClass, MpiError

    with pytest.raises(MpiError) as e:
        torch_world._coll("partitioned_coll")
    assert e.value.error_class is ErrorClass.ERR_UNSUPPORTED_OPERATION


def test_bad_buffers_raise(torch_world):
    from ompi_tpu_torch.api.errors import ErrorClass, MpiError

    for bad in (np.ones((4, 3), np.float32), torch.ones(3)):
        with pytest.raises(MpiError) as e:
            torch_world.allreduce_array(bad)
        assert e.value.error_class is ErrorClass.ERR_BUFFER


# -- the same allreduce through both packages ---------------------------

#: (op, host dtype, bit-exact?).  SUM is a psum in XLA and torch.sum here:
#: two reduction orders, so float SUM is held to one ulp of f32 per rank
#: (rtol 8 * 2**-24); every other row is exact.
CASES = [("SUM", "float32", False), ("MAX", "float32", True),
         ("MIN", "float32", True), ("PROD", "float32", True),
         ("BAND", "int32", True), ("LAND", "int32", True),
         ("SUM", "int32", True)]


@pytest.mark.parametrize("op,kind,exact", CASES)
def test_builtin_matches_xla(jax_world, torch_world, op, kind, exact):
    """Default priorities: coll/builtin against coll/xla.  PROD, BAND and
    LAND gather and fold the stack left to right in both (K1's plain
    version here, the Pallas reduce_stack in interpret mode there)."""
    from ompi_tpu.api import op as jop

    host = _host_stack(kind, seed=3)
    want = np.asarray(jax_world.allreduce_array(host, getattr(jop, op)))
    got = cudaenv.to_numpy(
        torch_world.allreduce_array(host, getattr(ompi_tpu_torch, op)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, rtol=8 * 2.0 ** -24, atol=0)


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD"])
def test_ring_matches_pallas(ring_worlds, op, monkeypatch):
    """Raised priorities: float payloads take the ring in both packages
    (fused kernel; plain version here, interpret mode there): bit-exact."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    seen = []
    real = rc.all_reduce
    monkeypatch.setattr(rc, "all_reduce",
                        lambda *a, **k: seen.append(k["variant"]) or real(*a, **k))
    host = _host_stack("float32", shape=(8, 5, 7), seed=4)
    want = np.asarray(jw.allreduce_array(host, getattr(jop, op)))
    got = cudaenv.to_numpy(tw.allreduce_array(host, getattr(ompi_tpu_torch, op)))
    assert seen == ["fused"]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["int32", "bfloat16"])
def test_non_ring_dtypes_fall_through(ring_worlds, kind, monkeypatch):
    """int32 and bfloat16 are not ring payloads in the reference (numpy kind
    is not 'f'): the raised ring delegates them to coll/builtin.  bfloat16
    SUM is summed in another order by XLA and torch: one bf16 ulp per rank
    (rtol 8 * 2**-8)."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    monkeypatch.setattr(rc, "all_reduce",
                        lambda *a, **k: pytest.fail("ring took " + kind))
    host = _host_stack(kind, seed=5)
    want = np.asarray(jw.allreduce_array(host, jop.SUM))
    got = cudaenv.to_numpy(tw.allreduce_array(host, ompi_tpu_torch.SUM))
    assert got.dtype == want.dtype
    if kind == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   rtol=8 * 2.0 ** -8, atol=2.0 ** -8)


@pytest.mark.parametrize(
    "ring_worlds", [{"otpu_coll_ring_vmem_max_bytes": 1024}], indirect=True)
def test_small_vmem_max_routes_to_seg(ring_worlds, monkeypatch):
    """A per-rank payload above vmem_max_bytes takes the segmented kernel,
    with a window of seg_bytes (512k / 4 bytes), in both packages."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    seen = []
    real = rc.all_reduce
    monkeypatch.setattr(
        rc, "all_reduce",
        lambda *a, **k: seen.append((k["variant"], k["seg_elems"])) or real(*a, **k))
    host = _host_stack("float32", shape=(8, 1000), seed=6)
    want = np.asarray(jw.allreduce_array(host, jop.SUM))
    got = cudaenv.to_numpy(tw.allreduce_array(host, ompi_tpu_torch.SUM))
    assert seen == [("seg", 131072)]
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- the package boundary -----------------------------------------------

def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_ompi_tpu():
    files = sorted((ROOT / "ompi_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ompi_tpu"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_components_come_from_the_port(torch_world):
    from ompi_tpu_torch.base import mca
    from ompi_tpu_torch.mca.coll.base import coll_framework
    from ompi_tpu_torch.mca.op import base as op_base

    assert mca.MCA_PACKAGE == "ompi_tpu_torch.mca"
    coll = coll_framework()
    assert sorted(coll.components) == [
        "adapt", "basic", "builtin", "conductor", "demo", "han", "libnbc",
        "quant", "ring", "self_coll", "sm_coll", "sync", "tuned"]
    op_fw = op_base._framework()
    assert sorted(op_fw.components) == ["builtin", "cuda_vpu"]
    pml_fw, btl_fw = mca.framework("pml"), mca.framework("btl")
    assert sorted(pml_fw.components) == ["ob1"]
    assert sorted(btl_fw.components) == ["self", "sm", "tcp"]
    assert [type(b).__name__ for b in torch_world.pml.bml.btls] == ["SelfBtl"]
    for comp in [*coll.components.values(), *op_fw.components.values(),
                 *pml_fw.components.values(), *btl_fw.components.values()]:
        assert type(comp).__module__.startswith("ompi_tpu_torch.mca."), comp
