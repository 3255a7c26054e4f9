"""The port's MPI_T tool interface (``ompi_tpu_torch/api/tool.py``) held
against the JAX package's ``ompi_tpu.api.tool`` on the CPU.

The two registries differ in size and order (each package registers the
variables of the components it has), so every comparison is by variable
name and semantics, never by index:

* init and finalize refcounting, and the not-initialized error;
* cvars: the same named variable enumerated, read (the same default),
  written through MPI_T (the same value read back, ``source_detail``
  "MPI_T") and refused the same way for a read-only one;
* pvars: sessions with per-handle start, stop, read and reset over one
  scripted value sequence for each pvar class (the delta classes against
  their start value, the absolute classes live), and over the port's
  ``otpu_runtime_spc_device_collectives`` a session's delta equal to the
  number of ``allreduce_array`` calls on tensors;
* categories: frameworks, with the same description and every cvar of
  the category in it;
* bad indices and names: the same error class.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu_torch
from ompi_tpu.api import tool as jtool
from ompi_tpu.api.errors import MpiError as JMpiError
from ompi_tpu.base import var as jvar
from ompi_tpu_torch.api import tool as ttool
from ompi_tpu_torch.api.errors import MpiError as TMpiError
from ompi_tpu_torch.base import var as tvar

PKGS = {"jax": (jtool, JMpiError, jvar), "torch": (ttool, TMpiError, tvar)}


@pytest.fixture(scope="module", autouse=True)
def worlds():
    """Both packages initialised: MPI init populates the registries
    (frameworks register their vars at open)."""
    import ompi_tpu
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    tw = ompi_tpu_torch.init(device="cpu")
    yield jw, tw
    jrt.reset_for_testing()
    trt.reset_for_testing()


@pytest.fixture(autouse=True)
def t_init():
    for tool, _, _ in PKGS.values():
        tool.init_thread()
    yield
    for tool, _, _ in PKGS.values():
        tool.finalize()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_requires_init(pkg):
    tool, err, _ = PKGS[pkg]
    tool.finalize()           # undo the fixture's init
    with pytest.raises(err) as ei:
        tool.cvar_get_num()
    assert ei.value.error_class.name == "ERR_OTHER"
    tool.init_thread()        # refcounted: two inits need two finalizes
    tool.init_thread()
    tool.finalize()
    assert tool.cvar_get_num() > 0
    with pytest.raises(err):
        tool.finalize()
        tool.finalize()
        tool.finalize()
    tool.init_thread()        # restore for the fixture's finalize


_CVAR = "otpu_coll_tuned_allreduce_algorithm"


def _cvar_case(pkg) -> tuple:
    tool, err, _ = PKGS[pkg]
    i = tool.cvar_get_index(_CVAR)
    var = tool.cvar_get_info(i)
    assert var.name == _CVAR
    old = tool.cvar_read(i)
    tool.cvar_write(i, "ring")
    after = (tool.cvar_read(i), var.source_detail, var.source.name)
    tool.cvar_write(i, old or "")
    return (old, var.default, var.vtype.name, var.help, after)


def test_cvar_enumerate_read_write_matches_reference():
    """The named cvar has the reference's default, type and help, and an
    MPI_T write is read back with the reference's source."""
    got = _cvar_case("torch")
    assert got == _cvar_case("jax")
    assert got[-1][:2] == ("ring", "MPI_T")


def test_cvar_names_enumerate_by_name():
    """Every name the port enumerates resolves to its own index, and the
    serving, fleet and shmem cvars both packages register carry the same
    default, type and help."""
    names = [ttool.cvar_get_info(i).name for i in range(ttool.cvar_get_num())]
    assert len(names) == len(set(names))
    for i, name in enumerate(names):
        assert ttool.cvar_get_index(name) == i
    import ompi_tpu.serving  # noqa: F401  (registers the fleet's vars)
    import ompi_tpu.shmem  # noqa: F401
    import ompi_tpu_torch.serving  # noqa: F401
    import ompi_tpu_torch.shmem  # noqa: F401

    for name in ("otpu_serving_scale_cooldown", "otpu_serving_scale_patience",
                 "otpu_serving_slo_p99_ms", "otpu_serving_idle_patience",
                 "otpu_serving_poll_ticks", "otpu_shmem_heap_size"):
        tv = ttool.cvar_get_info(ttool.cvar_get_index(name))
        jv = jtool.cvar_get_info(jtool.cvar_get_index(name))
        assert (tv.default, tv.vtype.name, tv.help, tv.value) == \
            (jv.default, jv.vtype.name, jv.help, jv.value), name


def _script(pkg, pclass: str) -> list:
    """A handle's reads over one scripted sequence of pvar values."""
    tool, _, var = PKGS[pkg]
    value = [10.0]
    pv = SimpleNamespace(read=lambda: value[0],
                         pclass=var.PvarClass[pclass])
    h = tool.PvarHandle(pv, 1)
    out = [h.read()]
    for step, v in enumerate((12.0, 15.0, 15.5, 30.0, 31.0, 40.0)):
        value[0] = v
        action = ("start", "read", "stop", "read", "reset", "start")[step]
        getattr(h, action)()
        out.append((action, h.read(), h.started))
    return out


@pytest.mark.parametrize("pclass", ["COUNTER", "TIMER", "LEVEL", "SIZE",
                                    "HIGHWATERMARK"])
def test_pvar_handle_semantics_match_reference(pclass):
    """Start, read, stop (the frozen value), reset and restart: the delta
    classes report against their start, the absolute ones live before any
    start, in both packages."""
    assert _script("torch", pclass) == _script("jax", pclass)


def test_pvar_session_delta_semantics(worlds):
    """Two sessions on the device-collective counter: each handle sees
    only its own delta, which equals the number of ``allreduce_array``
    calls on tensors made since its start."""
    _, w = worlds
    i = ttool.pvar_get_index("otpu_runtime_spc_device_collectives")
    s1 = ttool.pvar_session_create()
    s2 = ttool.pvar_session_create()
    h1 = s1.handle_alloc(i)
    h1.start()
    x = torch.ones((w.size, 8))
    w.allreduce_array(x)
    h2 = s2.handle_alloc(i)
    h2.start()
    for _ in range(4):
        w.allreduce_array(x)
    assert (h1.read(), h2.read()) == (5, 4)
    h2.stop()
    w.allreduce_array(x)
    assert (h1.read(), h2.read()) == (6, 4)
    s1.handle_free(h1)
    ttool.pvar_session_free(s2)
    assert ttool.pvar_get_info(i).name == jtool.pvar_get_info(
        jtool.pvar_get_index("otpu_runtime_spc_device_collectives")).name


def test_categories_are_frameworks():
    """Categories are the frameworks: ``coll`` is one in both packages, with
    the reference's description, and every cvar listed in a category
    belongs to its framework."""
    names = [ttool.category_get_info(i)[0]
             for i in range(ttool.category_get_num())]
    assert "coll" in names and names == sorted(names)
    cname, desc, cvars = ttool.category_get_info(names.index("coll"))
    jnames = [jtool.category_get_info(i)[0]
              for i in range(jtool.category_get_num())]
    jdesc = jtool.category_get_info(jnames.index("coll"))[1]
    assert (cname, desc) == ("coll", jdesc)
    assert cvars and all(
        ttool.cvar_get_info(ttool.cvar_get_index(v)).group.split("/")[0]
        == "coll" for v in cvars)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_bad_indices_raise(pkg):
    tool, err, _ = PKGS[pkg]
    got = []
    for fn in (lambda: tool.cvar_get_info(10 ** 9),
               lambda: tool.pvar_get_info(-5),
               lambda: tool.cvar_get_index("no_such_var_xyz"),
               lambda: tool.pvar_get_index("no_such_pvar_xyz"),
               lambda: tool.category_get_info(10 ** 6)):
        with pytest.raises(err) as ei:
            fn()
        got.append(ei.value.error_class.name)
    assert got == ["ERR_ARG"] * 5
    assert np.all([isinstance(tool.cvar_get_num(), int)])
