"""The port's compressed collectives end to end on the CPU lane, held against
``ompi_tpu.init()`` on the 8-virtual-CPU mesh with the same host stacks:

* a communicator ``dup`` with the ``otpu_quant_budget`` info key set runs
  coll/builtin's quantized ``allreduce_array`` and ``allgather_array``
  (coll/xla's in the reference, ``tests/test_quant.py:321-348``): int8
  bit-exact, bf16 within the reduction-order band;
* every gate that keeps a call exact: no budget, a budget below both
  codecs, a world tensor under ``min_bytes``, MAX, a non-commutative op, a
  malformed budget;
* ``set_info``/``get_info``/``dup``/``dup_with_info``;
* coll/ring raised with ``wire16`` (coll/pallas with ``wire16`` in the
  reference) and on a budgeted comm, where it stays exact as coll/pallas
  does.
"""
import numpy as np
import pytest
import torch

import ompi_tpu_torch
from ompi_tpu_torch.api import op as top
from ompi_tpu_torch.api.info import Info
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.mca.coll import quant as tquant
from ompi_tpu_torch.ops import quant as qo
from test_torch_world import _bits, jax_world, ring_worlds, torch_world  # noqa: F401

N = 8
KEY = "otpu_quant_budget"


def _host(elems, seed):
    return np.stack([np.random.default_rng([seed, r]).standard_normal(elems)
                     for r in range(N)]).astype(np.float32)


def _module(comm, cls_name):
    return next(m for m in comm.coll_modules if type(m).__name__ == cls_name)


def _budgeted(world, budget):
    c = world.dup()
    c.info.set(KEY, budget)
    return c


def _jax_call(jw, budget, slot, host, *args):
    """``slot`` on a dup of the JAX world with ``budget`` (None: no key)."""
    c = jw.dup()
    if budget is not None:
        c.info.set(KEY, budget)
    dev = _module(c, "XlaCollModule").make_world_array(host)
    return np.asarray(getattr(c, slot)(dev, *args))


def _np(t):
    return cudaenv.to_numpy(t)


def _jop(name):
    from ompi_tpu.api import op as jop

    return getattr(jop, name)


# -- the quantized paths -------------------------------------------------------

def test_int8_allreduce_and_allgather_match_xla(jax_world, torch_world):
    host = _host(65536, seed=31)
    c = _budgeted(torch_world, "0.01")
    before = dict(qo.launches)
    got = _np(c.allreduce_array(host))
    want = _jax_call(jax_world, "0.01", "allreduce_array", host)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    exact = host.astype(np.float64).sum(0)
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert 1e-7 < rel <= tquant.CODEC_BANDS["int8"] * 1.2, rel
    ag = _np(c.allgather_array(host))
    np.testing.assert_array_equal(
        _bits(ag), _bits(_jax_call(jax_world, "0.01", "allgather_array", host)))
    assert ag.shape == host.shape
    assert 1e-7 < np.abs(ag - host).max() / np.abs(host).max() <= 0.5 / 127 * 1.5
    assert qo.launches == before, "the CPU lane launched a kernel"


def test_int8_paths_go_through_the_codec(torch_world, monkeypatch):
    """allreduce = encode + dequant-accumulate, allgather = encode + decode,
    each on the world tensor (rows of one tensor: the gathered payload)."""
    seen = []
    for name in ("encode_int8", "dequant_accumulate", "decode_int8"):
        real = getattr(qo, name)
        monkeypatch.setattr(qo, name, lambda *a, _n=name, _r=real:
                            seen.append((_n, tuple(a[0].shape))) or _r(*a))
    c = _budgeted(torch_world, "0.01")
    x = torch.from_numpy(_host(3000, seed=2))
    c.allreduce_array(x)
    c.allgather_array(x)
    rows = -(-3000 // 128)
    assert seen == [("encode_int8", (N, 3000)),
                    ("dequant_accumulate", (N, rows, 128)),
                    ("encode_int8", (N, 3000)),
                    ("decode_int8", (N, rows, 128))]


def test_bf16_codec_within_the_order_band(jax_world, torch_world):
    """A budget of 0.005 selects bf16: both packages round each rank's row
    to bf16 (bit-exact allgather) and sum the rows in float32, XLA's reduce
    and ``torch.sum`` in different orders: each order is within
    (n-1)·2^-24·Σ|x_i| of the exact sum of the rounded rows, so the two
    differ by at most twice that."""
    host = _host(65536, seed=5)
    c = _budgeted(torch_world, "0.005")
    got = _np(c.allreduce_array(host))
    want = _jax_call(jax_world, "0.005", "allreduce_array", host)
    band = 2 * (N - 1) * 2.0 ** -24 * np.abs(host).sum(0)
    assert np.all(np.abs(got - want) <= band)
    exact = host.astype(np.float64).sum(0)
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert 1e-7 < rel <= tquant.CODEC_BANDS["bf16"] * 2, rel
    ag = _np(c.allgather_array(host))
    np.testing.assert_array_equal(
        _bits(ag), _bits(_jax_call(jax_world, "0.005", "allgather_array", host)))


# -- the gates that keep a call exact ----------------------------------------

@pytest.mark.parametrize("budget,elems", [
    (None, 65536),          # no budget on the dup
    ("0.001", 65536),       # below both codec bands
    ("0.01", 2047),         # 8 x 2047 x 4 bytes: under 64 KiB in total
])
def test_exact_without_an_eligible_budget(torch_world, budget, elems):
    host = _host(elems, seed=7)
    c = torch_world.dup()
    if budget is not None:
        c.info.set(KEY, budget)
    exact = _np(torch_world.allreduce_array(host))
    np.testing.assert_array_equal(_bits(_np(c.allreduce_array(host))),
                                  _bits(exact))
    np.testing.assert_array_equal(_np(c.allgather_array(host)), host)


def test_min_bytes_counts_the_whole_world_tensor(jax_world, torch_world):
    """8 x 2048 float32 is 64 KiB in total (8 KiB a rank): quantized in
    both packages."""
    host = _host(2048, seed=8)
    c = _budgeted(torch_world, "0.01")
    got = _np(c.allreduce_array(host))
    assert not np.array_equal(got, _np(torch_world.allreduce_array(host)))
    np.testing.assert_array_equal(
        _bits(got), _bits(_jax_call(jax_world, "0.01", "allreduce_array", host)))


def test_max_and_non_commutative_stay_exact(torch_world):
    host = _host(65536, seed=9)
    c = _budgeted(torch_world, "0.01")
    np.testing.assert_array_equal(_np(c.allreduce_array(host, top.MAX)),
                                  host.max(0))
    ordered_sum = top.Op("ORDERED_SUM", commute=False, torch_reduce="sum")
    np.testing.assert_array_equal(
        _bits(_np(c.allreduce_array(host, ordered_sum))),
        _bits(_np(torch_world.allreduce_array(host))))


def test_malformed_budget_shows_help_and_stays_exact(torch_world, capsys,
                                                     monkeypatch):
    from ompi_tpu_torch.base import output

    monkeypatch.setattr(output, "_help_seen", {})
    host = _host(65536, seed=10)
    c = _budgeted(torch_world, "not-a-float")
    np.testing.assert_array_equal(
        _bits(_np(c.allreduce_array(host))),
        _bits(_np(torch_world.allreduce_array(host))))
    assert "does not parse" in capsys.readouterr().err


def test_quantized_program_is_cached(torch_world):
    host = torch.from_numpy(_host(65536, seed=11))
    c = _budgeted(torch_world, "0.01")
    first = c.allreduce_array(host)
    assert torch.equal(first, c.allreduce_array(host))
    builtin = _module(c, "BuiltinCollModule")
    assert ("allreduce_quant", "int8", "SUM", host.shape, host.dtype,
            host.device) in builtin._cache


def test_budget_key_var_renames_the_key(torch_world):
    from ompi_tpu_torch.base.var import registry

    var = registry.lookup("otpu_coll_quant_budget_key")
    assert var is not None and var.value == KEY
    host = _host(65536, seed=12)
    c = torch_world.dup()
    c.info.set("my_budget", "0.01")
    try:
        var.set("my_budget")
        assert tquant.BUDGET_KEY == "my_budget"
        assert not np.array_equal(_np(c.allreduce_array(host)),
                                  _np(torch_world.allreduce_array(host)))
    finally:
        var.set(KEY)
    assert tquant.BUDGET_KEY == KEY


# -- info and dup ------------------------------------------------------------

def test_info_semantics_match_the_reference(jax_world, torch_world):
    from ompi_tpu.api.info import Info as JInfo

    for w, make in ((jax_world, JInfo), (torch_world, Info)):
        w.info.set("hint", "a")
        d = w.dup()
        assert d.cid != w.cid and d.group is w.group and d.size == w.size
        assert d.info.get("hint") == "a"
        d.info.set("hint", "b")                 # a copy, not a share
        assert w.info.get("hint") == "a"
        got = d.get_info()
        got.set("hint", "c")                    # get_info returns a copy
        assert d.info.get("hint") == "b"
        info = make({"x": "1"})
        d.set_info(info)
        info.set("x", "2")                      # set_info copies too
        assert d.info.get("x") == "1" and "hint" not in d.info
        dd = d.dup_with_info(make({KEY: "0.01"}))
        assert dd.info.get(KEY) == "0.01" and "x" not in dd.info
        assert len({w.cid, d.cid, dd.cid}) == 3
        assert dd.c_coll and dd.coll_modules is not w.coll_modules
        w.info.delete("hint")


def test_finalize_releases_every_comm(torch_world):
    from ompi_tpu_torch.runtime import init as rt

    d = torch_world.dup()
    dd = d.dup()
    # cid 0 is COMM_WORLD, cid 1 COMM_SELF
    assert (d.cid, dd.cid) == (2, 3) and d.c_coll and dd.c_coll
    me = rt.comm_self()
    rt.finalize()
    for c in (torch_world, me, d, dd):
        assert c.c_coll == {} and c.coll_modules == []
    w = ompi_tpu_torch.init(device="cpu")
    assert w.dup().cid == 2                     # the counter starts afresh


# -- coll/ring: wire16 and the budget ------------------------------------------

WIRE16 = {"otpu_coll_ring_wire16": True}


def _spy(monkeypatch, name):
    from ompi_tpu_torch.ops import ring_collectives as rc

    seen, real = [], getattr(rc, name)
    monkeypatch.setattr(rc, name,
                        lambda *a, **k: seen.append(k["variant"]) or real(*a, **k))
    return seen


@pytest.mark.parametrize("ring_worlds", [WIRE16], indirect=True)
def test_wire16_allreduce_matches_pallas(ring_worlds, monkeypatch):
    """A fused-size float32 SUM takes K7's slot and equals coll/pallas with
    wire16 bit for bit (and is not the exact sum); MAX stays exact."""
    jw, tw = ring_worlds
    assert _module(tw, "RingCollModule").wire16
    assert _module(jw, "PallasCollModule").wire16
    seen = _spy(monkeypatch, "all_reduce")
    host = _host(1024, seed=13)
    got = _np(tw.allreduce_array(host))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(np.asarray(jw.allreduce_array(host))))
    assert not np.allclose(got, host.sum(0), rtol=1e-6)
    mx = _np(tw.allreduce_array(host, top.MAX))
    np.testing.assert_array_equal(mx, np.asarray(
        jw.allreduce_array(host, _jop("MAX"))))
    np.testing.assert_array_equal(mx, host.max(0))
    assert seen == ["wire16", "fused"]


@pytest.mark.parametrize("ring_worlds", [WIRE16], indirect=True)
def test_wire16_reduce_scatter_matches_pallas(ring_worlds, monkeypatch):
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "reduce_scatter")
    host = _host(8 * 1000, seed=14).reshape(N, N, 1000)
    got = _np(tw.reduce_scatter_array(host, top.SUM))
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(
        jw.reduce_scatter_array(host, _jop("SUM")))))
    assert seen == ["wire16"]


@pytest.mark.parametrize("ring_worlds", [
    {**WIRE16, "otpu_coll_ring_vmem_max_bytes": 1024}], indirect=True)
def test_wire16_leaves_the_seg_regime_exact(ring_worlds, monkeypatch):
    """Above vmem_max_bytes per rank the segmented kernels serve, with no
    wire16 form, as in the reference."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_reduce")
    host = _host(1024, seed=15)
    got = _np(tw.allreduce_array(host))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(np.asarray(jw.allreduce_array(host))))
    assert seen == ["seg"]


@pytest.mark.parametrize("ring_worlds", [WIRE16], indirect=True)
def test_wire16_routes_the_headline_size_to_seg(ring_worlds):
    """16 MiB a rank is past the 8 MiB crossover: no wire16 (the routing
    rule alone, on an expanded tensor that holds no 128 MiB)."""
    _, tw = ring_worlds
    ring = _module(tw, "RingCollModule")
    big = torch.zeros(1, 1).expand(N, (16 << 20) // 4)
    mid = torch.zeros(1, 1).expand(N, (4 << 20) // 4)
    # the allreduce's rule and the reduce-scatter's agree without bidi
    for rule in (ring._allreduce_variant, ring._reduce_scatter_variant):
        assert rule(big, "sum")[0] == "seg"
        assert rule(mid, "sum")[0] == "wire16"
        assert rule(mid, "max")[0] == "fused"
        assert rule(mid.double(), "sum")[0] == "fused"


def test_ring_serves_a_budgeted_comm_exactly(ring_worlds, monkeypatch):
    """coll/ring never reads the budget, as coll/pallas does not: a call it
    serves is the exact ring."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_reduce")
    host = _host(65536, seed=16)
    got = _np(_budgeted(tw, "0.01").allreduce_array(host))
    want = _jax_call(jw, "0.01", "allreduce_array", host)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_np(tw.allreduce_array(host))))
    assert seen == ["fused", "fused"]


@pytest.mark.parametrize("ring_worlds", [
    {"otpu_coll_ring_min_bytes": 1 << 20}], indirect=True)
def test_calls_the_ring_delegates_reach_the_codec(ring_worlds, monkeypatch):
    """Below coll/ring's min_bytes the call goes to coll/builtin, whose
    quantized branch serves it, as coll/pallas delegates to coll/xla."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_reduce")
    host = _host(65536, seed=17)                # 256 KiB a rank
    got = _np(_budgeted(tw, "0.01").allreduce_array(host))
    want = _jax_call(jw, "0.01", "allreduce_array", host)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.array_equal(got, _np(tw.allreduce_array(host)))
    assert seen == []
