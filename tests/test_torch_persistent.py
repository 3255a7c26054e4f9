"""The duplex routing and the persistent device collectives end to end on
the CPU lane, held against ``ompi_tpu.init()`` on the 8-virtual-CPU mesh with
the same host stacks: coll/ring's ``bidirectional`` var against
coll/pallas's, ``persistent_coll`` on coll/ring and coll/builtin against
coll/pallas and coll/xla, and ``Comm.allreduce_array_init``/``coll_init``.

Which kernel a call takes is shown by spying the variant keywords of the
port's ops; the values are compared bit for bit (the ring keeps the
reference's fold order), except where coll/builtin's torch sum meets XLA's
psum (a band, stated there).
"""
import numpy as np
import pytest
import torch

import ompi_tpu_torch
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import ring_collectives as rc
from test_torch_world import _bits, jax_world, ring_worlds, torch_world  # noqa: F401

BIDI = {"otpu_coll_ring_bidirectional": True}


def _stack(shape, seed):
    rng = np.random.default_rng(seed)
    # spread over decades, so that another fold order changes the bits
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)


def _spy(monkeypatch, name):
    """Record the keywords of each call to rc.<name>."""
    seen, real = [], getattr(rc, name)
    monkeypatch.setattr(rc, name, lambda *a, **k: seen.append(k) or real(*a, **k))
    return seen


def _jop(name):
    from ompi_tpu.api import op as jop

    return getattr(jop, name)


def _ring(comm, slot="allreduce_array"):
    return comm.c_coll[slot].__self__


def _np(x):
    return cudaenv.to_numpy(x)


def _module(comm, cls_name):
    return next(m for m in comm.coll_modules if type(m).__name__ == cls_name)


# -- the bidirectional var -------------------------------------------------------

@pytest.mark.parametrize("ring_worlds", [BIDI], indirect=True)
def test_bidirectional_var_reaches_both_rings(ring_worlds):
    jw, tw = ring_worlds
    assert _ring(jw).bidirectional is True and _ring(tw).bidirectional is True
    assert type(_ring(tw)).__name__ == "RingCollModule"


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD"])
@pytest.mark.parametrize("ring_worlds", [BIDI], indirect=True)
def test_bidi_allreduce_route_matches_pallas(ring_worlds, op, monkeypatch):
    """tests/test_pallas_coll.py:578-589: in the fused regime the duplex
    var routes the allreduce to bidi (K8 on the card) in both packages."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_reduce")
    host = (1.0 + 0.05 * _stack((8, 41), 14)) if op == "PROD" else \
        _stack((8, 41), 14)
    want = np.asarray(jw.allreduce_array(host, _jop(op)))
    got = _np(tw.allreduce_array(host, getattr(ompi_tpu_torch, op)))
    assert [k["variant"] for k in seen] == ["bidi"]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ring_worlds", [BIDI], indirect=True)
def test_seg_bidi_route_matches_pallas(ring_worlds, monkeypatch):
    """tests/test_pallas_coll.py:259-276: above vmem_max_bytes the duplex
    var routes to seg_bidi, window seg_bytes / 4, in both packages."""
    jw, tw = ring_worlds
    for mod in (_ring(jw), _ring(tw)):
        mod.vmem_max_bytes, mod.seg_bytes = 64, 128
    seen = _spy(monkeypatch, "all_reduce")
    host = _stack((8, 300), 22)
    assert _ring(jw)._route(host)[0] == "seg_bidi"
    assert _ring(tw)._route(torch.from_numpy(host)) == ("seg_bidi", 32)
    want = np.asarray(jw.allreduce_array(host))
    got = _np(tw.allreduce_array(host))
    assert [(k["variant"], k["seg_elems"]) for k in seen] == [("seg_bidi", 32)]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ring_worlds", [BIDI], indirect=True)
def test_bidi_reduce_scatter_keeps_the_one_way_ring(ring_worlds, monkeypatch):
    """No duplex reduce-scatter exists (pallas_coll.py:135-146): under the
    var it is the fused ring, and above vmem_max_bytes the segmented one."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "reduce_scatter")
    host = _stack((8, 8, 3, 5), 15)
    for vmem in (None, 64):
        if vmem is not None:
            for mod in (_ring(jw), _ring(tw)):
                mod.vmem_max_bytes, mod.seg_bytes = vmem, 128
        want = np.asarray(jw.reduce_scatter_array(host, _jop("SUM")))
        got = _np(tw.reduce_scatter_array(host, ompi_tpu_torch.SUM))
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert [(k["variant"], k["seg_elems"]) for k in seen] == \
        [("fused", None), ("seg", 32)]


@pytest.mark.parametrize("ring_worlds", [BIDI], indirect=True)
def test_bidi_allgather_route_matches_pallas(ring_worlds, monkeypatch):
    """tests/test_pallas_coll.py:96-110: the duplex var routes the
    allgather to bidi (K11 on the card)."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_gather")
    host = _stack((8, 12), 7)
    want = np.asarray(jw.allgather_array(host))
    got = _np(tw.allgather_array(host))
    assert [k["variant"] for k in seen] == ["bidi"]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize(
    "ring_worlds", [{**BIDI, "otpu_coll_ring_wire16": True}], indirect=True)
def test_wire16_takes_only_the_fused_regime(ring_worlds, monkeypatch):
    """Under both vars the allreduce is bidi (no duplex wire16 kernel) and
    the reduce-scatter, whose duplex regime is the fused ring, takes the
    bf16 wire (pallas_coll.py:128-132, :139-145)."""
    jw, tw = ring_worlds
    ar, rs = _spy(monkeypatch, "all_reduce"), _spy(monkeypatch, "reduce_scatter")
    host, rs_host = _stack((8, 1024), 11), _stack((8, 8, 128), 13)
    for j, t, x in ((jw.allreduce_array, tw.allreduce_array, host),
                    (jw.reduce_scatter_array, tw.reduce_scatter_array, rs_host)):
        np.testing.assert_array_equal(_bits(_np(t(x))), _bits(np.asarray(j(x))))
    assert [k["variant"] for k in ar] == ["bidi"]
    assert [k["variant"] for k in rs] == ["wire16"]


# -- persistent collectives on the ring --------------------------------------------

def test_persistent_binds_the_ring(ring_worlds, monkeypatch):
    """tests/test_pallas_coll.py:522-546: with the ring raised the handle
    runs the ring (fused, as the one-shot slot), bcast binds its root, and
    an int payload binds through the builtin module's cached reduction."""
    jw, tw = ring_worlds
    assert type(_ring(tw, "persistent_coll")).__name__ == "RingCollModule"
    host = _stack((8, 24), 23)
    jh, th = jw.allreduce_array_init(host), tw.allreduce_array_init(host)
    seen = _spy(monkeypatch, "all_reduce")
    want = np.asarray(jh(host))
    for _ in range(2):
        np.testing.assert_array_equal(_bits(_np(th(host))), _bits(want))
    assert [k["variant"] for k in seen] == ["fused", "fused"]
    jb = jw.c_coll["persistent_coll"](jw, "bcast", host, 3)
    tb = tw.c_coll["persistent_coll"](tw, "bcast", host, 3)
    np.testing.assert_array_equal(_bits(_np(tb(host))),
                                  _bits(np.asarray(jb(host))))
    ints = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    hi = tw.c_coll["persistent_coll"](tw, "allreduce", ints, ompi_tpu_torch.SUM)
    np.testing.assert_array_equal(_np(hi(ints)), ints.sum(0))
    builtin = _module(tw, "BuiltinCollModule")
    assert hi.fn is builtin._cache[("allreduce", "SUM", (8, 4), torch.int32,
                                    torch.device("cpu"))]


def test_persistent_allgather_follows_the_var(ring_worlds, monkeypatch):
    """tests/test_pallas_coll.py:77-93: the handle binds the routing of the
    moment, ring, then bidi once the var is on."""
    jw, tw = ring_worlds
    seen = _spy(monkeypatch, "all_gather")
    host = _stack((8, 16), 19)
    bind = lambda w: w.c_coll["persistent_coll"](w, "allgather", host)  # noqa: E731
    h = bind(tw)
    np.testing.assert_array_equal(_bits(_np(h(host))), _bits(host))
    for mod in (_ring(jw), _ring(tw)):
        mod.bidirectional = True
    hb = bind(tw)
    np.testing.assert_array_equal(_bits(_np(hb(host))),
                                  _bits(np.asarray(bind(jw)(host))))
    np.testing.assert_array_equal(_bits(_np(h(host))), _bits(host))
    assert [k["variant"] for k in seen] == ["ring", "ring", "bidi", "bidi",
                                            "ring"]


@pytest.mark.parametrize("ring_worlds", [BIDI], indirect=True)
def test_persistent_bidi_allreduce_matches_one_shot(ring_worlds, monkeypatch):
    """The never-diverge contract (pallas_coll.py:123-133) under the duplex
    var: handle, one-shot slot and the reference's handle agree bit for
    bit, all through bidi."""
    jw, tw = ring_worlds
    host = _stack((8, 407), 8)
    seen = _spy(monkeypatch, "all_reduce")
    h = tw.allreduce_array_init(host)
    persistent, one_shot = _np(h(host)), _np(tw.allreduce_array(host))
    np.testing.assert_array_equal(_bits(persistent), _bits(one_shot))
    np.testing.assert_array_equal(
        _bits(persistent), _bits(np.asarray(jw.allreduce_array_init(host)(host))))
    assert {k["variant"] for k in seen} == {"bidi"} and len(seen) == 3


@pytest.mark.parametrize("ring_worlds", [{"otpu_coll_ring_wire16": True}],
                         indirect=True)
def test_wire16_persistent_matches_one_shot(ring_worlds):
    """tests/test_pallas_coll.py:755-781: the persistent reduce-scatter
    takes the same wire16 remap as the one-shot slot."""
    jw, tw = ring_worlds
    host = _stack((8, 8, 128), 13)
    one_shot = _np(tw.reduce_scatter_array(host, ompi_tpu_torch.SUM))
    h = tw.c_coll["persistent_coll"](tw, "reduce_scatter", host,
                                     ompi_tpu_torch.SUM)
    np.testing.assert_array_equal(_bits(_np(h(host))), _bits(one_shot))
    jh = jw.c_coll["persistent_coll"](jw, "reduce_scatter", host, _jop("SUM"))
    np.testing.assert_array_equal(_bits(one_shot), _bits(np.asarray(jh(host))))
    _ring(tw).wire16 = False
    exact = _np(tw.reduce_scatter_array(host, ompi_tpu_torch.SUM))
    assert not np.allclose(one_shot, exact, rtol=1e-6)


# -- persistent collectives on coll/builtin, and the Comm entry points ------------

def test_persistent_allreduce_builtin(jax_world, torch_world):
    """tests/test_coll.py:233-243: the handle, its request, and ``h.fn`` is
    the builtin module's cached reduction, shared with the one-shot slot.
    SUM meets XLA's psum in another order: one float32 ulp per rank (rtol
    8 * 2**-24) of the reference's handle."""
    host = _stack((8, 5, 7), 15)
    dev = torch.from_numpy(host)
    h = torch_world.allreduce_array_init(dev)
    want = np.asarray(jax_world.allreduce_array_init(host)(host))
    np.testing.assert_allclose(_np(h(dev)), want, rtol=8 * 2.0 ** -24, atol=0)
    req = h.start(dev)
    req.wait()
    np.testing.assert_array_equal(_np(req.result), _np(h(dev)))
    builtin = _module(torch_world, "BuiltinCollModule")
    assert h.fn is builtin._cache[("allreduce", "SUM", dev.shape, dev.dtype,
                                   dev.device)]
    assert torch.equal(torch_world.allreduce_array(dev), h(dev))


def test_persistent_copies_bind_their_slot(torch_world):
    """Collectives builtin caches nothing for bind their slot, with the
    arguments given at init; an unknown one raises."""
    host = _stack((8, 8, 6), 16)
    w = torch_world
    for coll, args, want in (
            ("bcast", (5,), np.broadcast_to(host[5], host.shape)),
            ("alltoall", (), host.transpose(1, 0, 2)),
            ("ppermute", ([(i, (i + 1) % 8) for i in range(8)],),
             np.roll(host, 1, 0))):
        h = w.c_coll["persistent_coll"](w, coll, host, *args)
        np.testing.assert_array_equal(_bits(_np(h(host))), _bits(want))
    with pytest.raises(MpiError) as e:
        w.c_coll["persistent_coll"](w, "neighbor_allgather", host)
    assert e.value.error_class is ErrorClass.ERR_UNSUPPORTED_OPERATION


def test_coll_init_request_lifecycle(torch_world):
    """``coll_init``: inactive until started, then each start re-runs the
    bound collective on the template and completes at once; the host
    branch binds barrier through coll/conductor, and a collective it
    cannot bind raises."""
    w = torch_world
    x = torch.from_numpy(_stack((8, 24), 3))
    req = w.coll_init("allreduce", x)
    assert req.test()[0] and req.result is None
    for _ in range(2):
        req.start()
        req.wait()
        assert torch.equal(req.result, w.allreduce_array(x))
    barrier = w.coll_init("barrier")
    assert barrier.test()[0] and barrier.result is None
    for _ in range(2):
        barrier.start()
        barrier.wait()
        assert barrier.result is None
    with pytest.raises(MpiError) as e:
        w.coll_init("neighbor_allgather")
    assert e.value.error_class is ErrorClass.ERR_UNSUPPORTED_OPERATION


def test_persistent_handle_bumps_no_spc_counter(jax_world, torch_world):
    """SPC parity (the name kept from when the port had no SPC runtime):
    the device slots and the persistent handle bump the SPC device
    counters alike in both packages (xla.py:74-90, :158, :182) — the
    binding's one-shot run, every call and start of the handle, a one-shot
    allreduce, a bcast handle bound to its slot, and a barrier."""
    from ompi_tpu.runtime import spc as jspc
    from ompi_tpu_torch.runtime import spc as tspc

    host = _stack((8, 24), 4)
    names = ("device_collectives", "device_bytes")

    def run(world, spc, place):
        before = [spc.read(k) for k in names]
        h = world.allreduce_array_init(place(host))
        for _ in range(3):
            h(place(host))
        h.start(place(host))
        world.allreduce_array(place(host))
        b = world.coll_init("bcast", place(host), 2)
        b.start()
        b.wait()
        world.barrier()
        return [spc.read(k) - v for k, v in zip(names, before)]

    import jax.numpy as jnp

    want = run(jax_world, jspc, jnp.asarray)
    got = run(torch_world, tspc, lambda a: cudaenv.make_world_array(
        a, torch_world.rte.device))
    assert got == want
    assert got[0] == 9 and got[1] == 8 * host.nbytes + 8 * 4


def test_persistent_allreduce_on_a_budgeted_comm(jax_world, torch_world):
    """Reference behaviour not copied: on a comm with an accuracy budget
    the reference's binding looks its program up under the exact
    reduction's key while the call cached the codec's, and raises KeyError
    (xla.py:681-682); the port binds the slot, so the handle takes the
    codec the one-shot call takes (int8 here)."""
    host = _stack((8, 4096), 5)
    jc, tc = jax_world.dup(), torch_world.dup()
    jc.info.set("otpu_quant_budget", "0.01")
    tc.info.set("otpu_quant_budget", "0.01")
    with pytest.raises(KeyError):
        jc.allreduce_array_init(host)
    h = tc.allreduce_array_init(host)
    np.testing.assert_array_equal(_bits(_np(h(host))),
                                  _bits(_np(tc.allreduce_array(host))))
    np.testing.assert_array_equal(_bits(_np(h(host))),
                                  _bits(np.asarray(jc.allreduce_array(host))))


def test_cpu_lane_launches_nothing(ring_worlds):
    jw, tw = ring_worlds
    before = dict(rc.launches)
    host = _stack((8, 300), 6)
    for mod in (_ring(tw),):
        mod.bidirectional = True
    tw.allreduce_array_init(host)(host)
    tw.coll_init("allgather", host).start()
    assert rc.launches == before
