"""ULFM in one process, held against the JAX package: the failure state's
listeners and epoch-scoped revocation keys, the device world's shrink,
revoke and ``ack_failed`` (``tests/test_ft.py``'s ``TestDeviceWorldFt``),
the revocation probe of every slot (the ``*_array`` slots and persistent
handles too) with the parent untouched, collectives on the shrunken comm
over the raised ring (K3, K4 and K12's plain versions here, interpret mode
in the reference; integer-valued inputs, so bit for bit), pml/ob1's
completion of a dead peer's requests, the coordination service's ``del``
op, failed-rank fences and recovery scope, the agreement's tree shape and
keys, tpurun's recovery monitor, and btl/tcp's suspects.  The jobs of
``tpurun`` are in ``test_torch_ft_mp.py``.
"""
import threading

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch
from test_torch_comm import _owner, _same
from test_torch_world import ring_worlds  # noqa: F401


def _pkgs():
    import ompi_tpu.ft.state as jstate
    import ompi_tpu_torch.ft.state as tstate

    return (("jax", jstate), ("torch", tstate))


@pytest.fixture
def worlds():
    """Both device worlds with ERRORS_RETURN (ULFM applications opt out of
    abort-on-error), fresh for every test: the FT state is global."""
    from ompi_tpu.api.errhandler import ERRORS_RETURN as JRET
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.api.errhandler import ERRORS_RETURN as TRET
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    tw = ompi_tpu_torch.init(device="cpu")
    jw.set_errhandler(JRET)
    tw.set_errhandler(TRET)
    yield jw, tw
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _error(fn):
    """The class name and MPI error class a call raises, or None."""
    try:
        fn()
    except Exception as exc:   # noqa: BLE001 - compared across packages
        return type(exc).__name__, int(getattr(exc, "error_class", -1))
    return None


def test_failure_state_listeners_match_the_reference():
    seen = {}
    for name, st in _pkgs():
        st.reset_for_testing()
        seen[name] = []
        st.on_failure(seen[name].append)
        st.mark_failed(3)
        st.mark_failed(3)            # dedup
        st.mark_failed(5)
        assert st.is_failed(3) and not st.is_failed(4)
        assert st.failed_ranks() == frozenset({3, 5})
        st.reset_for_testing()
        assert not st.is_failed(3)
    assert seen["torch"] == seen["jax"] == [3, 5]


def test_revocation_keys_are_epoch_scoped_like_the_reference():
    got = {}
    for name, st in _pkgs():
        st.reset_for_testing()
        st.mark_revoked(5, epoch=0)
        st.mark_revoked(6, epoch=2, job="job1")
        got[name] = [st.is_comm_revoked(5, 0), st.is_comm_revoked(5, 1),
                     st.is_comm_revoked(6, 2), st.is_comm_revoked(6, 2, "job1"),
                     st.is_revoked_key(("0", 5, 0)),
                     st.is_revoked_key(("job1", 6, 2))]
        st.reset_for_testing()
    assert got["torch"] == got["jax"] == [True, False, False, True, True, True]


def test_send_to_a_failed_rank_raises_before_staging(worlds):
    import torch

    jw, tw = worlds
    for _, st in _pkgs():
        st.mark_failed(1)
    big = torch.zeros(1 << 20)
    outcomes = [_error(lambda: w.as_rank(0).send(buf, dest=1))
                for w, buf in ((jw, np.zeros(1)), (tw, big))]
    assert outcomes[0] == outcomes[1] == ("ProcFailedError", 75)
    assert tw.get_failed().size == jw.get_failed().size == 1
    assert list(tw.get_failed().world_ranks) == [1]
    # a live peer is unaffected
    tw.as_rank(0).send(np.arange(3.0), dest=2, tag=4)
    got = np.zeros(3)
    tw.as_rank(2).recv(got, source=0, tag=4)
    assert got.tolist() == [0.0, 1.0, 2.0]


def test_revoke_then_every_slot_raises(worlds):
    jw, tw = worlds
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    z = np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2)
    calls = {
        "barrier": lambda c: c.barrier(),
        "allreduce": lambda c: c.allreduce(x),
        "allreduce_array": lambda c: c.allreduce_array(x),
        "bcast_array": lambda c: c.bcast_array(x, 1),
        "allgather_array": lambda c: c.allgather_array(x),
        "reduce_scatter_array": lambda c: c.reduce_scatter_array(z),
        "alltoall_array": lambda c: c.alltoall_array(z),
        "reduce_array": lambda c: c.reduce_array(x),
        "scan_array": lambda c: c.scan_array(x),
        "coll_init": lambda c: c.coll_init("allreduce", x),
        "send": lambda c: c.as_rank(0).send(np.zeros(1), dest=1),
        "dup": lambda c: c.dup(),
        "agree": lambda c: c.agree(0b101),
    }
    res = {}
    for name, w in (("jax", jw), ("torch", tw)):
        d = w.dup()
        handle = d.coll_init("allreduce", x)   # bound before the revoke
        d.revoke()
        assert d.is_revoked()
        # another rank's facade of the comm learns it through the global
        # FT state even with its own flag cleared
        other = d.as_rank(1)
        other.revoked = False
        res[name] = {k: _error(lambda f=f: f(other)) for k, f in calls.items()}
        # the reference's persistent device handle re-runs its bound
        # program without a state check
        res[name]["bound handle"] = _error(
            lambda h=handle: (h.start(), h.wait()))
        res[name]["parent"] = _error(lambda w=w: w.allreduce_array(x))
    assert res["torch"] == res["jax"]
    assert res["torch"]["allreduce_array"] == ("RevokedError", 77)
    assert res["torch"]["agree"] is None and res["torch"]["parent"] is None
    assert res["torch"]["bound handle"] is None


def test_a_flooded_revocation_reaches_the_fast_path(worlds):
    """A revocation that arrives from another rank lands in the global set
    only (the flood's ``mark_revoked``): the comm's own flag is clear, and
    the cached key probe still turns ``allreduce_array`` away."""
    jw, tw = worlds
    x = np.ones((8, 2), np.float32)
    for (_, st), w in zip(_pkgs(), (jw, tw)):
        d = w.dup()
        assert not d.is_revoked()
        st.mark_revoked(d.cid, d.epoch, d.ft_scope)
        assert not d.revoked and d.is_revoked()
        assert _error(lambda: d.allreduce_array(x)) == ("RevokedError", 77)
        e = w.dup()
        st.mark_revoked(e.cid, e.epoch + 1, e.ft_scope)   # another epoch
        assert _error(lambda: e.allreduce_array(x)) is None
    assert tw.ft_scope == jw.ft_scope == "0"


def test_a_revoked_comm_under_the_fatal_handler_aborts(worlds):
    from ompi_tpu.api.errhandler import ERRORS_ARE_FATAL as JFATAL
    from ompi_tpu_torch.api.errhandler import ERRORS_ARE_FATAL as TFATAL

    jw, tw = worlds
    codes = []
    for w, fatal in ((jw, JFATAL), (tw, TFATAL)):
        d = w.dup()
        d.set_errhandler(fatal)
        d.revoke()
        with pytest.raises(SystemExit) as ei:
            d.barrier()
        codes.append(ei.value.code)
    assert codes == [77, 77]


def test_shrink_excludes_failed_like_the_reference(worlds):
    jw, tw = worlds
    for _, st in _pkgs():
        st.mark_failed(7)
    js, ts = jw.shrink(), tw.shrink()
    assert list(ts.group.world_ranks) == list(js.group.world_ranks) == \
        list(range(7))
    assert ts.epoch == js.epoch == 1 and ts.size == 7
    assert ts.name == js.name
    host = np.arange(7 * 4, dtype=np.float64).reshape(7, 4)
    _same(ts.allreduce(host), js.allreduce(host))
    assert tw.ack_failed() == jw.ack_failed() == 1
    assert ts.ack_failed() == js.ack_failed() == 0
    # the shrunken comm's dup keeps the epoch
    assert tw.shrink().epoch == 1 and ts.dup().epoch == 1
    # a second failure: a shrink of the shrunken comm
    for _, st in _pkgs():
        st.mark_failed(2)
    js2, ts2 = js.shrink(), ts.shrink()
    assert list(ts2.group.world_ranks) == list(js2.group.world_ranks) == \
        [0, 1, 3, 4, 5, 6]
    assert ts2.epoch == js2.epoch == 2


def _ints(n, per, seed):
    return np.random.default_rng(seed).integers(
        -1000, 1000, (n, per)).astype(np.float32)


@pytest.mark.parametrize(
    "ring_worlds", [{"otpu_coll_ring_vmem_max_bytes": 2048}], indirect=True)
def test_ring_collectives_on_the_shrunken_comm(ring_worlds, monkeypatch):
    """World rank 7 failed: the 7-rank comm takes the raised ring (K3
    fused, K4 above ``vmem_max_bytes``, K12), bit for bit with the
    reference's, and the world's own calls still take n = 8."""
    from ompi_tpu.api import op as jop
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    for _, st in _pkgs():
        st.mark_failed(7)
    js, ts = jw.shrink(), tw.shrink()
    assert _owner(ts, "allreduce_array") == "RingCollModule"
    seen = []
    for name in ("all_reduce", "bcast"):
        real = getattr(rc, name)
        monkeypatch.setattr(rc, name, lambda *a, _n=name, _r=real, **k:
                            seen.append((_n, a[1], k.get("variant")))
                            or _r(*a, **k))
    for per in (300, 1000):
        x = _ints(7, per, per)
        _same(ts.allreduce_array(x), js.allreduce_array(x, jop.SUM), per)
    b = _ints(7, 500, 3)
    _same(ts.bcast_array(b, 6), js.bcast_array(b, 6))
    w8 = _ints(8, 300, 4)
    _same(tw.allreduce_array(w8), jw.allreduce_array(w8, jop.SUM))
    assert seen == [("all_reduce", 7, "fused"), ("all_reduce", 7, "seg"),
                    ("bcast", 7, None), ("all_reduce", 8, "fused")], seen


def test_a_dead_peer_completes_its_requests_in_error(worlds):
    """ob1's ``_peer_failed``: a receive posted for the dead rank completes
    with ProcFailedError; an ANY_SOURCE receive stays pending."""
    jw, tw = worlds
    res = {}
    for (name, st), w in zip(_pkgs(), (jw, tw)):
        c = w.dup()
        named = c.as_rank(0).irecv(np.zeros(2), source=3, tag=1)
        anysrc = c.as_rank(0).irecv(np.zeros(2), tag=2)
        st.mark_failed(3)
        res[name] = (_error(named.wait), anysrc.test()[0])
        anysrc.cancel()
    assert res["torch"] == res["jax"] == (("ProcFailedError", 75), False)


def _coord_pair():
    from ompi_tpu.rte import coord as jcoord
    from ompi_tpu_torch.rte import coord as tcoord

    return (("jax", jcoord), ("torch", tcoord))


def test_coord_fences_count_failed_ranks_and_delete_keys():
    res = {}
    for name, mod in _coord_pair():
        server = mod.CoordServer(3)
        try:
            c0 = mod.CoordClient(addr=server.addr)
            c1 = mod.CoordClient(addr=server.addr)
            c0.put(0, "k", 1)
            c0.delete(0, "k")
            gone = c0.get(0, "k", wait=False)
            done = threading.Event()
            t = threading.Thread(target=lambda: (
                c0.fence("f", rank=0, expect=[0, 1, 2]), done.set()))
            t.start()
            c1.event_publish("proc_failed", {"rank": 2, "origin": "test"})
            early = done.wait(0.3)
            c1.fence("f", rank=1, expect=[0, 1, 2])
            t.join(10)
            with c0.recovery_scope():
                with c0.recovery_scope():
                    depth = c0._recovery_depth
            events = [e[1:] for e in c0.event_poll()]
            res[name] = (gone, early, done.is_set(), depth,
                         c0._recovery_depth, events)
            c0.close()
            c1.close()
        finally:
            server.close()
    assert res["torch"] == res["jax"] == (
        None, False, True, 2, 0,
        [("proc_failed", {"rank": 2, "origin": "test"})])


def test_agreement_shapes_and_keys_match_the_reference():
    from ompi_tpu.ft import agreement as ja
    from ompi_tpu_torch.ft import agreement as ta

    for parts in ([0], [0, 1], [0, 1, 2], [1, 3, 4, 6, 7], list(range(9)),
                  list(range(0, 40, 3))):
        for me in parts:
            assert ta._p2p_tree(parts, me) == ja._p2p_tree(parts, me)
    inst = ("agree", 3, 1, 7)
    assert ta._key(inst, "d") == ja._key(inst, "d") == "ftagree:d:agree:3:1:7"
    assert ta._P2P_PROTO == ja._P2P_PROTO
    for name in ("agree_kv", "agree_tree", "agree_p2p"):
        assert getattr(ta, name).__name__ == getattr(ja, name).__name__ \
            == name


def test_ftagree_declines_the_device_world_like_the_reference(worlds):
    from ompi_tpu.mca.coll import ftagree as jf
    from ompi_tpu_torch.mca.coll import ftagree as tf

    jw, tw = worlds
    assert tf.COMPONENT.comm_query(tw) is None
    assert jf.COMPONENT.comm_query(jw) is None
    assert (tf.COMPONENT.name, tf.COMPONENT.priority) == \
        (jf.COMPONENT.name, jf.COMPONENT.priority) == ("ftagree", 30)
    assert _owner(tw, "agree") == _owner(jw, "agree") == "ConductorModule"


class _Proc:
    def __init__(self, rc):
        self.returncode = rc

    def poll(self):
        return self.returncode


@pytest.mark.parametrize("rcs", [[0, 13, 0], [13, 0, 0], [13, 7, 9], [0, 0]])
@pytest.mark.parametrize("recovery", [False, True])
def test_the_recovery_monitor_matches_the_reference(rcs, recovery, capsys):
    from ompi_tpu.tools import tpurun as jt
    from ompi_tpu_torch.tools import tpurun as tt

    res = []
    for mod in (jt, tt):
        procs = [_Proc(rc) for rc in rcs]
        failed = []
        code = mod._monitor(procs, procs.index, enable_recovery=recovery,
                            label="tpurun",
                            on_fail=lambda r, rc: failed.append((r, rc)))
        res.append((code, failed))
    assert res[0] == res[1]


def test_tcp_drains_a_dropped_peer_as_a_suspicion(monkeypatch):
    """A connection that dies mid-traffic records its peer; the next
    progress call (either lane) hands it to the detector, with no lock
    held, as the reference's btl does."""
    from ompi_tpu.ft import propagator as jprop
    from ompi_tpu.mca.btl import tcp as jtcp
    from ompi_tpu_torch.ft import propagator as tprop
    from ompi_tpu_torch.mca.btl import tcp as ttcp

    res = []
    for prop, tcp in ((jprop, jtcp), (tprop, ttcp)):
        seen = threading.Event()
        got = []

        class _Det:
            def wire_suspicion(self, rank):
                got.append(rank)
                seen.set()

        monkeypatch.setattr(prop, "_detector", _Det())
        btl = tcp.TcpBtl()
        conn = tcp._Conn(None, rank=4)
        btl._by_rank[4] = [conn]
        btl._drop_conn(conn)
        assert btl._suspects == [4]
        btl.progress()
        assert seen.wait(5)
        res.append((got, btl._suspects, 4 in btl._by_rank))
    assert res[0] == res[1] == ([4], [], False)


def test_best_effort_ft_frames_honour_the_connect_backoff():
    import time

    from ompi_tpu_torch.mca.btl import tcp as ttcp
    from ompi_tpu_torch.mca.btl.base import CTL, Endpoint, Frag

    btl = ttcp.TcpBtl()
    btl._connect_backoff[3] = time.monotonic() + 60
    ep = Endpoint(btl, 3)
    with pytest.raises(ConnectionError, match="backoff"):
        btl.send(ep, Frag(0, 0, 3, -1, 0, CTL, meta={"proto": "ft_hb"}))
    with pytest.raises(ConnectionError, match="established"):
        btl.send(ep, Frag(0, 0, 3, -1, 0, CTL,
                          meta={"proto": "ft_hb", "est_only": True}))


def test_sm_flush_drops_frames_to_a_failed_rank():
    """Finalize's flush: frames queued to a failed rank are undeliverable
    and dropped (the reference's ``close`` skips them); frames to a live
    rank that stopped draining still fail the rank."""
    from ompi_tpu_torch.api.errors import MpiError
    from ompi_tpu_torch.base.containers import Fifo
    from ompi_tpu_torch.ft import state as ft_state
    from ompi_tpu_torch.mca.btl.sm import SmBtl

    ft_state.reset_for_testing()
    try:
        btl = SmBtl()
        for rank in (5, 6):
            btl._pending[rank] = Fifo()
            btl._pending[rank].push((b"h", b"payload"))
        ft_state.mark_failed(5)
        with pytest.raises(MpiError, match=r"world ranks \{6: 1\}"):
            btl.flush(timeout=0.2)
        assert 5 not in btl._pending
        ft_state.mark_failed(6)
        btl.flush(timeout=0.2)
        assert not btl._pending
    finally:
        ft_state.reset_for_testing()
