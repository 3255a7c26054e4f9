"""pml/ob1 in the port's device world on the CPU lane, held against the JAX
package's: ``tests/test_pml.py``'s fifteen cases (wildcards, ordering, the
unexpected and out-of-order queues, probe/mprobe, truncation, rendezvous
above the eager limit, sendrecv, objects, the SPC counters,
``Request.get_status``) through ``as_rank``, each run on both worlds with
the same seeded numpy inputs.  Buffers and statuses are compared exactly:
point-to-point does no arithmetic.

A tensor is the port's ``jax.Array``: as a send buffer it is staged to the
host (``torch_acc.to_host``), as the reference's ``np.asarray`` stages a
``jax.Array``; as a receive buffer the reference's ``np.asarray`` view is
read-only and the delivery raises ``ValueError`` — the port copies that
(pinned below), so a receive into a tensor never writes back silently.
"""
import importlib.util
import inspect
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch


def _ns(pkg):
    """The package's point-to-point surface under one set of names."""
    root = pkg.__name__
    mod = __import__
    errors = mod(f"{root}.api.errors", fromlist=["x"])
    status = mod(f"{root}.api.status", fromlist=["x"])
    request = mod(f"{root}.api.request", fromlist=["x"])
    btl = mod(f"{root}.mca.btl.base", fromlist=["x"])
    return SimpleNamespace(
        pkg=pkg, MpiError=errors.MpiError, ErrorClass=errors.ErrorClass,
        ANY_SOURCE=status.ANY_SOURCE, ANY_TAG=status.ANY_TAG,
        waitall=request.waitall, Frag=btl.Frag, MATCH=btl.MATCH,
        datatype=mod(f"{root}.datatype", fromlist=["x"]),
        spc=mod(f"{root}.runtime.spc", fromlist=["x"]))


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": (jw, _ns(ompi_tpu)),
           "torch": (ompi_tpu_torch.init(device="cpu"), _ns(ompi_tpu_torch))}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _st(st):
    """A status as a comparable tuple (its error class as an int)."""
    return (st.source, st.tag, int(st.error), st._nbytes, st.is_cancelled())


def _buf(a):
    return (str(a.dtype), a.shape, a.tobytes())


def _both(worlds, case):
    """Run ``case(world, ns)`` on both packages; the results must match."""
    got = {name: case(w, ns) for name, (w, ns) in worlds.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _data(seed, n, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def test_basic_send_recv(worlds):
    def case(w, ns):
        a, b = w.as_rank(2), w.as_rank(5)
        a.send(_data(1, 2), dest=5, tag=9)
        buf = np.zeros(2)
        st = b.recv(buf, source=2, tag=9)
        return _st(st), _buf(buf), st.get_count(ns.datatype.FLOAT64)

    st, _, count = _both(worlds, case)
    assert st[:2] == (2, 9) and count == 2


def test_wildcard_source_and_tag(worlds):
    def case(w, ns):
        w.as_rank(1).send(np.array([7]), dest=0, tag=42)
        buf = np.zeros(1, np.int64)
        st = w.as_rank(0).recv(buf, source=ns.ANY_SOURCE, tag=ns.ANY_TAG)
        return _st(st), _buf(buf)

    assert _both(worlds, case)[0][:2] == (1, 42)


@pytest.mark.parametrize("order", ["in_order", "tag_selective"])
def test_matching_order(worlds, order):
    """Messages from one sender with one tag match in send order; a later
    recv with another tag matches an earlier message."""
    def case(w, ns):
        s, r = w.as_rank(3), w.as_rank(4)
        tags = [1] * 5 if order == "in_order" else [5, 6, 5, 6, 7]
        for i, t in enumerate(tags):
            s.send(np.array([100 * i + t]), dest=4, tag=10 * t)
        got = []
        for t in (tags if order == "in_order" else [7, 6, 5, 6, 5]):
            buf = np.zeros(1, np.int64)
            got.append((_st(r.recv(buf, source=3, tag=10 * t)),
                        int(buf[0])))
        return got

    got = _both(worlds, case)
    if order == "in_order":
        assert [v for _, v in got] == [1, 101, 201, 301, 401]
    else:
        assert [v for _, v in got] == [407, 106, 5, 306, 205]


def test_posted_recv_matches_later_send(worlds):
    def case(w, ns):
        r = w.as_rank(1)
        buf = np.zeros(1, np.int64)
        req = r.irecv(buf, source=0, tag=11)
        pending = req.complete_flag
        w.as_rank(0).send(np.array([33]), dest=1, tag=11)
        return pending, _st(req.wait()), _buf(buf)

    assert _both(worlds, case)[0] is False


def test_out_of_order_seq_held(worlds):
    """A frag with a future seq is held until the gap fills
    (recvfrag.c:106)."""
    def case(w, ns):
        pml, cid, src, dst = w.pml, w.cid, 5, 0
        ctr = pml._seq.setdefault((cid, src, dst), itertools.count())
        s0, s1 = next(ctr), next(ctr)
        f0 = ns.Frag(cid, src, dst, 77, s0, ns.MATCH,
                     np.array([10], np.int64).tobytes(), total_len=8)
        f1 = ns.Frag(cid, src, dst, 77, s1, ns.MATCH,
                     np.array([20], np.int64).tobytes(), total_len=8)
        pml._recv_frag(f1)  # future seq: held
        b1 = np.zeros(1, np.int64)
        req = w.as_rank(0).irecv(b1, source=5, tag=77)
        held = req.complete_flag
        pml._recv_frag(f0)  # gap fills, both deliver in order
        st1 = _st(req.wait())
        b2 = np.zeros(1, np.int64)
        st2 = _st(w.as_rank(0).recv(b2, source=5, tag=77))
        return held, st1, int(b1[0]), st2, int(b2[0])

    assert _both(worlds, case)[::2] == (False, 10, 20)


def test_truncation_error(worlds):
    def case(w, ns):
        w.as_rank(0).send(np.arange(4, dtype=np.int64), dest=1, tag=13)
        small = np.zeros(2, np.int64)
        with pytest.raises(ns.MpiError) as ei:
            w.as_rank(1).recv(small, source=0, tag=13)
        return ei.value.error_class.name, _buf(small)

    err, (_, _, raw) = _both(worlds, case)
    assert err == "ERR_TRUNCATE"
    assert np.frombuffer(raw, np.int64).tolist() == [0, 1]


def test_probe_iprobe(worlds):
    def case(w, ns):
        ok, st0 = w.as_rank(3).iprobe(source=2, tag=21)
        w.as_rank(2).send(_data(2, 3, np.float32), dest=3, tag=21)
        st = w.as_rank(3).probe(source=2, tag=21)
        ok2, st2 = w.as_rank(3).iprobe(source=ns.ANY_SOURCE, tag=21)
        buf = np.zeros(3, np.float32)
        w.as_rank(3).recv(buf, source=2, tag=21)   # probe does not consume
        return ok, st0, _st(st), ok2, _st(st2), _buf(buf)

    ok, _, st, ok2, _, _ = _both(worlds, case)
    assert not ok and ok2 and st[:2] == (2, 21) and st[3] == 12


def test_mprobe_mrecv(worlds):
    def case(w, ns):
        w.as_rank(4).send(np.array([5, 6]), dest=5, tag=31)
        w.as_rank(4).send(np.array([7, 8]), dest=5, tag=32)
        msg = w.as_rank(5).mprobe(source=4, tag=31)
        # the message left matching: a probe on its tag no longer sees it
        ok, _ = w.as_rank(5).iprobe(source=4, tag=31)
        buf = np.zeros(2, np.int64)
        st = msg.recv(buf)
        found, msg2 = w.as_rank(5).improbe(source=4, tag=32)
        buf2 = np.zeros(2, np.int64)
        msg2.irecv(buf2).wait()
        missing = w.as_rank(5).improbe(source=4, tag=33)
        return ok, _st(st), _buf(buf), found, _buf(buf2), missing

    got = _both(worlds, case)
    assert got[0] is False and got[3] is True and got[5] == (False, None)


def test_any_tag_ignores_internal_tags(worlds):
    def case(w, ns):
        pml = w.pml
        ctr = pml._seq.setdefault((w.cid, 6, 7), itertools.count())
        pml._recv_frag(ns.Frag(w.cid, 6, 7, -5, next(ctr), ns.MATCH,
                               b"\x01" * 8, total_len=8))
        ok, _ = w.as_rank(7).iprobe(source=6, tag=ns.ANY_TAG)
        buf = np.zeros(1, np.int64)
        st = w.as_rank(7).recv(buf, source=6, tag=-5)   # explicit tag does
        return ok, _st(st), _buf(buf)

    assert _both(worlds, case)[0] is False


@pytest.mark.parametrize("n", [100, 4097])
def test_rendezvous_protocol(worlds, n):
    """RNDV/ACK/FRAG, forced by shrinking btl/self's eager limits: the
    head, a ragged last fragment, the statuses."""
    def case(w, ns):
        btl = w.pml.bml.endpoint(1).btl
        saved = (btl.eager_limit, btl.rndv_eager_limit, btl.max_send_size)
        btl.eager_limit, btl.rndv_eager_limit, btl.max_send_size = 64, 32, 48
        try:
            data = _data(3, n)
            req = w.as_rank(0).isend(data, dest=1, tag=55)
            before = req.complete_flag
            buf = np.zeros(n, np.float64)
            st = w.as_rank(1).recv(buf, source=0, tag=55)
            req.wait()
            return before, _st(st), _buf(buf)
        finally:
            btl.eager_limit, btl.rndv_eager_limit, btl.max_send_size = saved

    before, st, (_, _, raw) = _both(worlds, case)
    assert before is False and st[3] == 8 * n
    assert raw == _data(3, n).tobytes()


def test_sendrecv_and_objects(worlds):
    def case(w, ns):
        out = np.zeros(1)
        st = w.as_rank(0).sendrecv(np.array([1.0]), dest=0, recvbuf=out,
                                   source=0, sendtag=61, recvtag=61)
        w.as_rank(2).send_obj({"hello": [1, 2, 3]}, dest=3, tag=62)
        obj = w.as_rank(3).recv_obj(source=2, tag=62)
        return _st(st), _buf(out), obj

    assert _both(worlds, case)[2] == {"hello": [1, 2, 3]}


def test_spc_counters_advance(worlds):
    """The pml's SPC counters move alike in both packages."""
    names = ("send", "recv", "isend", "irecv", "bytes_sent",
             "bytes_received", "matched_msgs", "unexpected_msgs")

    def case(w, ns):
        before = {k: ns.spc.read(k) for k in names}
        w.as_rank(0).send(np.zeros(10, np.float64), dest=1, tag=70)
        w.as_rank(1).recv(np.zeros(10, np.float64), source=0, tag=70)
        req = w.as_rank(1).irecv(np.zeros(3, np.int32), source=0, tag=71)
        w.as_rank(0).send(np.ones(3, np.int32), dest=1, tag=71)
        req.wait()
        return {k: ns.spc.read(k) - before[k] for k in names}

    got = _both(worlds, case)
    assert got["bytes_sent"] == 92 and got["unexpected_msgs"] == 1


def test_sendrecv_replace(worlds):
    def case(w, ns):
        a, b = w.as_rank(0), w.as_rank(1)
        bufa, bufb = _data(5, 2), _data(6, 2)
        ra = a.isend(bufa.copy(), dest=1, tag=5)
        st = b.sendrecv_replace(bufb, dest=0, source=0, sendtag=6, recvtag=5)
        got = np.zeros(2)
        a.recv(got, source=1, tag=6)
        ns.waitall([ra])
        return _st(st), _buf(bufb), _buf(got)

    _, b, g = _both(worlds, case)
    assert b[2] == _data(5, 2).tobytes() and g[2] == _data(6, 2).tobytes()


def test_request_get_status_no_side_effects(worlds):
    def case(w, ns):
        s, r = w.as_rank(2), w.as_rank(3)
        buf = np.zeros(1)
        req = r.irecv(buf, source=2, tag=9)
        flag0, _ = req.get_status()
        s.send(np.array([4.0]), dest=3, tag=9)
        flag, st = req.get_status()
        req.wait()   # still waitable (get_status freed nothing)
        return flag0, flag, _st(st), _buf(buf)

    assert _both(worlds, case)[:2] == (False, True)


def test_a_tensor_send_buffer_is_staged(worlds):
    """A tensor sent is staged to the host, as the reference stages a
    ``jax.Array``: the receiver gets its bytes."""
    import jax.numpy as jnp

    host = _data(7, 6, np.float32)

    def case(w, ns):
        src = torch.from_numpy(host) if ns.pkg is ompi_tpu_torch \
            else jnp.asarray(host)
        w.as_rank(6).send(src, dest=7, tag=80)
        buf = np.zeros(6, np.float32)
        return _st(w.as_rank(7).recv(buf, source=6, tag=80)), _buf(buf)

    assert _both(worlds, case)[1][2] == host.tobytes()


@pytest.mark.parametrize("posted", [False, True])
def test_a_tensor_receive_buffer_raises_like_the_reference(worlds, posted):
    """Reference behaviour copied: a ``jax.Array`` receive buffer is seen
    through a read-only ``np.asarray`` view, so the delivery raises
    ``ValueError`` — from the ``recv`` when the message was unexpected,
    from the sender's ``send`` (btl/self delivers inline) when the receive
    was posted.  The port raises the same for a tensor; nothing is written
    back into the tensor.  Each case runs on a dup: the failed delivery
    leaves that pair's sequence stuck, as in the reference."""
    import jax.numpy as jnp

    def case(w, ns):
        c = w.dup()
        dst = torch.zeros(4) if ns.pkg is ompi_tpu_torch \
            else jnp.zeros(4, jnp.float32)
        msg = np.arange(4, dtype=np.float32)
        if posted:
            c.as_rank(1).irecv(dst, source=0, tag=3)
            with pytest.raises(ValueError) as ei:
                c.as_rank(0).send(msg, dest=1, tag=3)
        else:
            c.as_rank(0).send(msg, dest=1, tag=3)
            with pytest.raises(ValueError) as ei:
                c.as_rank(1).recv(dst, source=0, tag=3)
        return str(ei.value), np.asarray(dst).tolist()

    err, untouched = _both(worlds, case)
    assert "read-only" in err and untouched == [0.0] * 4


NOT_COPIED = {
    # the static analyzer: otpu_info's --lint section (the registered
    # analysis passes), the otpu_lint gate and the analysis package
    "otpu_info_lint": lambda pkg: "analysis.all_passes" in inspect.getsource(
        importlib.import_module(f"{pkg}.tools.otpu_info")),
    "otpu_lint": lambda pkg: importlib.util.find_spec(
        f"{pkg}.tools.otpu_lint") is not None,
    "analysis": lambda pkg: importlib.util.find_spec(
        f"{pkg}.analysis") is not None,
}

#: reference behaviour a later slice copied (the sessions and dpm slice,
#: the train-through-failure slice, the message logging and partitioned
#: communication slice, the device world and launcher slice, the serving
#: engine slice, the serving fleet and PGAS/tool slice, then the operator
#: tools slice): present in both packages now
COPIED = {
    # the template components (a skeleton btl and pml to copy from): A 8
    "btl_template": lambda pkg: importlib.util.find_spec(
        f"{pkg}.mca.btl.template") is not None,
    "pml_template": lambda pkg: importlib.util.find_spec(
        f"{pkg}.mca.pml.template") is not None,
    # the rest of base/containers (opal_lifo, opal_ring_buffer,
    # opal_hotel, opal_graph): A 8
    "containers_lifo": lambda pkg: hasattr(importlib.import_module(
        f"{pkg}.base.containers"), "Lifo"),
    "containers_ring_buffer": lambda pkg: hasattr(importlib.import_module(
        f"{pkg}.base.containers"), "RingBuffer"),
    "containers_hotel": lambda pkg: hasattr(importlib.import_module(
        f"{pkg}.base.containers"), "Hotel"),
    "containers_graph": lambda pkg: hasattr(importlib.import_module(
        f"{pkg}.base.containers"), "Graph"),
    # the tools: otpu_info (and with it ``otpu_info --serving``): A 9
    "otpu_info": lambda pkg: importlib.util.find_spec(
        f"{pkg}.tools.otpu_info") is not None,
    # the serving fleet (per-model pools, the telemetry-driven autoscaler,
    # tpurun --pool): A 7
    "fleet": lambda pkg: importlib.util.find_spec(f"{pkg}.serving.fleet")
    is not None and "--pool" in inspect.getsource(importlib.import_module(
        f"{pkg}.tools.tpurun")),
    # the OpenSHMEM-style PGAS layer: A 8
    "shmem": lambda pkg: importlib.util.find_spec(f"{pkg}.shmem")
    is not None,
    # MPI_T, the tool information interface: A 8
    "tool": lambda pkg: importlib.util.find_spec(f"{pkg}.api.tool")
    is not None,
    # the debugger views over the live-communicator registry: A 8
    "debugger": lambda pkg: importlib.util.find_spec(
        f"{pkg}.runtime.debugger") is not None and hasattr(
        importlib.import_module(f"{pkg}.api.comm"), "live_comms"),
    # the serving engine (its KV stream rides part's Pready): A 7
    "serving_engine": lambda pkg: importlib.util.find_spec(
        f"{pkg}.serving") is not None,
    # the sender-based message logging protocol (pml/vprotocol): A 4.6
    "pml_vprotocol": lambda pkg: importlib.util.find_spec(
        f"{pkg}.mca.pml.vprotocol") is not None,
    # partitioned communication (mca/part with persist and pcoll): A 5
    "part": lambda pkg: importlib.util.find_spec(f"{pkg}.mca.part")
    is not None,
    # shrink publishes the agreed survivors as the mpi://shrunk/<cid>
    # process set (the coordination service's psets)
    "shrink_pset": lambda pkg: "pset_publish" in inspect.getsource(
        __import__(f"{pkg}.ft.shrink", fromlist=["x"]).shrink),
    # the top-level Session
    "top_level_session": lambda pkg: "Session" in __import__(pkg)._API,
    # the top-level get_parent and open_port (dpm)
    "top_level_dpm": lambda pkg: {"get_parent", "open_port"}
    <= set(__import__(pkg)._API),
    # coll/inter, the intercommunicators' collectives
    "coll_inter": lambda pkg: importlib.util.find_spec(
        f"{pkg}.mca.coll.inter") is not None,
    # the agreement's chaos kill points before its prepare and decision
    # frames (ft/chaos.py)
    "agree_kill_points": lambda pkg: "kill_point" in inspect.getsource(
        __import__(f"{pkg}.ft.agreement", fromlist=["x"])._p2p_send),
    # the top-level File (MPI-IO)
    "top_level_file": lambda pkg: "File" in __import__(pkg)._API,
    # btl/tcp's chaos hooks (injected drops, delays, resets, corruption on
    # the wire)
    "tcp_chaos": lambda pkg: hasattr(
        __import__(f"{pkg}.mca.btl.tcp", fromlist=["x"]), "chaos"),
    # the multi-process device world's boot in the instance: A 4.8
    "device_world": lambda pkg: hasattr(importlib.import_module(
        f"{pkg}.instance").Instance, "_boot_device_world"),
    # tpurun's hostfiles and launch agents (the child launcher): A 4.5
    "hostfile": lambda pkg: all(hasattr(importlib.import_module(
        f"{pkg}.tools.tpurun"), f) for f in ("_parse_hostfile",
                                              "_assign_ranks", "_child_main")),
    # the hwloc analog (topology, binding, locality tiers): A 8
    "hwloc": lambda pkg: importlib.util.find_spec(f"{pkg}.base.hwloc")
    is not None,
    # the hook framework and hook/comm_method: A 8
    "hook": lambda pkg: importlib.util.find_spec(
        f"{pkg}.mca.hook.comm_method") is not None,
}


@pytest.mark.parametrize("what", sorted(COPIED))
def test_copied_now(what):
    """Reference behaviour the port now copies: present in both packages
    (its behaviour is held by ``test_torch_session.py``,
    ``test_torch_dpm.py``, ``test_torch_chaos.py``, ``test_torch_io.py``,
    ``test_torch_vprotocol.py``, ``test_torch_part.py``,
    ``test_torch_device_world.py``, ``test_torch_multihost_launch.py``,
    ``test_torch_hwloc.py``, ``test_torch_serving.py``,
    ``test_torch_prefix_cache.py``, ``test_torch_frontdoor.py``,
    ``test_torch_fleet.py``, ``test_torch_shmem.py``, ``test_torch_tool.py``,
    ``test_torch_debugger.py`` and ``test_torch_tools.py``)."""
    has = COPIED[what]
    assert has("ompi_tpu") and has("ompi_tpu_torch")


@pytest.mark.parametrize("what", sorted(NOT_COPIED))
def test_not_copied_yet(what):
    """Reference behaviour this slice leaves out (ROADMAP C): present in
    the JAX package, absent from the port."""
    has = NOT_COPIED[what]
    assert has("ompi_tpu") and not has("ompi_tpu_torch")
