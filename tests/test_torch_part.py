"""Partitioned communication in the port (``ompi_tpu_torch/mca/part``:
persist and pcoll, ``Comm.psend_init``/``precv_init``/``pallreduce_init``,
the ``partitioned_coll`` slot) held against the JAX package's on the CPU.

``tests/test_part.py``'s cases run on both device worlds through
``as_rank`` with the same seeded numpy inputs: the ping-pong, preadys out
of order and interleaved, mismatched partition counts, aggregation (the
same ``part_msgs`` for the same pready order), ``start_all`` of mixed
requests, the error paths (the same error classes), a seeded fuzz of
pready orders, ``PROC_NULL``, the partitioned allreduce and its
failed-dispatch rollback, the spans and counters.  Point-to-point does no
arithmetic: buffers, ``Parrived`` answers and counter deltas are compared
exactly.  The partitioned allreduce's float32 sums are compared within the
world tests' band (``torch.sum`` and XLA's psum add the ranks in other
orders: 8·2^-24 of the largest row sum); on integer-valued buckets exactly.

The port's divergences, pinned: a tensor as a partitioned buffer fails
with ``ERR_BUFFER`` as a ``jax.Array`` does; on a revoked comm the port
completes an active partitioned receive with ``RevokedError`` and a
``Pready`` raises it, where the reference leaves both pending; the port's
drain receives each wire message with ``irecv``, where the reference's
waits inside its progress callback and never receives a partition above
the eager limit over btl/tcp.  One ``-n 2`` job over btl/tcp runs the
reference's two multi-process scenarios in the port, and partitions above
the eager limit.
"""
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from test_torch_world import ring_worlds  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the world tests' band for a float32 sum over 8 ranks
BAND = 8 * 2.0 ** -24


def _ns(pkg):
    root = pkg.__name__
    mod = __import__
    errors = mod(f"{root}.api.errors", fromlist=["x"])
    status = mod(f"{root}.api.status", fromlist=["x"])
    request = mod(f"{root}.api.request", fromlist=["x"])
    var = mod(f"{root}.base.var", fromlist=["x"])
    return SimpleNamespace(
        pkg=pkg, MpiError=errors.MpiError, RevokedError=errors.RevokedError,
        ANY_SOURCE=status.ANY_SOURCE, ANY_TAG=status.ANY_TAG,
        PROC_NULL=status.PROC_NULL, start_all=request.start_all,
        waitall=request.waitall, registry=var.registry,
        spc=mod(f"{root}.runtime.spc", fromlist=["x"]),
        trace=mod(f"{root}.runtime.trace", fromlist=["x"]),
        part=mod(f"{root}.mca.part", fromlist=["x"]))


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    tw = ompi_tpu_torch.init(device="cpu")
    out = {"jax": (jw, _ns(ompi_tpu)), "torch": (tw, _ns(ompi_tpu_torch))}
    for _, ns in out.values():
        ns.part.part_framework().open()   # registers otpu_part_persist_*
    yield out
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _both(worlds, case):
    """Run ``case(world, ns)`` on both packages; the results must match."""
    got = {name: case(w, ns) for name, (w, ns) in worlds.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _minp(ns, value):
    """Set the aggregation var; returns its old value."""
    var = ns.registry.lookup("otpu_part_persist_min_partitions")
    old = var.value
    var.set(value)
    return old


def _err(ns, fn):
    """The error class ``fn`` raises, as a name (None: it did not)."""
    try:
        fn()
    except ns.MpiError as exc:
        return exc.error_class.name
    return None


# -- the reference's single-process cases ----------------------------------

def test_vars_and_component_match_the_reference(worlds):
    def case(w, ns):
        var = ns.registry.lookup("otpu_part_persist_min_partitions")
        comp = ns.part.part_framework().select()
        return (var.vtype.value, var.default, var.help, comp.name,
                comp.priority, type(ns.part.part_module()).__name__)

    got = _both(worlds, case)
    assert got[:2] == ("int", 1) and got[3:] == ("persist", 20,
                                                 "PartPersistModule")


def test_partitioned_pingpong_single_process(worlds):
    def case(w, ns):
        a, b = w.as_rank(0), w.as_rank(1)
        x = np.arange(24.0)
        y = np.zeros(24)
        s = a.psend_init(x, 4, dest=1, tag=11)
        r = b.precv_init(y, 4, source=0, tag=11)
        out = []
        for epoch in range(3):                       # restartable
            x[:] = np.arange(24.0) * (epoch + 1)
            ns.start_all([s, r])
            early = r.complete_flag
            s.pready_range(0, 3)
            s.wait()
            r.wait()
            out.append((early, y.tobytes(),
                        [r.parrived(p) for p in range(4)]))
            assert np.array_equal(y, x)
        return out

    assert all(p == [True] * 4 for _, _, p in _both(worlds, case))


def test_out_of_order_and_interleaved_pready(worlds):
    def case(w, ns):
        a, b = w.as_rank(2), w.as_rank(3)
        x = np.arange(32.0)
        y = np.zeros(32)
        s = a.psend_init(x, 8, dest=3, tag=12)
        r = b.precv_init(y, 8, source=2, tag=12)
        ns.start_all([s, r])
        s.pready_list([5, 1])
        mid = [r.parrived(p) for p in range(8)]
        part5 = y[20:24].tobytes()
        for p in (7, 6, 4, 3, 2, 0):
            s.pready(p)
        s.wait()
        r.wait()
        return mid, part5, y.tobytes(), r.parrived_range(0, 7)

    mid, part5, y, all_in = _both(worlds, case)
    assert mid[5] and mid[1] and not mid[0]
    assert part5 == np.arange(20.0, 24.0).tobytes() and all_in


@pytest.mark.parametrize("sp,rp", [(4, 3), (2, 8), (6, 1), (3, 4)])
def test_mismatched_partition_counts(worlds, sp, rp):
    def case(w, ns):
        a, b = w.as_rank(0), w.as_rank(1)
        x = np.arange(48.0)
        y = np.zeros(48)
        s = a.psend_init(x, sp, dest=1, tag=13)
        r = b.precv_init(y, rp, source=0, tag=13)
        ns.start_all([s, r])
        seen = []
        for p in np.random.RandomState(sp).permutation(sp):
            s.pready(int(p))
            seen.append([r.parrived(q) for q in range(rp)])
        s.wait()
        r.wait()
        s.free()
        r.free()
        return seen, y.tobytes()

    seen, y = _both(worlds, case)
    assert y == np.arange(48.0).tobytes() and seen[-1] == [True] * rp


def test_aggregation_counts_the_references_wire_messages(worlds):
    def case(w, ns):
        a, b = w.as_rank(4), w.as_rank(5)
        x = np.arange(64.0)
        y = np.zeros(64)
        old = _minp(ns, 4)
        try:
            s = a.psend_init(x, 8, dest=5, tag=14)
            r = b.precv_init(y, 8, source=4, tag=14)
            m0 = ns.spc.read("part_msgs")
            ns.start_all([s, r])
            for p in range(8):        # in order: one run of 4 + forced rest
                s.pready(p)
            s.wait()
            r.wait()
            first = ns.spc.read("part_msgs") - m0
            _minp(ns, 8)
            ns.start_all([s, r])
            s.pready_range(0, 6)
            held = r.parrived(0)      # whole run held below the threshold
            s.pready(7)               # the final pready flushes everything
            s.wait()
            r.wait()
            return (first, ns.spc.read("part_msgs") - m0, held,
                    [r.parrived(p) for p in range(8)], y.tobytes())
        finally:
            _minp(ns, old)

    first, total, held, arrived, _ = _both(worlds, case)
    assert (first, total, held) == (2, 3, False) and all(arrived)


def test_startall_mixed_classic_and_partitioned(worlds):
    def case(w, ns):
        a, b = w.as_rank(6), w.as_rank(7)
        xp = np.arange(16.0)
        xc = np.full(4, 7.0)
        yp = np.zeros(16)
        yc = np.zeros(4)
        sp = a.psend_init(xp, 4, dest=7, tag=15)
        sc = a.send_init(xc, dest=7, tag=16)
        rp = b.precv_init(yp, 2, source=6, tag=15)
        rc = b.recv_init(yc, source=6, tag=16)
        ns.start_all([sp, sc, rp, rc])
        sp.pready_list(range(4))
        stats = ns.waitall([sp, sc, rp, rc])
        return yp.tobytes(), yc.tobytes(), [s._nbytes for s in stats]

    yp, yc, nbytes = _both(worlds, case)
    assert yp == np.arange(16.0).tobytes() and nbytes == [128, 0, 128, 32]


def test_error_paths_raise_the_references_classes(worlds):
    def case(w, ns):
        a, b = w.as_rank(0), w.as_rank(1)
        x = np.arange(8.0)
        y = np.zeros(8)
        s = a.psend_init(x, 4, dest=1, tag=17)
        r = b.precv_init(y, 4, source=0, tag=17)
        got = [_err(ns, lambda: s.pready(0)),           # before start
               _err(ns, lambda: r.parrived(0))]         # never started
        ns.start_all([s, r])
        got += [_err(ns, lambda: s.pready(4)), _err(ns, lambda: s.pready(-1)),
                _err(ns, lambda: r.parrived(99))]
        s.pready(2)
        got += [_err(ns, lambda: s.pready(2)),          # double pready
                _err(ns, lambda: s.parrived(0)),        # wrong sides
                _err(ns, lambda: r.pready(0))]
        req = a.send_init(x, dest=1, tag=18)
        got += [_err(ns, lambda: req.pready(0)),
                _err(ns, lambda: req.parrived(0)),
                _err(ns, lambda: req.pready_range(0, 1)),
                _err(ns, lambda: req.parrived_range(0, 1))]
        s.pready_list([0, 1, 3])
        s.wait()
        r.wait()
        ro = np.arange(8.0)
        ro.setflags(write=False)
        got += [_err(ns, lambda: b.precv_init(y, 4, source=ns.ANY_SOURCE,
                                              tag=1)),
                _err(ns, lambda: a.psend_init(x, 4, dest=1, tag=ns.ANY_TAG)),
                _err(ns, lambda: a.psend_init(x, 4, dest=1, tag=1 << 20)),
                _err(ns, lambda: a.psend_init(x, 3, dest=1, tag=1)),
                _err(ns, lambda: a.psend_init(x, 0, dest=1, tag=1)),
                _err(ns, lambda: a.psend_init(x, 2.0, dest=1, tag=1)),
                _err(ns, lambda: a.psend_init([1.0, 2.0], 2, dest=1, tag=1)),
                _err(ns, lambda: a.psend_init(np.arange(16.0)[::2], 2,
                                              dest=1, tag=1)),
                _err(ns, lambda: b.precv_init(ro, 4, source=0, tag=1))]
        return got

    got = _both(worlds, case)
    assert got == ["ERR_REQUEST", "ERR_REQUEST", "ERR_ARG", "ERR_ARG",
                   "ERR_ARG", "ERR_ARG", "ERR_REQUEST", "ERR_REQUEST",
                   "ERR_REQUEST", "ERR_REQUEST", "ERR_REQUEST",
                   "ERR_REQUEST", "ERR_ARG", "ERR_TAG", "ERR_TAG",
                   "ERR_COUNT", "ERR_ARG", "ERR_ARG", "ERR_BUFFER",
                   "ERR_BUFFER", "ERR_BUFFER"]


def test_a_tensor_buffer_fails_like_a_jax_array(worlds):
    """The request keeps a live view of its buffer: a tensor (on the card
    or not) has none here and fails with ``ERR_BUFFER``, as a ``jax.Array``
    does in the reference; nothing is copied silently."""
    import jax.numpy as jnp

    def case(w, ns):
        x = torch.arange(8.0) if ns.pkg is ompi_tpu_torch \
            else jnp.arange(8.0)
        a, b = w.as_rank(0), w.as_rank(1)
        return (_err(ns, lambda: a.psend_init(x, 4, dest=1, tag=2)),
                _err(ns, lambda: b.precv_init(x, 4, source=0, tag=2)))

    assert _both(worlds, case) == ("ERR_BUFFER", "ERR_BUFFER")


@pytest.mark.parametrize("seed", [1234, 7])
def test_fuzz_random_pready_orders(worlds, seed):
    """Random partition counts (mismatched send/recv), random Pready orders
    and aggregation thresholds: every epoch's buffer, the Parrived answers
    polled mid-stream and the wire message count, in both packages."""
    def case(w, ns):
        rng = np.random.RandomState(seed)
        a, b = w.as_rank(1), w.as_rank(2)
        old = _minp(ns, 1)
        out = []
        try:
            for trial in range(12):
                sp = int(rng.randint(1, 9))
                rp = int(rng.randint(1, 9))
                unit = int(rng.randint(1, 5))
                count = sp * rp * unit
                x = rng.normal(size=count)
                y = np.zeros(count)
                _minp(ns, int(rng.randint(1, 5)))
                s = a.psend_init(x, sp, dest=2, tag=20 + trial)
                r = b.precv_init(y, rp, source=1, tag=20 + trial)
                for _ in range(int(rng.randint(1, 3))):
                    m0 = ns.spc.read("part_msgs")
                    ns.start_all([s, r])
                    order = rng.permutation(sp)
                    for p in order[:sp // 2]:
                        s.pready(int(p))
                    polled = [r.parrived(int(p))
                              for p in rng.randint(0, rp, size=3)]
                    for p in order[sp // 2:]:
                        s.pready(int(p))
                    s.wait()
                    r.wait()
                    assert np.array_equal(y, x)
                    out.append((y.tobytes(), polled,
                                ns.spc.read("part_msgs") - m0,
                                r.parrived_range(0, rp - 1)))
                s.free()
                r.free()
        finally:
            _minp(ns, old)
        return out

    assert all(done for *_, done in _both(worlds, case))


def test_proc_null_partitioned(worlds):
    def case(w, ns):
        a = w.as_rank(0)
        x = np.arange(8.0)
        m0 = ns.spc.read("part_msgs")
        s = a.psend_init(x, 4, dest=ns.PROC_NULL, tag=1)
        r = a.precv_init(np.zeros(8), 4, source=ns.PROC_NULL, tag=1)
        ns.start_all([s, r])
        st = r.wait()                 # completes immediately
        s.pready_range(0, 3)
        s.wait()
        return (r.parrived(0), st.source, st._nbytes,
                ns.spc.read("part_msgs") - m0)

    assert _both(worlds, case) == (True, -2, 0, 0)


def test_part_spans_and_counters(worlds):
    """The ``pready`` and ``part_arrive`` spans (category ``part``), the
    ``pready`` histogram and the four ``part_*`` counters, with the same
    deltas in both packages."""
    def case(w, ns):
        ns.registry.set("otpu_trace_enable", True)
        ns.trace.reset_for_testing()
        names = ("part_pready", "part_parrived", "part_msgs", "part_bytes")
        try:
            a, b = w.as_rank(0), w.as_rank(3)
            x = np.arange(16.0)
            y = np.zeros(16)
            c0 = {k: ns.spc.read(k) for k in names}
            s = a.psend_init(x, 4, dest=3, tag=19)
            r = b.precv_init(y, 4, source=0, tag=19)
            ns.start_all([s, r])
            s.pready_range(0, 3)
            s.wait()
            r.wait()
            r.parrived(2)
            delta = {k: ns.spc.read(k) - c0[k] for k in names}
            spans = sorted({(e[1], e[2]) for e in ns.trace._ring
                            if e is not None and e[2] == "part"})
            hists = sorted({k[0] for k in ns.trace.histograms()
                            if k[0] == "pready"})
            return delta, spans, hists
        finally:
            ns.registry.set("otpu_trace_enable", False)
            ns.trace.reset_for_testing()

    delta, spans, hists = _both(worlds, case)
    assert delta == {"part_pready": 4, "part_parrived": 1, "part_msgs": 4,
                     "part_bytes": 256}
    assert spans == [("part_arrive", "part"), ("pready", "part")]
    assert hists == ["pready"]


def test_wire_tags_stay_disjoint_from_the_ports_internal_spaces():
    """Part messages use ``-(1 << 21) - tag`` for tags in ``[0, 2^20)``:
    disjoint from the CID agreement's, the intercomm bridge's, the FT
    agreement's (``ft/agreement.py``) and coll/basic's spaces, and the same
    as the reference's."""
    import inspect

    from ompi_tpu.mca.part import persist as jpersist
    from ompi_tpu_torch.api import comm as tcomm
    from ompi_tpu_torch.ft import agreement
    from ompi_tpu_torch.mca.coll import basic
    from ompi_tpu_torch.mca.part import persist

    assert persist._wire_tag(0) == jpersist._wire_tag(0)
    assert persist._MAX_USER_TAG == jpersist._MAX_USER_TAG == 1 << 20
    part = (persist._wire_tag(persist._MAX_USER_TAG - 1), persist._wire_tag(0))
    assert "-(1 << 20) - tag" in inspect.getsource(tcomm)
    assert "-(1 << 22) - (int(tag) % (1 << 20))" in inspect.getsource(tcomm)
    assert "-(1 << 23) - (zlib.crc32" in inspect.getsource(agreement)
    others = {
        "cid agreement": (-(1 << 20) - ((1 << 20) - 1), -(1 << 20)),
        "intercomm bridge": (-(1 << 22) - ((1 << 20) - 1), -(1 << 22)),
        "ft agreement": (-(1 << 23) - ((1 << 20) - 1), -(1 << 23)),
        "coll/basic": (-(basic._TAG_BASE + basic._TAG_SPACE - 1),
                       -basic._TAG_BASE),
    }
    for name, (lo, hi) in others.items():
        assert hi < part[0] or lo > part[1], name


def test_a_restarted_senders_next_epoch_is_stashed(worlds):
    """A sender that restarts before the receiver does: its next epoch's
    messages wait in the pml until the matching start (never folded into
    the current one, nothing left in the stash); the drain callback sits on
    the progress engine only while an epoch is in flight."""
    def case(w, ns):
        from importlib import import_module

        progress = import_module(f"{ns.pkg.__name__}.runtime.progress")
        a, b = w.as_rank(2), w.as_rank(5)
        x = np.arange(16.0)
        y = np.zeros(16)
        s = a.psend_init(x, 4, dest=5, tag=31)
        r = b.precv_init(y, 4, source=2, tag=31)
        ns.start_all([s, r])
        s.pready_range(0, 3)
        s.wait()
        x[:] = -x                   # epoch 1's data
        s.start()
        s.pready_range(0, 3)        # epoch 1 travels before r's restart
        s.wait()
        r.wait()
        first = y.tobytes()
        registered = r._poll in progress._callbacks
        stash = sorted(ns.part.part_module()._stash.get(r._key, {}))
        r.start()
        r.wait()
        second = y.tobytes()
        r.free()
        return (first, registered, stash, second,
                r._poll in progress._callbacks)

    first, registered, stash, second, after = _both(worlds, case)
    assert first == np.arange(16.0).tobytes()
    assert second == (-np.arange(16.0)).tobytes()
    assert (registered, stash, after) == (False, [], False)


def test_revocation_completes_active_requests_divergence_pinned(worlds):
    """ULFM's revoke completes a comm's pending operations with
    ``ERR_REVOKED``.  The port does so for partitioned requests too: the
    active receive's drain completes the epoch with ``RevokedError`` at its
    next poll and leaves the progress engine, and a ``Pready`` raises it
    and completes the send epoch, so no ``wait`` spins on a revoked comm.
    The reference leaves the receive pending and sends the partition."""
    def case(w, ns):
        from importlib import import_module

        errh = import_module(f"{ns.pkg.__name__}.api.errhandler")
        progress = import_module(f"{ns.pkg.__name__}.runtime.progress")
        c = w.dup()
        c.set_errhandler(errh.ERRORS_RETURN)
        a, b = c.as_rank(0), c.as_rank(1)
        s = a.psend_init(np.arange(8.0), 4, dest=1, tag=3)
        r = b.precv_init(np.zeros(8), 4, source=0, tag=3)
        ns.start_all([s, r])
        s.pready(0)
        c.revoke()
        try:
            r.wait(timeout=0.5)
            recv = "COMPLETED"
        except ns.RevokedError:
            recv = "REVOKED"
        except TimeoutError:
            recv = "PENDING"
        try:
            s.pready(1)
            send = "SENT"
        except ns.RevokedError:
            send = "REVOKED"
        drained = r._poll not in progress._callbacks
        r.free()
        return recv, send, drained, s.complete_flag

    got = {name: case(w, ns) for name, (w, ns) in worlds.items()}
    assert got == {"torch": ("REVOKED", "REVOKED", True, True),
                   "jax": ("PENDING", "SENT", False, False)}


# -- the partitioned allreduce (pcoll, the partitioned_coll slot) ----------

def test_pallreduce_init_matches_the_reference(worlds):
    """Each bucket bound once, released late-first; every bucket's result
    against the reference's, then a rebind with fresh buckets (integer
    valued: exact)."""
    def case(w, ns):
        n = w.size
        buckets = [np.full((n, 4), float(i + 1), np.float32)
                   for i in range(3)]
        if ns.pkg is ompi_tpu_torch:
            buckets = [torch.from_numpy(b) for b in buckets]
        req = w.pallreduce_init(buckets)
        req.start()
        arrived = []
        for i in (2, 1, 0):                     # late bucket first
            before = req.parrived(i - 1) if i else None
            req.pready(i)
            # the reference's dispatch is asynchronous: it arrives later
            arrived.append((before, any(req.parrived(i)
                                        for _ in range(2000))))
        req.wait()
        first = [np.asarray(r).tolist() for r in req.result]
        req.start([b * 2 for b in buckets])
        errs = [_err(ns, lambda: req.pready(3))]
        req.pready_range(0, 2)
        errs.append(_err(ns, lambda: req.pready(1)))   # double release
        req.wait()
        second = [np.asarray(r).tolist() for r in req.result]
        return arrived, first, errs, second

    arrived, first, errs, second = _both(worlds, case)
    assert arrived == [(False, True), (False, True), (None, True)]
    assert errs == ["ERR_ARG", "ERR_REQUEST"]   # the epoch had completed
    assert np.asarray(second[2]).ravel()[0] == 6 * 8


def test_parrived_on_the_cpu_is_true_once_pready_returns(worlds):
    """On the CPU a bucket's result is ready when ``pready`` returns, and
    ``result[i]`` stays a tensor (on the card ``parrived`` queries the CUDA
    event recorded after the launch)."""
    w, _ = worlds["torch"]
    req = w.pallreduce_init([torch.ones(8, 4), torch.ones(8, 2)])
    req.start()
    req.pready(1)
    assert req.parrived(1) and not req.parrived(0)
    assert req._events == [None, None]
    req.pready(0)
    assert req.parrived(0) and req.complete_flag
    assert all(isinstance(r, torch.Tensor) and r.device.type == "cpu"
               for r in req.result)


def test_pallreduce_matches_the_reference_within_the_band(worlds):
    rng = np.random.RandomState(7)
    buckets = [rng.normal(size=(8, 8)).astype(np.float32) for _ in range(4)]
    got = {}
    for name, (w, ns) in worlds.items():
        bs = [torch.from_numpy(b) for b in buckets] \
            if ns.pkg is ompi_tpu_torch else buckets
        req = w.pallreduce_init(bs)
        req.start()
        req.pready_list(range(4))
        req.wait()
        got[name] = [np.asarray(r, np.float64) for r in req.result]
        if ns.pkg is ompi_tpu_torch:
            assert all(isinstance(r, torch.Tensor) for r in req.result)
            # the bucket's one-shot allreduce through the same slot: bit
            # for bit
            for b, r in zip(bs, req.result):
                assert torch.equal(w.allreduce_array(b), r)
    for b, j, t in zip(buckets, got["jax"], got["torch"]):
        scale = np.abs(b.astype(np.float64)).sum(0).max()
        np.testing.assert_allclose(t, j, rtol=0, atol=BAND * scale)


def test_pallreduce_failed_dispatch_does_not_wedge(worlds):
    """A pready whose dispatch raises (a rebind whose bucket mismatches the
    bound template: the port's handle check raises ``ERR_BUFFER`` before
    anything is launched) must NOT release the bucket: a retry raises the
    same error, not 'already released', and the request stays freeable and
    restartable."""
    def case(w, ns):
        n = w.size
        good = [np.ones((n, 4), np.float32)]
        bad = [np.ones((n + 1, 4), np.float32)]
        if ns.pkg is ompi_tpu_torch:
            good = [torch.from_numpy(good[0])]
            bad = [torch.from_numpy(bad[0])]
        req = w.pallreduce_init(good)
        req.start(bad)
        msgs = []
        for _ in range(2):
            with pytest.raises(Exception) as exc:
                req.pready(0)
            msgs.append(str(exc.value))
        req.free()
        req.start(good)
        req.pready(np.int64(0))                      # numpy index accepted
        req.wait()
        return (msgs[0] == msgs[1],
                any("already released" in m for m in msgs),
                np.asarray(req.result[0]).ravel()[0].item())

    assert _both(worlds, case) == (True, False, 8.0)


def test_pallreduce_on_a_host_comm_runs_the_blocking_allreduce():
    """Without a ``partitioned_coll`` slot (a comm between processes) each
    ``pready`` runs the comm's host allreduce: a stand-in comm records the
    calls in both packages."""
    from ompi_tpu.mca.part.pcoll import PartitionedCollRequest as JReq
    from ompi_tpu_torch.mca.part.pcoll import PartitionedCollRequest as TReq

    class HostComm:
        cid = 5

        def __init__(self):
            self.calls = []

        def allreduce(self, x, op):
            self.calls.append((x.tolist(), op))
            return x * 3

    got = []
    for cls in (TReq, JReq):
        c = HostComm()
        req = cls(c, "allreduce", [np.ones(2), np.zeros(3)], ("SUM",))
        req.start()
        req.pready(1)
        req.pready(0)
        req.wait()
        got.append((c.calls, [r.tolist() for r in req.result],
                    req.parrived(0), req.status._nbytes))
    assert got[0] == got[1]
    assert got[0][0] == [([0.0] * 3, "SUM"), ([1.0] * 2, "SUM")]


# -- the reference's multi-process cases, in the port ----------------------

PART_JOB = textwrap.dedent("""
    import json, sys
    import numpy as np
    import ompi_tpu_torch as m
    from ompi_tpu_torch.runtime import spc

    w = m.init(device="cpu")
    out = {"rank": w.rank}
    # the reference's ping-pong: 8 sender partitions, 4 receiver partitions
    # (mismatched), out of order, two epochs
    parts = 8
    x = np.arange(64.0) + 100 * w.rank
    y = np.zeros(64)
    if w.rank == 0:
        s = w.psend_init(x, parts, dest=1, tag=3)
        r = w.precv_init(y, 4, source=1, tag=4)
    else:
        r = w.precv_init(y, 4, source=0, tag=3)
        s = w.psend_init(x, parts, dest=0, tag=4)
    ok = []
    for epoch in range(2):
        x[:] = np.arange(64.0) + 100 * w.rank + epoch
        if w.rank == 0:
            s.start()
            for p in (5, 0, 7, 2, 1, 6, 3, 4):
                s.pready(p)
            s.wait()
            r.start(); r.wait()
        else:
            r.start(); r.wait()
            s.start()
            for p in range(parts):
                s.pready(p)
            s.wait()
        want = np.arange(64.0) + 100 * (1 - w.rank) + epoch
        ok.append(bool(np.array_equal(y, want))
                  and all(r.parrived(p) for p in range(4)))
    out["pingpong"] = ok
    # the reference's aggregated transfer (min_partitions 4 on the job)
    x = np.arange(256.0)
    y = np.zeros(256)
    if w.rank == 0:
        s = w.psend_init(x, 16, dest=1, tag=2)
        m0 = spc.read("part_msgs")
        s.start()
        for p in range(16):
            s.pready(p)
        s.wait()
        out["msgs"] = spc.read("part_msgs") - m0
    else:
        r = w.precv_init(y, 8, source=0, tag=2)
        r.start()
        r.wait()
        out["agg"] = bool(np.array_equal(y, x)) and all(
            r.parrived(p) for p in range(8))
    # partitions above the eager limit (rendezvous): 4 MB in 16 partitions
    # of 256 KB, readied out of order, two epochs
    x = np.arange(1 << 19, dtype=np.float64)
    y = np.zeros(1 << 19)
    big = []
    if w.rank == 0:
        s = w.psend_init(x, 16, dest=1, tag=6)
    else:
        r = w.precv_init(y, 16, source=0, tag=6)
    for epoch in range(2):
        x[:] = np.arange(1 << 19, dtype=np.float64) * (epoch + 2)
        if w.rank == 0:
            s.start()
            for p in np.random.RandomState(epoch).permutation(16):
                s.pready(int(p))
            s.wait()
        else:
            r.start()
            r.wait()
            big.append(bool(np.array_equal(y, x)))
    out["rendezvous"] = big
    out["btl"] = w.pml.bml.endpoint(1 - w.rank).btl.name
    print("PART " + json.dumps(out), flush=True)
    m.finalize()
""")


def test_partitioned_jobs_over_tcp(tmp_path):
    """``test_part.py``'s two multi-process cases in one ``-n 2`` job of
    the port (``--mca btl tcp,self --mca part_persist_min_partitions 4``):
    mismatched counts and out-of-order preadys over two epochs, and 16
    partitions in 4 wire messages, the reference's count; then partitions
    above the eager limit.  The reference's drain waits for each message
    inside its progress callback, where progress does not recurse, so a
    rendezvous partition never arrives over tcp and its job hangs (pinned
    below); the port's drain receives with ``irecv``."""
    import json

    script = tmp_path / "part_job.py"
    script.write_text(PART_JOB)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", "2",
         "--mca", "btl", "tcp,self", "--mca", "part_persist_min_partitions",
         "4", sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = sorted((json.loads(ln.split("PART ", 1)[1])
                  for ln in r.stdout.splitlines() if "PART " in ln),
                 key=lambda d: d["rank"])
    assert got == [{"rank": 0, "pingpong": [True, True], "msgs": 4,
                    "rendezvous": [], "btl": "tcp"},
                   {"rank": 1, "pingpong": [True, True], "agg": True,
                    "rendezvous": [True, True], "btl": "tcp"}]


def test_the_drain_never_waits_inside_progress_divergence_pinned():
    """The divergence behind the job above: the reference's drain receives
    a probed message with the blocking ``msg.recv``; the port's with
    ``msg.irecv`` and lands it at the receive's completion."""
    import inspect

    from ompi_tpu.mca.part import persist as jpersist
    from ompi_tpu_torch.mca.part import persist

    ref = inspect.getsource(jpersist.PrecvRequest._poll)
    port = inspect.getsource(persist.PrecvRequest._poll)
    assert "msg.recv(buf)" in ref and "msg.irecv(buf)" not in ref
    assert "msg.irecv(buf)" in port and "msg.recv(" not in port


def test_pallreduce_slot_stays_builtins_with_the_ring_raised(ring_worlds):
    """The ``partitioned_coll`` slot is coll/builtin's, also with coll/ring
    raised (only coll/xla has it in the reference, never coll/pallas), so
    a ``pready`` launches no ring kernel: K3 and K4's plain twins are never
    called on the CPU."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    jw, tw = ring_worlds
    assert type(tw.c_coll["allreduce_array"].__self__).__name__ == \
        "RingCollModule"
    assert type(tw.c_coll["partitioned_coll"].__self__).__name__ == \
        "BuiltinCollModule"
    assert type(jw.c_coll["partitioned_coll"].__self__).__name__ == \
        "XlaCollModule"
    before = dict(rc.launches)
    buckets = [torch.ones(8, 1024), torch.ones(8, 64)]
    req = tw.pallreduce_init(buckets)
    req.start()
    req.pready_list([1, 0])
    req.wait()
    assert dict(rc.launches) == before
    for b, r in zip(buckets, req.result):
        assert torch.equal(r, b.sum(0))


def test_typestate_table_matches_the_reference_and_names_the_ports_calls():
    """The request automaton's table is the reference's, key for key, and
    every call it names exists in the port: a ``Comm`` method for the
    constructors, a ``Request`` method or a module function of
    ``api/request.py`` for the rest."""
    from ompi_tpu.api import request as jrequest
    from ompi_tpu_torch.api import request as trequest
    from ompi_tpu_torch.api.comm import Comm

    assert trequest._TYPESTATE == jrequest._TYPESTATE
    table = trequest._TYPESTATE
    for key in ("create_inactive", "create_active", "send_side",
                "partitioned"):
        assert all(callable(getattr(Comm, op, None)) for op in table[key])
    for key in ("start", "start_many", "complete", "complete_many", "free",
                "pready", "parrived"):
        assert all(callable(getattr(trequest.Request, op, None))
                   or callable(getattr(trequest, op, None))
                   for op in table[key]), key
