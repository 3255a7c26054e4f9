"""PERUSE (``runtime/peruse.py``) and the memchecker
(``runtime/memchecker.py``) of the port, with their hooks in pml/ob1, held
against the JAX package's.

In the device world (the reference's 8-device CPU mesh, the port's CPU
lane) the same point-to-point program — a message matched out of the
unexpected queue, one matching a posted receive, a synchronous (rendezvous)
send, the emulated RGET pull, a wildcard receive and a truncation — fires
the same PERUSE events with the same info in the same order, for an
any-communicator subscription and for one scoped to a communicator.  With
the memchecker on, a racy write to a numpy send buffer of a rendezvous or
an RGET send raises at the write in both packages, and the buffer is
writable again once the send completes.  A tensor send buffer is not
guarded in the port (it is staged to the host at the send's entry and has
no read-only flag); the reference's ``jax.Array`` cannot be written at all.
"""
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.runtime import memchecker as jmem
from ompi_tpu.runtime import peruse as jperuse
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.runtime import memchecker as tmem
from ompi_tpu_torch.runtime import peruse as tperuse

PERUSE = {"jax": jperuse, "torch": tperuse}
REG = {"jax": jreg, "torch": treg}


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": jw, "torch": ompi_tpu_torch.init(device="cpu")}
    for p in PERUSE.values():
        p.reset()
    jrt.reset_for_testing()
    trt.reset_for_testing()


@pytest.fixture
def small_self_eager(worlds, monkeypatch):
    """btl/self with a 4 KB eager limit and ob1's RGET pull emulation on,
    in both packages: a 1 MB send takes the RGET rung in the device
    world."""
    for w in worlds.values():
        monkeypatch.setattr(w.pml.bml.endpoint(1).btl, "eager_limit", 4096)
    for reg in REG.values():
        reg.set("otpu_pml_ob1_rget_emulate", True)
    yield
    for reg in REG.values():
        reg.set("otpu_pml_ob1_rget_emulate", False)


def _both(fn):
    got = {name: fn(name) for name in PERUSE}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_event_table_is_the_references():
    assert tperuse.EVENTS == jperuse.EVENTS
    assert tperuse.ANY_COMM == jperuse.ANY_COMM
    for name in tperuse.EVENTS:
        assert getattr(tperuse, name) == getattr(jperuse, name) == name


def test_unknown_event_raises():
    def run(name):
        with pytest.raises(ValueError) as ei:
            PERUSE[name].subscribe("NOT_AN_EVENT", lambda *a, **k: None)
        return str(ei.value)

    assert "unknown PERUSE event" in _both(run)


def test_subscription_lifecycle_and_a_raising_callback():
    def run(name):
        p = PERUSE[name]
        p.reset()
        seen = []
        h1 = p.subscribe(p.MSG_ARRIVED, lambda e, c, **i: 1 / 0)
        h2 = p.subscribe(p.MSG_ARRIVED, lambda e, c, **i: seen.append(
            (e, c, sorted(i.items()))))
        out = [p.active()]
        p.fire(p.MSG_ARRIVED, 7, source=1, tag=2)      # 1/0 is swallowed
        h1.release()
        out.append(p.active())
        p.unsubscribe(h2)
        out.append(p.active())
        p.fire(p.MSG_ARRIVED, 7, source=1, tag=3)      # inactive: nothing
        return out, seen

    assert _both(run) == ([True, True, False],
                          [("MSG_ARRIVED", 7, [("source", 1), ("tag", 2)])])


def p2p_program(w, rng) -> list:
    """Point-to-point calls on a device world through ``as_rank``; returns
    the received payloads."""
    got = []
    a = rng.standard_normal(5)
    w.as_rank(2).send(a, dest=6, tag=1)                 # unexpected first
    buf = np.zeros(5)
    w.as_rank(6).recv(buf, source=2, tag=1)
    got.append(buf.tolist())
    buf = np.zeros(3)
    req = w.as_rank(1).irecv(buf, source=0, tag=4)      # posted first
    w.as_rank(0).send(np.arange(3.0), dest=1, tag=4)
    req.wait()
    got.append(buf.tolist())
    big = rng.standard_normal(64)
    sreq = w.as_rank(3).issend(big, dest=5, tag=8)      # rendezvous
    buf = np.zeros(64)
    w.as_rank(5).recv(buf, source=ompi_any(w), tag=8)   # wildcard source
    sreq.wait()
    got.append(float(buf.sum()))
    w.as_rank(4).send(np.arange(6.0), dest=7, tag=2)    # truncation
    small = np.zeros(2)
    try:
        w.as_rank(7).recv(small, source=4, tag=2)
    except Exception as exc:
        got.append(type(exc).__name__)
    return got


def ompi_any(w):
    root = type(w).__module__.split(".")[0]
    return __import__(f"{root}.api.status", fromlist=["x"]).ANY_SOURCE


def _events(name, w, scoped: bool, extra=None):
    p = PERUSE[name]
    p.reset()
    seen = []
    comm = w.dup() if scoped else None
    target = comm if scoped else w
    for ev in p.EVENTS:
        p.subscribe(ev, lambda e, c, **i: seen.append(
            (e, c if not scoped else "scoped", sorted(i.items()))),
            comm=comm)
    got = p2p_program(target, np.random.default_rng(21))
    if extra is not None:
        got.append(extra(target))
    p.reset()
    if scoped:
        # a subscription scoped to the dup sees nothing of the world's
        p.subscribe(p.MSG_ARRIVED, lambda e, c, **i: seen.append("world"),
                    comm=comm)
        w.as_rank(0).send(np.zeros(1), dest=1, tag=0)
        w.as_rank(1).recv(np.zeros(1), source=0, tag=0)
        p.reset()
        comm.free()
    return got, seen


@pytest.mark.parametrize("scoped", [False, True])
def test_event_sequence_matches(worlds, scoped):
    got, seen = _both(lambda name: _events(name, worlds[name], scoped))
    kinds = [e[0] for e in seen]
    assert kinds.count("REQ_ACTIVATE") == kinds.count("REQ_COMPLETE") == 8
    assert {"MSG_INSERT_IN_UNEX_Q", "REQ_MATCH_UNEX", "MSG_MATCH_POSTED_REQ",
            "REQ_INSERT_IN_POSTED_Q", "REQ_XFER_END"} <= set(kinds)
    assert "world" not in seen
    assert got[-1] == "MpiError"


def _rget(w):
    """A 1 MB message on the RGET rung, received after it was sent."""
    x = np.random.default_rng(22).standard_normal(1 << 17)
    req = w.as_rank(2).isend(x, dest=3, tag=6)
    buf = np.zeros_like(x)
    w.as_rank(3).recv(buf, source=2, tag=6)
    req.wait()
    return bool(np.array_equal(buf, x))


def test_rget_event_sequence_matches(worlds, small_self_eager):
    got, seen = _both(lambda name: _events(name, worlds[name], False,
                                           extra=_rget))
    assert got[-1] is True
    kinds = [e[0] for e in seen]
    assert kinds.count("REQ_ACTIVATE") == kinds.count("REQ_COMPLETE") == 10


# -- memchecker ----------------------------------------------------------

@pytest.fixture
def memcheck():
    for reg in REG.values():
        reg.set("otpu_memchecker_enable", True)
    yield
    for reg in REG.values():
        reg.set("otpu_memchecker_enable", False)


def test_memchecker_var_is_the_references():
    assert tmem._enable_var.name == jmem._enable_var.name
    assert tmem.enabled() is jmem.enabled() is False


def test_racy_write_to_a_rendezvous_buffer_raises(worlds, memcheck):
    def run(name):
        w = worlds[name]
        x = np.arange(16.0)
        req = w.as_rank(0).issend(x, dest=1, tag=3)
        out = [x.flags.writeable]
        with pytest.raises(ValueError) as ei:
            x[0] = -1.0                          # the race, caught here
        out.append("read-only" in str(ei.value))
        buf = np.zeros(16)
        w.as_rank(1).recv(buf, source=0, tag=3)
        req.wait()
        out.append(x.flags.writeable)
        x[0] = -1.0                              # completed: writable
        out.append(buf.tolist() == list(np.arange(16.0)))
        return out

    assert _both(run) == [False, True, True, True]


def test_racy_write_to_an_rget_buffer_raises(worlds, memcheck,
                                             small_self_eager):
    def run(name):
        w = worlds[name]
        x = np.random.default_rng(23).standard_normal(1 << 17)
        want = x.copy()
        req = w.as_rank(4).isend(x, dest=5, tag=7)
        out = [x.flags.writeable]
        with pytest.raises(ValueError):
            x[7] = 0.0
        buf = np.zeros_like(x)
        w.as_rank(5).recv(buf, source=4, tag=7)
        req.wait()
        out += [x.flags.writeable, bool(np.array_equal(buf, want))]
        return out

    assert _both(run) == [False, True, True]


def test_eager_and_disabled_sends_are_not_frozen(worlds):
    def run(name):
        w = worlds[name]
        out = []
        for on in (True, False):
            REG[name].set("otpu_memchecker_enable", on)
            x = np.arange(4.0)
            w.as_rank(0).send(x, dest=1, tag=1)          # eager: copied
            out.append(x.flags.writeable)
            y = np.arange(4.0)
            req = w.as_rank(0).issend(y, dest=1, tag=2)
            out.append(y.flags.writeable)
            w.as_rank(1).recv(np.zeros(4), source=0, tag=1)
            w.as_rank(1).recv(np.zeros(4), source=0, tag=2)
            req.wait()
        REG[name].set("otpu_memchecker_enable", False)
        return out

    assert _both(run) == [True, False, True, True]


def test_a_tensor_send_buffer_is_not_guarded_divergence_pinned(worlds,
                                                               memcheck):
    """The port's rule is the reference's (numpy only): a tensor send
    buffer stays writable while its rendezvous is in flight, and the
    message carries the bytes staged at the send's entry."""
    w = worlds["torch"]
    t = torch.arange(8, dtype=torch.float64)
    req = w.as_rank(0).issend(t, dest=1, tag=5)
    t[0] = 100.0                                  # no guard: allowed
    buf = np.zeros(8)
    w.as_rank(1).recv(buf, source=0, tag=5)
    req.wait()
    assert buf.tolist() == list(np.arange(8.0))
