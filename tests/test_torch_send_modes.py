"""The send modes (ssend, bsend, rsend) and persistent point-to-point of
the port's device world on the CPU lane, held against the JAX package's:
``tests/test_send_modes.py``'s seven cases, each run on both worlds with
the same seeded numpy inputs and compared exactly (buffers, statuses,
completion flags, error classes).
"""
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch


def _ns(pkg):
    root = pkg.__name__
    mod = __import__
    request = mod(f"{root}.api.request", fromlist=["x"])
    return SimpleNamespace(
        pkg=pkg,
        MpiError=mod(f"{root}.api.errors", fromlist=["x"]).MpiError,
        buffer=mod(f"{root}.api.buffer", fromlist=["x"]),
        startall=request.startall, waitall=request.waitall,
        progress=mod(f"{root}.runtime.progress", fromlist=["x"]).progress)


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    both = {"jax": (jw, _ns(ompi_tpu)),
            "torch": (ompi_tpu_torch.init(device="cpu"), _ns(ompi_tpu_torch))}
    yield both
    jrt.reset_for_testing()
    trt.reset_for_testing()
    for _, ns in both.values():
        ns.buffer.reset_for_testing()


def _st(st):
    return (st.source, st.tag, int(st.error), st._nbytes, st.is_cancelled())


def _both(worlds, case):
    got = {name: case(w, ns) for name, (w, ns) in worlds.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _data(seed, n):
    return np.random.default_rng(seed).standard_normal(n)


def test_issend_completes_only_on_match(worlds):
    def case(w, ns):
        s, r = w.as_rank(0), w.as_rank(1)
        req = s.issend(_data(1, 1), dest=1, tag=9)
        for _ in range(50):
            ns.progress()
        early = req.complete_flag      # must not complete before the recv
        buf = np.zeros(1)
        rr = r.irecv(buf, source=0, tag=9)
        req.wait()
        return early, _st(rr.wait()), buf.tobytes()

    assert _both(worlds, case)[0] is False


def test_blocking_ssend(worlds):
    def case(w, ns):
        s, r = w.as_rank(2), w.as_rank(3)
        buf = np.zeros(2)
        rr = r.irecv(buf, source=2, tag=4)
        s.ssend(_data(2, 2), dest=3, tag=4)
        return _st(rr.wait()), buf.tobytes()

    assert _both(worlds, case)[1] == _data(2, 2).tobytes()


def test_bsend_requires_attach(worlds):
    def case(w, ns):
        ns.buffer.reset_for_testing()
        with pytest.raises(ns.MpiError) as ei:
            w.as_rank(0).bsend(np.array([1.0]), dest=1, tag=1)
        return ei.value.error_class.name

    assert _both(worlds, case) == "ERR_BUFFER"


def test_bsend_roundtrip_and_capacity(worlds):
    def case(w, ns):
        ns.buffer.attach(1 << 16)
        try:
            s, r = w.as_rank(4), w.as_rank(5)
            msg = _data(3, 16)
            s.bsend(msg, dest=5, tag=7)
            msg[:] = -1           # the caller may clobber after return
            buf = np.zeros(16)
            st = r.recv(buf, source=4, tag=7)
            # exhausting the buffer raises ERR_BUFFER
            with pytest.raises(ns.MpiError) as ei:
                s.bsend(np.zeros(1 << 16, np.uint8), dest=5, tag=8)
            # a persistent buffered send claims space at every start
            sreq = s.bsend_init(_data(4, 4), dest=5, tag=9)
            got = []
            for _ in range(2):
                sreq.start()
                sreq.wait()
                b = np.zeros(4)
                r.recv(b, source=4, tag=9)
                got.append(b.tobytes())
            return _st(st), buf.tobytes(), ei.value.error_class.name, got
        finally:
            ns.buffer.detach()

    got = _both(worlds, case)
    assert got[1] == _data(3, 16).tobytes() and got[2] == "ERR_BUFFER"


def test_detach_returns_buffer(worlds):
    def case(w, ns):
        arr = np.zeros(4096, np.uint8)
        ns.buffer.attach(arr)
        return ns.buffer.detach() is arr

    assert _both(worlds, case) is True


def test_send_recv_init_restartable(worlds):
    def case(w, ns):
        s, r = w.as_rank(6), w.as_rank(7)
        src, dst = np.zeros(1), np.zeros(1)
        sreq = s.send_init(src, dest=7, tag=11)
        rreq = r.recv_init(dst, source=6, tag=11)
        seen = [_st(rreq.wait())]      # inactive: the empty status
        for i in range(3):
            src[0] = 10.0 + i
            ns.startall([sreq, rreq])
            seen += [_st(s) for s in ns.waitall([sreq, rreq])]
            seen.append(dst.tobytes())
        ns.startall([rreq])
        with pytest.raises(ns.MpiError) as ei:   # start while active
            rreq.start()
        src[0] = 99.0
        sreq.start()
        ns.waitall([sreq, rreq])
        rs = s.rsend_init(np.array([5.0]), dest=7, tag=12)
        rs.start()
        rb = np.zeros(1)
        seen.append(_st(r.recv(rb, source=6, tag=12)))
        rs.wait()
        return seen, ei.value.error_class.name, dst.tobytes(), rb.tobytes()

    _, err, last, rb = _both(worlds, case)
    assert err == "ERR_REQUEST" and np.frombuffer(last)[0] == 99.0
    assert np.frombuffer(rb)[0] == 5.0


def test_ssend_init(worlds):
    def case(w, ns):
        s, r = w.as_rank(0), w.as_rank(2)
        dst = np.zeros(1)
        sreq = s.ssend_init(np.array([5.0]), dest=2, tag=21)
        sreq.start()
        for _ in range(50):
            ns.progress()
        early = sreq.complete_flag     # sync: needs the match
        rr = r.irecv(dst, source=0, tag=21)
        sreq.wait()
        return early, _st(rr.wait()), dst.tobytes()

    assert _both(worlds, case)[0] is False
