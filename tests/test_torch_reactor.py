"""The port's native progress reactor (``runtime/reactor.py`` over the
epoll loop of ``ompi_tpu_torch/native``) held against btl/tcp's pure-Python
receive lane and against the JAX package's.

- the differential fuzz of ``tests/test_reactor.py``, run against the port:
  the same byte streams (fast, pickle and crc-armed headers), split at the
  same fuzzed boundaries, give the same frag stream through the port's
  native lane, the port's ``_drain`` and ``_on_bytes`` and the reference's
  ``_on_bytes``;
- lane routing: any frame that is not a plain fast header reaches Python as
  a verbatim RAW record;
- the record plumbing: doorbell drain, writability, oversize parking, EOF,
  desync, the wait fd waking ``progress.idle_wait``;
- engagement gating: ``otpu_progress_native=0`` and the sanitizer keep the
  reactor off.

The cases need the native core (g++); they skip with a reason otherwise."""
import pickle
import random
import socket
import struct
import threading
import time
import zlib
from functools import partial

import numpy as np
import pytest

from ompi_tpu.mca.btl import tcp as jtcp
from ompi_tpu.mca.btl.base import Frag as JFrag
from ompi_tpu_torch.mca.btl import tcp as tcp_mod
from ompi_tpu_torch.mca.btl.base import CTL, FRAG, MATCH, RNDV, Frag
from ompi_tpu_torch.runtime import progress, reactor, sanitizer

_LEN = tcp_mod._LEN
_FAST = tcp_mod._FAST
_CKSUM = tcp_mod._CKSUM


@pytest.fixture(autouse=True)
def needs_reactor():
    """Decided per test, not at import: building the core is a side
    effect no import should have."""
    if not reactor.available():
        pytest.skip("the native core (and its reactor) is not built here: "
                    "no g++")


@pytest.fixture
def clean_engine():
    """Each test leaves the process-wide reactor and progress engine as it
    found them."""
    yield
    progress.reset_for_testing()


def encode(frag, cksum: bool = False) -> bytes:
    """Wire-encode one fragment the way ``TcpBtl.send`` frames it (plus the
    crc-armed variant)."""
    payload = memoryview(np.ascontiguousarray(frag.data)).cast("B")
    hdr = tcp_mod._fast_header(frag)
    if hdr is not None:
        htype = tcp_mod._H_FAST
    else:
        hdr = pickle.dumps(
            (frag.cid, frag.src, frag.dst, frag.tag, frag.seq, frag.kind,
             frag.total_len, frag.offset, frag.meta),
            protocol=pickle.HIGHEST_PROTOCOL)
        hdr = _LEN.pack(len(hdr)) + hdr
        htype = tcp_mod._H_PICKLE
    if cksum:
        crc = zlib.crc32(payload, zlib.crc32(hdr))
        fl = 1 + _CKSUM.size + len(hdr) + len(payload)
        return (_LEN.pack(fl) + bytes((htype | tcp_mod._H_CK_BASE,))
                + _CKSUM.pack(crc) + hdr + bytes(payload))
    fl = 1 + len(hdr) + len(payload)
    return _LEN.pack(fl) + bytes((htype,)) + hdr + bytes(payload)


def mixed_frags(rng: random.Random, n=32) -> list:
    """(frag, crc-armed) pairs alternating fast, pickle and crc lanes."""
    frags = []
    for i in range(n):
        payload = np.frombuffer(
            bytes(rng.randrange(256) for _ in range(rng.randrange(0, 300))),
            np.uint8)
        pick = i % 4
        if pick == 0:       # eager MATCH, empty meta -> fast lane
            f = Frag(3, 0, 1, rng.randrange(1000), i, MATCH, payload,
                     total_len=len(payload))
        elif pick == 1:     # FRAG continuation -> fast lane (req_id)
            f = Frag(3, 1, 0, -1, 0, FRAG, payload, total_len=1 << 20,
                     offset=rng.randrange(1 << 20),
                     meta={"req_id": rng.randrange(1 << 40)})
        elif pick == 2:     # RNDV rich meta -> pickle (RAW lane)
            f = Frag(3, 0, 1, rng.randrange(1000), i, RNDV, payload,
                     total_len=len(payload) + 512,
                     meta={"req_id": i, "window": [1, 2]})
        else:               # CTL proto -> pickle (RAW lane)
            f = Frag(3, 1, 0, -1, 0, CTL, payload,
                     meta={"proto": "ob1_rget_done", "req_id": i})
        frags.append((f, pick == 3 and i % 8 == 7 or i % 5 == 4))
    return frags


def owned(frag) -> tuple:
    return (frag.cid, frag.src, frag.dst, frag.tag, frag.seq, frag.kind,
            frag.total_len, frag.offset, dict(frag.meta),
            bytes(memoryview(np.ascontiguousarray(frag.data))))


def chunks(stream: bytes, rng: random.Random):
    pos = 0
    while pos < len(stream):
        step = rng.choice((1, 2, 3, 5, 7, 13, 64, 1024))
        yield stream[pos:pos + step]
        pos += step


def stream_pair():
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(True)
    return a, b


def drain_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        reactor.drain()
        time.sleep(0.002)
    assert cond(), "reactor records did not arrive in time"


def selector_lane(mod, stream: bytes, seed: int, on_bytes: bool) -> list:
    """The frag stream ``mod``'s pure-Python receive lane delivers for
    ``stream`` cut by the seeded chunker: ``_on_bytes`` (zero-copy views
    of the recv scratch) or ``_drain`` (the reassembly buffer)."""
    btl = mod.TcpBtl()
    got = []
    btl.set_recv_callback(lambda f: got.append(owned(f)))
    conn = mod._Conn(None, rank=7)
    for chunk in chunks(stream, random.Random(seed)):
        if on_bytes:
            btl._on_bytes(conn, memoryview(bytearray(chunk)))
        else:
            conn.inbuf += chunk
            btl._drain(conn)
    assert not conn.inbuf
    return got


def native_lane(stream: bytes, seed: int) -> list:
    """The frag stream the port's native reactor lane delivers for
    ``stream`` written to a socket in the seeded chunks."""
    assert reactor.engage()
    a, b = stream_pair()
    btl = tcp_mod.TcpBtl()
    got = []
    btl.set_recv_callback(lambda f: got.append(owned(f)))
    conn = tcp_mod._Conn(a, rank=7)
    conn.fd = a.fileno()
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       partial(btl._reactor_event, conn))
    parts = list(chunks(stream, random.Random(seed)))

    def feed():
        for part in parts:
            b.sendall(part)
            if len(part) < 8:
                time.sleep(0)    # let the epoll thread see odd splits
        b.close()

    t = threading.Thread(target=feed)
    t.start()
    drain_until(lambda: len(got) >= expected_frames(stream))
    t.join()
    reactor.remove(a.fileno())
    a.close()
    return got


def expected_frames(stream: bytes) -> int:
    n, pos = 0, 0
    while pos < len(stream):
        (fl,) = _LEN.unpack_from(stream, pos)
        pos += _LEN.size + fl
        n += 1
    return n


@pytest.mark.parametrize("seed", range(4))
def test_differential_fuzz_native_pure_and_reference(clean_engine, seed):
    """The acceptance fuzz: one stream of fast, pickle and crc-armed
    frames, split at fuzzed boundaries, gives the same frag stream through
    the port's native lane, its ``_drain`` and ``_on_bytes`` lanes, and the
    reference's ``_on_bytes`` (whose frags are JAX-package Frags of the
    same fields)."""
    frags = mixed_frags(random.Random(seed))
    stream = b"".join(encode(f, cksum=ck) for f, ck in frags)
    want = [owned(f) for f, _ in frags]
    assert selector_lane(jtcp, stream, seed, on_bytes=True) == want
    assert selector_lane(tcp_mod, stream, seed, on_bytes=True) == want
    assert selector_lane(tcp_mod, stream, seed + 50, on_bytes=False) == want
    assert native_lane(stream, seed + 1000) == want


def test_the_encoders_are_the_references():
    """The port frames a fragment into the reference's bytes: the same
    fast header, pickle header and crc variant."""
    rng = random.Random(7)
    for f, ck in mixed_frags(rng, n=16):
        jf = JFrag(f.cid, f.src, f.dst, f.tag, f.seq, f.kind, f.data,
                   f.total_len, f.offset, dict(f.meta))
        assert tcp_mod._fast_header(f) == jtcp._fast_header(jf)
        assert encode(f, cksum=ck) == encode(jf, cksum=ck)


def test_engage_is_idempotent_and_shutdown_resets(clean_engine):
    assert reactor.engage() and reactor.active()
    h = reactor._handle
    assert reactor.engage() and reactor._handle == h
    assert reactor.drain in progress._callbacks
    reactor.shutdown()
    assert not reactor.active() and reactor._handle == 0
    assert reactor.drain not in progress._callbacks


def test_var_off_keeps_reactor_disengaged(clean_engine):
    from ompi_tpu_torch.base.var import registry

    var = registry.lookup("otpu_progress_native")
    saved = var.value
    var.set(False)
    try:
        assert not reactor.configured()
        assert not reactor.engage() and not reactor.active()
    finally:
        var.set(saved)


def test_sanitizer_keeps_reactor_disengaged(clean_engine, monkeypatch):
    monkeypatch.setattr(sanitizer, "enabled", True)
    assert not reactor.engage() and not reactor.active()


def test_non_fast_frames_reach_python_as_raw_records(clean_engine):
    """A fast header with an unknown kind byte, a pickle header and a
    crc-armed fast frame each arrive as a verbatim RAW record; the port's
    parse of the unknown kind raises the KeyError the selector lane
    raises, and the crc frame verifies."""
    assert reactor.engage()
    hdr = _FAST.pack(7, 1, 2, 42, 9, 6, 5, 0, -1)   # kind code 6: unknown
    unknown = _LEN.pack(1 + len(hdr) + 5) + bytes((1,)) + hdr + b"xxxxx"
    payload = np.arange(64, dtype=np.uint8)
    pickled = encode(Frag(3, 0, 1, 5, 9, RNDV, payload, total_len=99,
                          meta={"req_id": 1, "w": 2}))
    armed = encode(Frag(3, 0, 1, 5, 9, MATCH, payload, total_len=64),
                   cksum=True)
    a, b = stream_pair()
    records = []
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       lambda et, pl: records.append((et, bytes(pl))) or 1)
    b.sendall(unknown + pickled + armed)
    drain_until(lambda: len(records) >= 3)
    assert [r[0] for r in records] == [reactor.REC_RAW] * 3
    assert [r[1] for r in records] == [x[_LEN.size:]
                                       for x in (unknown, pickled, armed)]
    btl = tcp_mod.TcpBtl()
    with pytest.raises(KeyError):
        btl._parse_frame(tcp_mod._Conn(None, rank=1), records[0][1])
    frag = btl._parse_frame(tcp_mod._Conn(None, rank=0), records[2][1])
    assert bytes(memoryview(frag.data)) == payload.tobytes()
    reactor.remove(a.fileno())
    a.close()
    b.close()


def test_oversize_frame_parks_and_resumes(clean_engine):
    """A frame above the oversize limit parks its stream; take_oversize
    fetches it whole and the stream resumes with the trailing bytes."""
    assert reactor.engage()
    big = np.random.default_rng(3).integers(0, 256, 5 << 20,
                                            dtype=np.uint8).tobytes()
    bighdr = _FAST.pack(7, 1, 2, 42, 10, 0, len(big), 0, -1)
    bigframe = _LEN.pack(1 + len(bighdr) + len(big)) + bytes((1,)) \
        + bighdr + big
    tail = encode(Frag(3, 0, 1, 5, 11, MATCH, np.arange(9, dtype=np.uint8),
                       total_len=9))
    a, b = stream_pair()
    records = []
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       lambda et, pl: records.append((et, bytes(pl))) or 1)
    t = threading.Thread(target=lambda: b.sendall(bigframe + tail))
    t.start()
    drain_until(lambda: records)
    assert records[0][0] == reactor.REC_OVERSIZE
    (flen,) = struct.unpack("<Q", records[0][1])
    assert flen == len(bigframe) - _LEN.size
    assert bytes(reactor.take_oversize(a.fileno())) == bigframe[_LEN.size:]
    drain_until(lambda: len(records) >= 2)
    t.join()
    assert records[1] == (reactor.REC_FAST, tail[_LEN.size + 1:])
    reactor.remove(a.fileno())
    a.close()
    b.close()


def test_desync_record_fails_loudly(clean_engine):
    """A zero-length frame is a framing desync: DESYNC, and the btl's
    dispatch raises SanitizeError."""
    assert reactor.engage()
    a, b = stream_pair()
    records = []
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       lambda et, pl: records.append((et, bytes(pl))) or 1)
    b.sendall(_LEN.pack(0))
    drain_until(lambda: records)
    assert records[0][0] == reactor.REC_DESYNC
    btl = tcp_mod.TcpBtl()
    with pytest.raises(sanitizer.SanitizeError):
        btl._reactor_event(tcp_mod._Conn(a, rank=3), reactor.REC_DESYNC,
                           records[0][1])
    reactor.remove(a.fileno())
    a.close()
    b.close()


def test_doorbell_drain_mode_consumes_dgrams(clean_engine):
    """MODE_DRAIN (btl/sm's doorbell): the epoll thread consumes the pings
    and surfaces one DOORBELL record."""
    assert reactor.engage()
    rx, tx = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
    rx.setblocking(False)
    records = []
    assert reactor.add(rx.fileno(), reactor.MODE_DRAIN,
                       lambda et, pl: records.append(et) or 1)
    for _ in range(3):
        tx.send(b"x")
    drain_until(lambda: records)
    assert records[0] == reactor.REC_DOORBELL
    time.sleep(0.05)
    with pytest.raises(BlockingIOError):
        rx.recv(512)                 # consumed on the epoll thread
    reactor.remove(rx.fileno())
    rx.close()
    tx.close()


def test_writable_record_once_per_arm(clean_engine):
    assert reactor.engage()
    a, b = stream_pair()
    records = []
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       lambda et, pl: records.append(et) or 1)
    assert reactor.want_write(a.fileno(), True)
    drain_until(lambda: records)
    time.sleep(0.05)
    reactor.drain()
    assert records == [reactor.REC_WRITABLE]
    reactor.remove(a.fileno())
    a.close()
    b.close()


def test_wait_fd_wakes_idle_wait(clean_engine):
    assert reactor.engage()
    a, b = stream_pair()
    got = []
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       lambda et, pl: got.append(et) or 1)
    reactor.drain()

    def poke():
        time.sleep(0.1)
        b.sendall(encode(Frag(3, 0, 1, 5, 9, MATCH,
                              np.arange(4, dtype=np.uint8), total_len=4)))

    t = threading.Thread(target=poke)
    t.start()
    t0 = time.monotonic()
    woke = progress.idle_wait(3.0)
    dt = time.monotonic() - t0
    t.join()
    assert woke and dt < 1.0, dt
    reactor.remove(a.fileno())
    a.close()
    b.close()


def test_eof_record_and_stats(clean_engine):
    assert reactor.engage()
    a, b = stream_pair()
    records = []
    assert reactor.add(a.fileno(), reactor.MODE_STREAM,
                       lambda et, pl: records.append(et) or 1)
    b.close()
    drain_until(lambda: records)
    assert records[-1] == reactor.REC_EOF
    st = reactor.stats()
    assert st["active"] and st["records"] >= 1 and st["registered_fds"] == 1
    reactor.remove(a.fileno())
    a.close()


def test_drain_is_identity_when_disengaged():
    assert not reactor.active()
    assert reactor.drain() == 0


def test_a_corrupt_frame_raises_through_progress(clean_engine):
    """A crc mismatch raised inside a progress callback reaches the
    waiting caller (the callback is not quarantined)."""
    btl = tcp_mod.TcpBtl()
    bad = bytearray(encode(Frag(3, 0, 1, 5, 9, MATCH,
                                np.arange(40, dtype=np.uint8), total_len=40),
                           cksum=True))
    bad[-1] ^= 1
    conn = tcp_mod._Conn(None, rank=2)

    def cb():
        return btl._on_bytes(conn, memoryview(bad))

    progress.register(cb)
    with pytest.raises(sanitizer.SanitizeError, match="crc32"):
        progress.progress()
    assert cb in progress._callbacks
