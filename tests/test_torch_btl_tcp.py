"""The port's btl/tcp framing and coll/quant's wire stage, held against the
JAX package's on the CPU.

- framing under adversarial segmentation (``tests/test_btl_wire.py``, run
  against the port): fast and pickle headers interleaved on one stream,
  split at every boundary, reassemble to the sent fragments in both receive
  lanes (``_drain``, ``_on_bytes``); the handshake; the 4 GB frame guard;
  the backpressure copy of only the queue's tail;
- the bytes a ``TcpBtl.send`` writes to its socket are the reference's, for
  plain, crc-armed (``OTPU_SANITIZE``) and quantized frames;
- the quant wire codec: ``encode_wire``/``decode_wire`` bytes equal the
  reference's on NaN, +-inf, -0.0, subnormals and a partial last block;
  ``wire_codec_for`` decides as the reference does; a corrupt quant frame
  fails as loudly as a crc mismatch.
"""
import pickle
import random
import socket

import numpy as np
import pytest

from ompi_tpu.mca.btl import tcp as jtcp
from ompi_tpu.mca.btl.base import Frag as JFrag
from ompi_tpu.mca.coll import quant as jquant
from ompi_tpu_torch.mca.btl import tcp as tcp_mod
from ompi_tpu_torch.mca.btl.base import (ACK, CTL, FRAG, MATCH, RGET, RNDV,
                                         Endpoint, Frag)
from ompi_tpu_torch.mca.coll import quant
from ompi_tpu_torch.runtime import sanitizer


def encode(frag: Frag) -> bytes:
    """Wire-encode one fragment the way ``TcpBtl.send`` frames it."""
    payload = memoryview(np.ascontiguousarray(frag.data)).cast("B")
    hdr = tcp_mod._fast_header(frag)
    if hdr is not None:
        fl = 1 + len(hdr) + len(payload)
        return (tcp_mod._LEN.pack(fl) + bytes((tcp_mod._H_FAST,)) + hdr
                + bytes(payload))
    hdr = pickle.dumps(
        (frag.cid, frag.src, frag.dst, frag.tag, frag.seq, frag.kind,
         frag.total_len, frag.offset, frag.meta),
        protocol=pickle.HIGHEST_PROTOCOL)
    fl = 1 + tcp_mod._LEN.size + len(hdr) + len(payload)
    return (tcp_mod._LEN.pack(fl) + bytes((tcp_mod._H_PICKLE,))
            + tcp_mod._LEN.pack(len(hdr)) + hdr + bytes(payload))


class _FakeConn:
    """The slice of _Conn that _drain/_parse_frame touch."""

    def __init__(self, rank=7):
        self.rank = rank
        self.inbuf = bytearray()


def _same(orig, back):
    assert (orig.cid, orig.src, orig.dst, orig.tag, orig.seq, orig.kind,
            orig.total_len, orig.offset) == \
           (back.cid, back.src, back.dst, back.tag, back.seq, back.kind,
            back.total_len, back.offset)
    assert dict(orig.meta) == dict(back.meta)
    assert bytes(memoryview(np.ascontiguousarray(orig.data))) \
        == bytes(memoryview(np.ascontiguousarray(back.data)))


def mixed_frags(rng: random.Random, n=24) -> list:
    """Fragments alternating fast- and pickle-header eligibility."""
    frags = []
    for i in range(n):
        payload = np.frombuffer(
            bytes(rng.randrange(256) for _ in range(rng.randrange(0, 200))),
            np.uint8)
        pick = i % 4
        if pick == 0:
            f = Frag(3, 0, 1, rng.randrange(1000), i, MATCH, payload,
                     total_len=len(payload))
        elif pick == 1:
            f = Frag(3, 1, 0, -1, 0, FRAG, payload, total_len=1 << 20,
                     offset=rng.randrange(1 << 20),
                     meta={"req_id": rng.randrange(1 << 40)})
        elif pick == 2:
            f = Frag(3, 0, 1, rng.randrange(1000), i, RNDV, payload,
                     total_len=len(payload) + 512,
                     meta={"req_id": i, "window": [1, 2]})
        else:
            f = Frag(3, 1, 0, -1, 0, CTL, payload,
                     meta={"proto": "ob1_rget_done", "req_id": i})
        frags.append(f)
    return frags


def test_header_type_selection_is_the_references():
    data = np.arange(8, dtype=np.uint8)
    cases = [(1, 0, 1, 5, 9, MATCH, data, 8, 0, {}),
             (1, 0, 1, -1, 0, FRAG, data, 64, 8, {"req_id": 3}),
             (1, 0, 1, 5, 9, ACK, data, 0, 0, {"req_id": 3, "peer_req": 4}),
             (1, 0, 1, 5, 9, RGET, data, 0, 0, {"key": (1, 2)}),
             (1, 0, 1, 1 << 40, 9, MATCH, data, 0, 0, {}),
             (1, 0, 1, 5, 9, MATCH, data, 0, 0, {"req_id": -5}),
             (1, 0, 1, 5, 9, "weird_kind", data, 0, 0, {}),
             ((1 << 32) - 1, (1 << 32) - 1, 0, -(1 << 31), 1 << 62, FRAG,
              data, 1 << 62, 1 << 61, {"req_id": 1 << 62})]
    got = [tcp_mod._fast_header(Frag(*c)) for c in cases]
    assert got == [jtcp._fast_header(JFrag(*c)) for c in cases]
    assert [g is not None for g in got] == [True, True, False, False, False,
                                            False, False, True]


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_split_boundaries_mixed_headers(seed):
    """Mixed fast/pickle frames in random chunk sizes that split frames
    inside the length prefix, the htype byte, headers and payloads: the
    port's reassembly and the reference's deliver the sent fragments."""
    rng = random.Random(seed)
    frags = mixed_frags(rng)
    stream = b"".join(encode(f) for f in frags)
    got = {}
    for name, mod in (("torch", tcp_mod), ("jax", jtcp)):
        btl = mod.TcpBtl()
        out = []
        btl.set_recv_callback(out.append)
        conn = _FakeConn()
        cut = random.Random(seed + 7)
        pos = 0
        while pos < len(stream):
            step = cut.choice((1, 2, 3, 5, 7, 13, 64, 1024))
            conn.inbuf += stream[pos:pos + step]
            pos += step
            btl._drain(conn)
        assert not conn.inbuf
        got[name] = out
    assert len(got["torch"]) == len(frags) == len(got["jax"])
    for orig, back, ref in zip(frags, got["torch"], got["jax"]):
        _same(orig, back)
        _same(ref, back)


def test_byte_at_a_time_delivery():
    frags = mixed_frags(random.Random(99), n=6)
    stream = b"".join(encode(f) for f in frags)
    btl = tcp_mod.TcpBtl()
    got = []
    btl.set_recv_callback(got.append)
    conn = _FakeConn()
    for i in range(len(stream)):
        conn.inbuf += stream[i:i + 1]
        btl._drain(conn)
    assert len(got) == len(frags)
    for orig, back in zip(frags, got):
        _same(orig, back)


def test_handshake_interleaved_with_data_frames():
    hello = pickle.dumps({"rank": 5})
    hs = (tcp_mod._LEN.pack(1 + tcp_mod._LEN.size + len(hello))
          + bytes((tcp_mod._H_PICKLE,)) + tcp_mod._LEN.pack(len(hello))
          + hello)
    f_fast = Frag(2, 5, 0, 11, 0, MATCH, np.arange(16, dtype=np.uint8),
                  total_len=16)
    f_pickle = Frag(2, 5, 0, 11, 1, RNDV, np.arange(4, dtype=np.uint8),
                    total_len=1024, meta={"req_id": 1, "x": "y"})
    btl = tcp_mod.TcpBtl()
    got = []
    btl.set_recv_callback(got.append)
    conn = _FakeConn(rank=None)
    conn.inbuf += hs + encode(f_fast) + encode(f_pickle)
    btl._drain(conn)
    assert conn.rank == 5 and btl._by_rank[5] == [conn]
    assert len(got) == 2
    _same(f_fast, got[0])
    _same(f_pickle, got[1])


def test_the_4gb_frame_guard_raises(capsys):
    """A frame past the u32 length prefix fails loudly at the sender
    before any connect (a zero-stride array: no 4 GB allocation)."""
    btl = tcp_mod.TcpBtl()
    huge = np.broadcast_to(np.zeros(1, np.uint8), ((1 << 32) + 10,))
    frag = Frag(1, 0, 1, 5, 0, MATCH, huge, total_len=huge.nbytes)
    with pytest.raises(ValueError, match="length-prefix"):
        btl.send(Endpoint(btl, 1), frag)
    assert "frame" in capsys.readouterr().err.lower()


@pytest.mark.parametrize("seed", range(4))
def test_on_bytes_streaming_path_fuzzed(seed):
    """``_on_bytes``: complete frames arrive ``borrowed`` from the recv
    scratch, split ones reassemble and arrive owned; payloads identical
    either way, and both paths are exercised."""
    rng = random.Random(1000 + seed)
    frags = mixed_frags(rng, n=18)
    stream = b"".join(encode(f) for f in frags)
    btl = tcp_mod.TcpBtl()
    got = []
    btl.set_recv_callback(lambda f: got.append((f, bytes(memoryview(
        np.ascontiguousarray(f.data))), f.borrowed)))
    conn = _FakeConn()
    btl._on_bytes(conn, memoryview(bytearray(stream[:2])))
    pos = 2
    while pos < len(stream) - 8192:
        step = rng.choice((5, 37, 256, 4096))
        btl._on_bytes(conn, memoryview(bytearray(stream[pos:pos + step])))
        pos += step
    btl._on_bytes(conn, memoryview(bytearray(stream[pos:])))
    assert len(got) == len(frags)
    for orig, (back, payload, _) in zip(frags, got):
        assert (orig.kind, orig.seq, orig.offset, dict(orig.meta)) == \
            (back.kind, back.seq, back.offset, dict(back.meta))
        assert bytes(memoryview(np.ascontiguousarray(orig.data))) == payload
    kinds = {borrowed for _, _, borrowed in got}
    assert kinds == {True, False} and not conn.inbuf


def test_own_queued_copies_only_the_tail():
    a, b = socket.socketpair()
    btl = tcp_mod.TcpBtl()
    conn = tcp_mod._Conn(a, rank=1)
    backlog = [memoryview(bytes([i]) * 64) for i in range(6)]
    conn.outq.extend(backlog)
    user = bytearray(b"x" * 128)
    conn.outq.append(memoryview(b"H" * 16))
    conn.outq.append(memoryview(user))
    with conn.send_lock:
        btl._own_queued_locked(conn, 2)
    q = list(conn.outq)
    assert len(q) == 8 and all(now is orig for orig, now in
                               zip(backlog, q[:6]))
    user[:] = b"y" * 128
    assert bytes(q[7]) == b"x" * 128 and bytes(q[6]) == b"H" * 16
    a.close()
    b.close()


def _sent_bytes(mod, frag, monkeypatch, armed=False, wire=False):
    """The bytes ``mod``'s ``TcpBtl.send`` writes for ``frag`` to a
    connected socket (the conn is planted as the peer's established
    link)."""
    a, b = socket.socketpair()
    b.settimeout(5)
    btl = mod.TcpBtl()
    conn = mod._Conn(a, rank=1)
    btl._by_rank[1] = [conn]
    qmod = quant if mod is tcp_mod else jquant
    monkeypatch.setattr(qmod, "wire_enabled", wire)
    monkeypatch.setattr(mod, "_cksum_armed", lambda: armed)
    ep = (Endpoint if mod is tcp_mod else
          __import__("ompi_tpu.mca.btl.base", fromlist=["x"]).Endpoint)(btl, 1)
    btl.send(ep, frag)
    a.close()
    out = b""
    while True:
        chunk = b.recv(1 << 20)
        if not chunk:
            break
        out += chunk
    b.close()
    return out


@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("kind", ["match", "frag", "rndv"])
def test_send_writes_the_references_bytes(monkeypatch, kind, wire, armed):
    """Plain, crc-armed and quantized frames: the port's send and the
    reference's write the same bytes for the same fragment (float32
    payload, int8 wire codec)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal(3000).astype(np.float32)
    x[5] = np.nan
    x[17] = -0.0
    meta = {"match": {}, "frag": {"req_id": 9},
            "rndv": {"req_id": 9, "extra": 1}}[kind]
    k = {"match": MATCH, "frag": FRAG, "rndv": RNDV}[kind]
    args = (4, 0, 1, 3, 2, k, x.view(np.uint8), 12000, 0, meta)
    got = _sent_bytes(tcp_mod, Frag(*args, qcodec="int8"), monkeypatch,
                      armed, wire)
    want = _sent_bytes(jtcp, JFrag(*args, qcodec="int8"), monkeypatch,
                       armed, wire)
    assert got == want
    htype = got[4]
    assert bool(htype & tcp_mod._H_QUANT) == wire
    assert bool(htype & tcp_mod._H_CK_BASE) == armed
    # and the port's parse of those bytes gives the reference's payload:
    # the original bytes, or their int8 decode when quantized
    back = tcp_mod.TcpBtl()._parse_frame(tcp_mod._Conn(None, rank=0),
                                         got[4:])
    ref = jtcp.TcpBtl()._parse_frame(jtcp._Conn(None, rank=0), got[4:])
    assert np.asarray(back.data).tobytes() == np.asarray(ref.data).tobytes()
    if not wire:
        assert np.asarray(back.data).tobytes() == x.tobytes()


def _wire_cases():
    rng = np.random.default_rng(41)
    tiny = np.float32(1e-40)                    # subnormal
    base = rng.standard_normal(1000).astype(np.float32)
    special = base.copy()
    special[[1, 130, 300, 700]] = [np.nan, np.inf, -np.inf, -0.0]
    sub = np.full(600, tiny, np.float32) * rng.integers(1, 5, 600).astype(
        np.float32)
    ties = (np.arange(513, dtype=np.float32) - 256) / 2
    return {"normal": base, "special": special, "subnormal": sub,
            "partial_block": base[:777], "ties": ties,
            "zeros": np.zeros(256, np.float32)}


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("case", sorted(_wire_cases()))
def test_wire_codec_bytes_are_the_references(case, codec):
    x = _wire_cases()[case]
    payload = memoryview(x.view(np.uint8))
    enc = quant.encode_wire(payload, codec)
    ref = jquant.encode_wire(payload, codec)
    assert (enc is None) == (ref is None)
    if enc is None:
        assert x.nbytes < 1024
        return
    assert enc.tobytes() == ref.tobytes()
    cid = quant.codec_id(codec)
    assert cid == jquant.codec_id(codec)
    dec = quant.decode_wire(enc, cid, x.nbytes, quant.block_elems())
    ref_dec = jquant.decode_wire(ref, cid, x.nbytes, jquant.block_elems())
    assert dec.tobytes() == ref_dec.tobytes()


def test_wire_stats_count_orig_and_encoded_bytes():
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    before = quant.wire_stats()
    enc = quant.encode_wire(memoryview(x.view(np.uint8)), "int8")
    after = quant.wire_stats()
    assert after["orig"] - before["orig"] == x.nbytes
    assert after["enc"] - before["enc"] == enc.nbytes == 4096 + 4 * 32
    assert quant.encode_wire(memoryview(x.view(np.uint8))[:1022],
                             "int8") is None        # not f32-aligned


def test_wire_codec_for_decides_as_the_reference():
    from ompi_tpu.datatype import Convertor as JConv
    from ompi_tpu.datatype import core as jcore
    from ompi_tpu_torch.datatype import Convertor
    from ompi_tpu_torch.datatype import core

    cases = [("FLOAT32", 1 << 16), ("FLOAT32", (1 << 14) - 1),
             ("FLOAT64", 1 << 16), ("INT32", 1 << 16)]
    for name, n in cases:
        dt = getattr(core, name)
        np_dt = {"FLOAT32": np.float32, "FLOAT64": np.float64,
                 "INT32": np.int32}[name]
        buf = np.zeros(n, np_dt)
        c = Convertor(dt, n, buf)
        jc = JConv(getattr(jcore, name), n, buf)
        assert quant.wire_codec_for(c, buf.nbytes) == \
            jquant.wire_codec_for(jc, buf.nbytes)
    vec = core.vector(100, 1, 2, core.FLOAT32)
    assert quant.wire_codec_for(Convertor(vec, 200, np.zeros(40000,
                                                             np.float32)),
                                1 << 20) is None


@pytest.mark.parametrize("fault", ["codec_id", "raw_len", "truncated"])
def test_a_corrupt_quant_frame_fails_as_loudly_as_a_crc_one(fault):
    """A quantized frame that does not decode raises SanitizeError with
    its own diagnostic, as a crc mismatch does."""
    x = np.random.default_rng(5).standard_normal(2048).astype(np.float32)
    enc = quant.encode_wire(memoryview(x.view(np.uint8)), "int8")
    hdr = tcp_mod._FAST.pack(1, 0, 1, 2, 3, 0, x.nbytes, 0, -1)
    codec, raw = quant.codec_id("int8"), x.nbytes
    body = enc.tobytes()
    if fault == "codec_id":
        codec = 9
    elif fault == "raw_len":
        raw += 4
    else:
        body = body[:-10]
    frame = bytes((tcp_mod._H_FAST | tcp_mod._H_QUANT,)) \
        + tcp_mod._QHDR.pack(codec, raw, quant.block_elems()) + hdr + body
    btl = tcp_mod.TcpBtl()
    with pytest.raises(sanitizer.SanitizeError,
                       match="quantized frame from rank 3 does not decode"):
        btl._parse_frame(tcp_mod._Conn(None, rank=3), frame)
    crc = bytes((tcp_mod._H_FAST | tcp_mod._H_CK_BASE,)) \
        + tcp_mod._CKSUM.pack(0) + hdr
    with pytest.raises(sanitizer.SanitizeError, match="crc32"):
        btl._parse_frame(tcp_mod._Conn(None, rank=3), crc)


def test_the_vars_are_the_references():
    from ompi_tpu_torch.base.var import registry

    assert tcp_mod.TcpBtl.eager_limit == jtcp.TcpBtl.eager_limit == 65536
    assert tcp_mod.TcpBtl.max_send_size == jtcp.TcpBtl.max_send_size
    assert (tcp_mod.TcpBtl.latency, tcp_mod.TcpBtl.bandwidth) == \
        (jtcp.TcpBtl.latency, jtcp.TcpBtl.bandwidth)
    from ompi_tpu_torch.base import mca

    mca.framework("btl", "byte transfer layer", multi_select=True).open()
    for name, default in (("otpu_btl_tcp_eager_limit", 65536),
                          ("otpu_btl_tcp_max_send_size", 131072),
                          ("otpu_btl_tcp_links", 1),
                          ("otpu_coll_quant_wire", False),
                          ("otpu_coll_quant_wire_codec", "int8")):
        var = registry.lookup(name)
        if var is None and name.startswith("otpu_coll"):
            mca.framework("coll", "collective operations",
                          multi_select=True).open()
            var = registry.lookup(name)
        assert var is not None and var.value == default, name
