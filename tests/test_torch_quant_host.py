"""coll/quant's host half on the CPU lane, held against the JAX package's:
the numpy codec (``encode_f32`` bytes equal to the reference's for bf16 and
int8 on NaN payloads, ±inf, −0.0, subnormals, round-half-even ties,
all-zero blocks and a last partial block; ``decode_f32``'s size check), the
host collectives ``allreduce_blockq``/``allgather_blockq`` bit-identical to
the reference's on the threads harness, and coll/tuned's quant arm, which
engages only under an explicit budget and never for a non-commutative op
(the reference's ``tests/test_quant.py:206-287``).
"""
import numpy as np
import pytest

from ompi_tpu.mca.coll import quant as jq
from ompi_tpu_torch.mca.coll import quant as tq

from test_torch_coll_algorithms import (NS, PKGS, bits, both, comms,  # noqa: F401
                                        rank_data, signed_product, spmd,
                                        var_values)

QUANT = {"jax": jq, "torch": tq}


def _f32(words):
    return np.array(words, np.uint32).view(np.float32)


def special_values():
    """Every edge the bf16 carry and the int8 scale meet, as f32 bits."""
    words = [
        0x7FC00000, 0xFFC00000,            # quiet NaNs, both signs
        0x7F800001, 0x7FBFFFFF,            # signalling NaN payloads
        0x7FFF8000, 0x7FFFFFFF, 0xFF80FFFF,   # payloads the carry would flush
        0x7F800000, 0xFF800000,            # +-inf
        0x00000000, 0x80000000,            # +-0.0
        0x00000001, 0x007FFFFF, 0x80400000,   # subnormals
        0x00800000, 0x7F7FFFFF, 0xFF7FFFFF,   # smallest normal, +-max
        0x3F808000, 0x3F818000,            # ties: even stays, odd rounds up
        0x3F808001, 0x3F817FFF,            # just past / below a tie
        0x7F7F8000, 0x7F7FC000,            # ties that carry into +inf
        0x3F800000, 0xBF800000,            # +-1
    ]
    return _f32(words)


def inputs():
    rng = np.random.default_rng(4)
    normal = rng.standard_normal(1000).astype(np.float32)
    ties = (rng.integers(-200, 200, 300) / 2.0).astype(np.float32)
    tiny = (rng.standard_normal(260) * 1e-40).astype(np.float32)
    mixed = np.concatenate([special_values(), normal[:100]])
    return {
        "specials": special_values(),
        "normal": normal,
        "int8_ties": ties,                       # x*127/amax lands on .5
        "zero_blocks": np.concatenate([np.zeros(256, np.float32),
                                       normal[:100], np.zeros(128,
                                                              np.float32)]),
        "subnormal_blocks": tiny,
        "mixed": mixed,
        "partial_last_block": normal[:333],
        "one": normal[:1],
        "empty": np.zeros(0, np.float32),
    }


@pytest.mark.parametrize("codec", tq.CODECS)
@pytest.mark.parametrize("block", [128, 7, 1])
@pytest.mark.parametrize("name", sorted(inputs()))
def test_encode_matches_the_reference(codec, block, name):
    x = inputs()[name]
    with np.errstate(all="ignore"):
        want = jq.encode_f32(x, codec, block)
        got = tq.encode_f32(x, codec, block)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert got.size == tq.encoded_nbytes(x.size, codec, block) == \
        jq.encoded_nbytes(x.size, codec, block)
    with np.errstate(all="ignore"):
        back = tq.decode_f32(got, codec, x.size, block)
        ref = jq.decode_f32(want, codec, x.size, block)
    assert back.tobytes() == ref.tobytes()


def test_bf16_nan_keeps_a_nan():
    """The NaN special case before the round-to-nearest-even carry: a NaN
    whose low half would carry into the exponent stays a NaN (the carry
    alone flushes 0x7FFF8000 to +0.0), with the reference's bits."""
    x = _f32([0x7FFF8000, 0x7F808000, 0xFFFFFFFF])
    got = tq.encode_f32(x, "bf16").view(np.uint16)
    assert got.tolist() == jq.encode_f32(x, "bf16").view(np.uint16).tolist()
    assert np.isnan(tq.decode_f32(got.view(np.uint8), "bf16", 3)).all()


def test_int8_layout_scales_then_codes():
    x = np.concatenate([np.zeros(4, np.float32),
                        np.array([1.0, -2.0, 0.5], np.float32)])
    enc = tq.encode_f32(x, "int8", 4)
    scales = enc[:8].view(np.float32)
    assert scales[0] == 0.0 and scales[1] == np.float32(2.0 / 127.0)
    assert enc[8:12].view(np.int8).tolist() == [0, 0, 0, 0]
    assert enc[12:].view(np.int8).tolist() == [64, -127, 32]


@pytest.mark.parametrize("codec", tq.CODECS)
def test_decode_checks_the_size(codec):
    enc = tq.encode_f32(np.ones(10, np.float32), codec, 4)
    for pkg in (tq, jq):
        with pytest.raises(ValueError, match="does not match"):
            pkg.decode_f32(enc[:-1], codec, 10, 4)
        with pytest.raises(ValueError, match="does not match"):
            pkg.decode_f32(enc, codec, 11, 4)
        with pytest.raises(KeyError):
            pkg.encoded_nbytes(10, "int4")
    assert tq.decode_f32(enc.tobytes(), codec, 10, 4).tobytes() == \
        jq.decode_f32(enc.tobytes(), codec, 10, 4).tobytes()


def test_block_var_and_nblocks():
    assert tq.DEFAULT_BLOCK == jq.DEFAULT_BLOCK == tq.block_elems() == 128
    for n, b in ((0, 4), (1, 4), (4, 4), (5, 4), (1000, 128)):
        assert tq.nblocks(n, b) == jq.nblocks(n, b)


@pytest.mark.parametrize("nranks", [8, 5])
@pytest.mark.parametrize("codec", tq.CODECS)
def test_blockq_collectives_match_the_reference(comms, codec, nranks):
    for nelem in (1, 333, 4096):
        data = rank_data(nranks, nelem, np.float32, seed=nelem)
        for opname in ("SUM", "MAX"):
            out = both(comms, nranks, lambda c, r, ns: QUANT[
                "jax" if ns is NS["jax"] else "torch"].allreduce_blockq(
                c, data[r], getattr(ns.op, opname), codec))
            for r in range(1, nranks):
                assert bits(out[r]) == bits(out[0])
        out = both(comms, nranks, lambda c, r, ns: QUANT[
            "jax" if ns is NS["jax"] else "torch"].allgather_blockq(
            c, data[r].reshape(-1, 1), codec))
        assert out[0].shape == (nranks, nelem, 1)


def test_blockq_stages_a_tensor(comms):
    import torch

    data = rank_data(8, 500, np.float32, seed=3)
    got = spmd(comms["torch"][8], lambda c, r: tq.allreduce_blockq(
        c, torch.from_numpy(data[r]), NS["torch"].op.SUM, "int8"))
    want = spmd(comms["torch"][8], lambda c, r: tq.allreduce_blockq(
        c, data[r], NS["torch"].op.SUM, "int8"))
    assert isinstance(got[0], np.ndarray) and bits(got) == bits(want)


def _quant_arm(comms, budget, call):
    """Run ``call(module, comm, rank, ns)`` through each package's
    TunedModule with the world's budget set; (results, encodes made)."""
    out = {}
    for pkg in PKGS:
        ns = NS[pkg]
        fw = ns.coll_framework()
        fw.open()
        mod = ns.tuned.TunedModule(fw.components["tuned"])
        w = comms[pkg][8]
        if budget is not None:
            w.info.set("otpu_quant_budget", budget)
        try:
            enc0 = ns.spc.read("quant_encodes")
            res = spmd(w, lambda c, r: call(mod, c, r, ns))
            out[pkg] = (res, ns.spc.read("quant_encodes") - enc0)
        finally:
            if budget is not None:
                w.info.delete("otpu_quant_budget")
    assert bits(out["torch"][0]) == bits(out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    return out["torch"]


def test_tuned_quant_only_under_budget(comms):
    data = rank_data(8, 64 * 1024, np.float32, seed=21)      # 256 KB f32
    exact = data.astype(np.float64).sum(0)
    res, enc = _quant_arm(comms, None, lambda m, c, r, ns: m.allreduce(
        c, data[r], ns.op.SUM))
    assert enc == 0, "quantized WITHOUT an accuracy budget"
    assert np.abs(res[0] - exact).max() / np.abs(exact).max() < 1e-5
    res, enc = _quant_arm(comms, "0.02", lambda m, c, r, ns: m.allreduce(
        c, data[r], ns.op.SUM))
    rel = np.abs(res[0] - exact).max() / np.abs(exact).max()
    assert 1e-7 < rel <= tq.CODEC_BANDS["int8"] * 1.2 and enc == 8
    res, enc = _quant_arm(comms, "0.005", lambda m, c, r, ns: m.allgather(
        c, data[r][:32768]))
    relg = np.abs(res[0] - data[:, :32768]).max() / np.abs(data).max()
    assert 0 < relg <= tq.CODEC_BANDS["bf16"] and enc == 8


def test_tuned_quant_never_noncommutative(comms):
    data = rank_data(8, 64 * 1024, np.float32, seed=22)
    res, enc = _quant_arm(comms, "0.02", lambda m, c, r, ns: m.allreduce(
        c, data[r], signed_product(ns)))
    assert enc == 0, "non-commutative op was quantized"


def test_tuned_force_var_beats_quant(comms):
    data = rank_data(8, 64 * 1024, np.float32, seed=23)
    with var_values({"otpu_coll_tuned_allreduce_algorithm": "ring"}):
        res, enc = _quant_arm(comms, "0.02", lambda m, c, r, ns: m.allreduce(
            c, data[r], ns.op.SUM))
    assert enc == 0, "force-var override was quantized away"
