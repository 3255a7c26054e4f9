"""The port's codec kernels and bf16-wire ring (ompi_tpu_torch/ops/quant.py,
ompi_tpu_torch/ops/ring_collectives.py) and its quant decision ladder
(ompi_tpu_torch/mca/coll/quant.py), held against the JAX package.

Same numpy inputs to both.  The JAX side runs the Pallas kernels of
``ompi_tpu.ops.pallas_quant`` and ``pallas_collectives`` in interpret mode
(the wire16 rings on the 8-virtual-CPU mesh), the port its plain versions
(CPU tensors).  Every comparison is bit for bit, NaN and inf blocks
included: the port keeps the reference's encode arithmetic, the fused
multiply-add order XLA's CPU backend gives the dequant-accumulate, and the
bf16 rounding of every wire hop.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.mca.coll import quant as jquant
from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu.ops import pallas_quant as pq
from ompi_tpu_torch.api import op as top
from ompi_tpu_torch.api.info import Info
from ompi_tpu_torch.mca.coll import quant as tquant
from ompi_tpu_torch.ops import quant as qo
from ompi_tpu_torch.ops import ring_collectives as rc

SIZES = (1, 127, 128, 129, 70001)
OPS = ("sum", "max", "min", "prod")


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs), ("x",))


def _rows(size):
    return max(1, -(-size // 128))


def _codec_input(k: int, size: int, seed: int) -> np.ndarray:
    """(k, size) float32: normal values, and where the row has room, an
    all-zero block, a block of exact .5 ties (amax 127, so inv = 1), a block
    holding NaN and one holding +inf and -inf, each on another rank."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, size)).astype(np.float32)
    ties = np.arange(128, dtype=np.float32) - 63.5          # ... -0.5, 0.5 ...
    ties[0] = 127.0
    if size < 256:                # small rows: the ties in the first block
        x[0, :min(size, 128)] = ties[:min(size, 128)]
        return x
    specials = [np.zeros(128, np.float32), ties]
    nan = rng.standard_normal(128).astype(np.float32)
    nan[17] = np.nan
    inf = rng.standard_normal(128).astype(np.float32)
    inf[3], inf[90] = np.inf, -np.inf
    specials += [nan, inf]
    for i, block in enumerate(specials):
        if (i + 1) * 128 <= size:
            x[i % k, i * 128:(i + 1) * 128] = block
    return x


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _assert_bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _ref_encode(x: np.ndarray):
    """The reference's per-rank encode, sliced to the port's rows and its
    lane-padded scales to one per block."""
    rows = _rows(x.shape[1])
    qs, ss = zip(*(pq.encode_int8(r, interpret=True) for r in x))
    return (np.stack([np.asarray(q)[:rows] for q in qs]),
            np.stack([np.asarray(s)[:rows, 0] for s in ss]))


# -- K17-K19 against pallas_quant ------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_encode_matches_reference(size):
    x = _codec_input(3, size, seed=size)
    want_q, want_s = _ref_encode(x)
    q, s = qo.encode_int8(torch.from_numpy(x))
    _assert_bits(q, want_q)
    _assert_bits(s, want_s)
    if size >= 512:   # the special blocks: zero, ties, NaN, ±inf
        assert not q[0, 0].any() and s[0, 0] == 0
        assert torch.isnan(s[2, 2]) and not q[2, 2].any()
        assert torch.isinf(s[0, 3]) and not q[0, 3].any()
        assert q[1, 1].tolist()[60:68] == [-4, -2, -2, 0, 0, 2, 2, 4]


def test_encode_saturates_like_xla():
    """A block whose 127/amax overflows to inf: x·inv is ±inf (and NaN for
    a zero), which XLA's float->int8 convert takes to 127/-128 (and 0)."""
    x = np.zeros((1, 128), np.float32)
    x[0, :4] = (3e-37, -3e-37, 1.5e-37, 0.0)
    want_q, _ = _ref_encode(x)
    assert want_q[0, 0, :4].tolist() == [127, -128, 127, 0]
    q, _ = qo.encode_int8(torch.from_numpy(x))
    _assert_bits(q, want_q)


def test_subnormal_scale_divergence_pinned():
    """XLA's CPU run flushes subnormals to zero; the port (and the card)
    keep them: a block with amax 1e-36 has the same q in both packages,
    but the scale amax/127 is subnormal, 0 in the reference and kept here
    (ROADMAP C)."""
    x = np.zeros((1, 128), np.float32)
    x[0, :3] = (1e-36, -1e-36, 5e-37)
    want_q, want_s = _ref_encode(x)
    q, s = qo.encode_int8(torch.from_numpy(x))
    _assert_bits(q, want_q)
    assert want_s[0, 0] == 0.0
    assert s[0, 0] == np.float32(1e-36) * np.float32(qo.INV127) > 0


@pytest.mark.parametrize("size", SIZES)
def test_decode_matches_reference(size):
    x = _codec_input(8, size, seed=100 + size)
    q, s = _ref_encode(x)
    want = np.asarray(pq.decode_int8(q, s[..., None], interpret=True))
    _assert_bits(qo.decode_int8(torch.from_numpy(q), torch.from_numpy(s)),
                 want)


@pytest.mark.parametrize("k", (1, 2, 8))
@pytest.mark.parametrize("size", SIZES)
def test_dequant_accumulate_matches_reference(size, k):
    """Bit for bit: the plain version follows the fma order XLA's CPU
    backend gives the reference's kernel body, fma(q0, s0, q1·s1) then
    fma(q_i, s_i, acc)."""
    x = _codec_input(k, size, seed=200 + size + k)
    q, s = _ref_encode(x)
    want = np.asarray(pq.dequant_accumulate(q, s[..., None], interpret=True))
    _assert_bits(qo.dequant_accumulate(torch.from_numpy(q),
                                       torch.from_numpy(s)), want)


def test_dequant_accumulate_order_is_the_fma_chain():
    """The order pins a value that neither the sum of rounded products nor
    the other fma order gives: q0·s0 = 3·(1 + 2^-23) is kept exact by
    fma(q0, s0, q1·s1) with q1·s1 = -3, leaving 3·2^-23; rounding q0·s0
    first leaves 2^-21."""
    q = torch.tensor([[3], [-3]], dtype=torch.int8).expand(2, 128)
    q = q.reshape(2, 1, 128).contiguous()
    s = torch.tensor([[1.0 + 2.0 ** -23], [1.0]])
    got = qo.dequant_accumulate(q, s)
    assert torch.all(got == 3 * 2.0 ** -23)
    want = np.asarray(pq.dequant_accumulate(q.numpy(), s.numpy()[..., None],
                                            interpret=True))
    _assert_bits(got, want)


def test_codec_wrappers_check_their_arguments():
    before = dict(qo.launches)
    with pytest.raises(TypeError):
        qo.encode_int8(torch.ones(8, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        qo.encode_int8(torch.ones(16, 8).t())              # not contiguous
    q = torch.zeros(8, 3, 128, dtype=torch.int8)
    with pytest.raises(ValueError):
        qo.decode_int8(q, torch.ones(8, 4))                # scales per block
    with pytest.raises(TypeError):
        qo.decode_int8(q.float(), torch.ones(8, 3))
    with pytest.raises(ValueError):
        qo.dequant_accumulate(q[0], torch.ones(3))         # no k axis
    assert qo.launches == before, "a CPU tensor launched a kernel"


# -- the decision ladder ---------------------------------------------------

LADDER = [
    # (coll, dtype, nbytes, budget, commute)
    ("allreduce", "f32", 1 << 20, 0.01, True),
    ("allreduce", "f32", 1 << 20, jquant.CODEC_BANDS["int8"], True),
    ("allreduce", "f32", 1 << 20, 0.005, True),
    ("allreduce", "f32", 1 << 20, 0.001, True),
    ("allreduce", "f32", 1 << 20, None, True),
    ("allreduce", "f32", 1 << 20, 0.0, True),
    ("allreduce", "i32", 1 << 20, 0.01, True),
    ("allreduce", "f64", 1 << 20, 0.01, True),
    ("allreduce", "f32", 1 << 20, 0.01, False),
    ("allreduce", "f32", 1024, 0.01, True),
    ("allreduce", "f32", 64 << 10, 0.01, True),
    ("allreduce", "f32", (64 << 10) - 1, 0.01, True),
    ("bcast", "f32", 1 << 20, 0.01, True),
    ("allgather", "f32", 1 << 20, 0.01, True),
    ("alltoallv", "f32", 1 << 20, 0.005, True),
]
NP_DT = {"f32": np.float32, "i32": np.int32, "f64": np.float64}
TORCH_DT = {"f32": torch.float32, "i32": torch.int32, "f64": torch.float64}


@pytest.mark.parametrize("case", LADDER)
def test_decide_matches_reference(case):
    coll, dt, nbytes, budget, commute = case
    want = jquant.decide(coll, NP_DT[dt], nbytes, budget, commute)
    assert tquant.decide(coll, NP_DT[dt], nbytes, budget, commute) == want
    # torch dtypes decide the same way (np.dtype(torch.float32) raises)
    assert tquant.decide(coll, TORCH_DT[dt], nbytes, budget, commute) == want
    for bad in (None, torch.bfloat16, "not-a-dtype"):
        assert tquant.decide(coll, bad, nbytes, budget, commute) is None


class _InfoComm:
    def __init__(self, info):
        self.info = info


@pytest.mark.parametrize("raw", (None, "0.01", "0.005", "0.001", "0", "-1",
                                 "1e-2", "not-a-float"))
def test_budget_and_pick_match_reference(raw, monkeypatch):
    from ompi_tpu.api import op as jop
    from ompi_tpu.api.info import Info as JInfo
    from ompi_tpu.base import output as joutput

    # a malformed budget makes the reference show its help once per process:
    # a fresh table here keeps that first showing for the reference's own
    # test of it (tests/test_quant.py), whatever ran first on this worker
    monkeypatch.setattr(joutput, "_help_seen", {})
    ji, ti = JInfo(), Info()
    if raw is not None:
        ji.set(jquant.BUDGET_KEY, raw)
        ti.set(tquant.BUDGET_KEY, raw)
    jc, tc = _InfoComm(ji), _InfoComm(ti)
    assert tquant.budget_of(tc) == jquant.budget_of(jc)
    for jo, to in ((jop.SUM, top.SUM), (jop.REPLACE, top.REPLACE)):
        want = jquant.pick(jc, "allreduce", np.float32, 1 << 20, jo)
        assert tquant.pick(tc, "allreduce", torch.float32, 1 << 20, to) == want
        assert tquant.pick(tc, "allreduce", np.float32, 1 << 20, to) == want
    assert tquant.pick(tc, "allgather", torch.float32, 1 << 20) == \
        jquant.pick(jc, "allgather", np.float32, 1 << 20)


# -- the bf16 wire: K7 and K5's wire16 form ----------------------------------

def test_bf16_round_matches_ml_dtypes():
    """Round to nearest even on the bits, and every NaN the quiet NaN
    0x7FC00000 (the card's wire gives the same bits)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        np.array([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8),
                  3.3895314e38, np.inf, -np.inf, 0.0, -0.0, 1e-40],
                 np.float32)])
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = rc.bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    nan = np.array([0x7FC00000, 0xFFA00001, 0x7F800001], np.uint32).view(
        np.float32)
    got = rc.bf16_round(torch.from_numpy(nan)).numpy()
    assert _bits(got).tolist() == [0x7FC00000] * 3


def _payload(shape, op, seed):
    rng = np.random.default_rng(seed)
    if op == "prod":   # keep the product well-conditioned
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("op,size", [("sum", 23), ("sum", 1000),
                                     ("sum", 65536), ("max", 1000),
                                     ("min", 23), ("prod", 1000)])
def test_all_reduce_wire16_matches_reference(mesh, op, size):
    import jax

    x = _payload((8, size), op, seed=size)
    want = np.asarray(pc.all_reduce(jax.device_put(x), mesh, "x", op,
                                    variant="wire16"))
    t = torch.from_numpy(x)
    _assert_bits(rc.all_reduce(t, 8, op, "wire16"), want)
    _assert_bits(rc.all_reduce_wire16_plain(t, 8, op), want)
    if op == "sum":     # and it is not the exact ring: the wire rounded
        assert not torch.equal(rc.all_reduce(t, 8, op, "fused"),
                               rc.all_reduce(t, 8, op, "wire16"))


@pytest.mark.parametrize("op,payload", [("sum", (23,)), ("sum", (5, 200)),
                                        ("sum", (8192,)), ("max", (23,)),
                                        ("prod", (5, 200))])
def test_reduce_scatter_wire16_matches_reference(mesh, op, payload):
    import jax

    x = _payload((8, 8, *payload), op, seed=len(payload) + payload[-1])
    want = np.asarray(pc.reduce_scatter(jax.device_put(x), mesh, "x", op,
                                        variant="wire16"))
    t = torch.from_numpy(x)
    _assert_bits(rc.reduce_scatter(t, 8, op, "wire16"), want)
    _assert_bits(rc.reduce_scatter_wire16_plain(t, 8, op), want)


def test_wire16_takes_float32_only():
    before = dict(rc.launches)
    for dt in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(ValueError):
            rc.all_reduce(torch.ones(8, 64, dtype=dt), 8, variant="wire16")
        with pytest.raises(ValueError):
            rc.reduce_scatter(torch.ones(8, 8, 4, dtype=dt), 8,
                              variant="wire16")
    assert rc.launches == before


def test_wire16_single_rank_is_a_copy():
    """n == 1 returns the row unrounded, as the reference's mesh of one
    returns its input."""
    x = torch.tensor([[1.0 + 2 ** -10, 3.0]])
    assert torch.equal(rc.all_reduce(x, 1, "sum", "wire16"), x[0])


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K17, K18, K19, K7 and K5's wire16 form against their plain versions
    on the card, bit for bit outside NaN (run on a machine with a card;
    skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def same(got, want):
        got, want = got.cpu(), want.cpu()
        nan = torch.isnan(want) if want.is_floating_point() else None
        if nan is not None:
            assert torch.equal(torch.isnan(got), nan)
            got, want = got[~nan], want[~nan]
        assert torch.equal(got, want)

    for size in (1, 129, 70001):
        for k in (1, 2, 8):
            x = torch.from_numpy(_codec_input(k, size, seed=size + k))
            q, s = qo.encode_int8(x.cuda())
            pq_, ps = qo.encode_int8_plain(x.cuda())
            same(q, pq_)
            same(s, ps)
            same(qo.decode_int8(q, s), qo.decode_int8_plain(q, s))
            same(qo.dequant_accumulate(q, s),
                 qo.dequant_accumulate_plain(q, s))
    for size in (23, 1000, 65536):
        x = torch.from_numpy(_payload((8, size), "sum", size)).cuda()
        for op in OPS:
            same(rc.all_reduce(x, 8, op, "wire16"),
                 rc.all_reduce_wire16_plain(x, 8, op))
        y = torch.from_numpy(_payload((8, 8, size), "sum", size)).cuda()
        same(rc.reduce_scatter(y, 8, "sum", "wire16"),
             rc.reduce_scatter_wire16_plain(y, 8, "sum"))
