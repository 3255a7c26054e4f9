"""The port's flash-attention block update (ompi_tpu_torch/ops/flash_attention.py,
kernel K21) held against the JAX package's ``ompi_tpu.ops.flash_attention``.

Same numpy inputs to both.  The JAX side runs the Pallas kernel
``_update_pallas`` in interpret mode and its ``custom_vjp`` Functions; the
port its plain version (CPU tensors) and its ``torch.autograd.Function``s.

Bands, relative to the largest magnitude of each output: float32 within
1e-6 (the two sum the products in other orders; the reference's kernel
and its own jnp twin agree within 1e-7), bfloat16 within 2^-7, one bf16
ulp (the port follows the kernel's casts: float32 accumulation, p cast to
v's dtype before p v, each output rounded once).  Gradients (float32,
recomputed through the twin on both sides) within 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.ops import flash_attention as jfa
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import flash_attention as fa

BANDS = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
# (b, h, sq, skv, d): square blocks, and a ragged sq (not a multiple of 64
# or of the reference's 256-row tile) against a ragged skv
SHAPES = [(2, 2, 64, 64, 32), (1, 3, 200, 72, 16)]


def _t(a: np.ndarray) -> torch.Tensor:
    return cudaenv.make_world_array(np.array(a), "cpu")


def _causal(sq: int, skv: int, offset: int, dt) -> np.ndarray:
    """0/-inf: query i sees key j when i + offset >= j (every row sees at
    least key 0 for offset >= 0)."""
    keep = np.arange(sq)[:, None] + offset >= np.arange(skv)[None, :]
    return np.where(keep, 0.0, -np.inf).astype(dt)


def _inputs(shape, dt, seed):
    b, h, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dt)
    kv = [rng.standard_normal((b, h, skv, d)).astype(dt) for _ in range(4)]
    return q, kv


def _close(got: torch.Tensor, want, band: float, what: str):
    want = np.asarray(want).astype(np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want) & ~np.isinf(want)
    np.testing.assert_array_equal(got[~ok & ~np.isnan(want)],
                                  want[~ok & ~np.isnan(want)], err_msg=what)
    scale = max(float(np.max(np.abs(want[ok]))), 1e-30)
    err = float(np.max(np.abs(got[ok] - want[ok]))) / scale
    assert err <= band, f"{what}: {err:.3e} of max |want| > band {band:g}"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_chained_updates_match_pallas(shape, dtype, causal):
    """Step 1 from m = -inf (the diagonal block when causal), step 2
    chained on its outputs (a fully masked block when causal, which must
    leave the state as it was)."""
    dt = NP[dtype]
    b, h, sq, skv, d = shape
    q, (k1, v1, k2, v2) = _inputs(shape, dt, seed=sq + skv)
    m = np.full((b, h, sq), -np.inf, dt)
    num = np.zeros((b, h, sq, d), dt)
    den = np.zeros((b, h, sq), dt)
    bias1 = _causal(sq, skv, 0, dt) if causal else None
    bias2 = np.full((sq, skv), -np.inf, dt) if causal else None

    want1 = jfa._update_pallas(q, k1, v1, m, num, den, bias1, interpret=True)
    got1 = fa.update_plain(*map(_t, (q, k1, v1, m, num, den)),
                           None if bias1 is None else _t(bias1))
    for g, w, what in zip(got1, want1, "m num den".split()):
        assert g.dtype == _t(np.asarray(w)).dtype
        _close(g, w, BANDS[dtype], f"step 1 {what}")

    # step 2 from the reference's own state, so each step is held alone
    state = [np.asarray(w) for w in want1]
    want2 = jfa._update_pallas(q, k2, v2, *state, bias2, interpret=True)
    apply = (fa.flash_block_update if bias2 is None else
             lambda *a: fa.flash_block_update_biased(*a, _t(bias2)))
    got2 = apply(*map(_t, (q, k2, v2, *state)))
    for g, w, what in zip(got2, want2, "m num den".split()):
        _close(g, w, BANDS[dtype], f"step 2 {what}")
    if causal:
        for g, w in zip(got2, state):
            np.testing.assert_array_equal(cudaenv.to_numpy(g), w)


# (b, h, sq, skv, d) at the card kernel's edges: head dims off 16 bytes, off
# 4 elements (30, 66) and not powers of two, key counts of 1, one short of
# and one past a 64-key tile, one past the scores-on-chip cap at d = 256
# (320 keys) and a ragged last tile past every cap (1055).  At d = 200 and
# 256, and over 1055 keys, XLA's and torch's float32 products on the CPU
# already differ by 0.9e-6 to 1.05e-6 of max |want| (the order of sums of
# 200 terms and more, either state), at the float32 band itself: those
# shapes are held here in bfloat16, and in float32 on the card against the
# plain version.
EDGE_CASES = [(shape, dtype)
              for shape in [(1, 2, 8, 1, 100), (1, 1, 64, 257, 64),
                            (1, 1, 70, 255, 32), (1, 2, 200, 31, 100),
                            (1, 2, 200, 31, 30), (1, 1, 64, 257, 66)]
              for dtype in ("float32", "bfloat16")] + [
    ((1, 2, 200, 31, 200), "bfloat16"), ((1, 1, 16, 321, 256), "bfloat16"),
    ((1, 1, 70, 255, 130), "bfloat16"), ((1, 1, 16, 1055, 64), "bfloat16")]


@pytest.mark.parametrize("shape, dtype", EDGE_CASES)
def test_edge_shapes_match_pallas(shape, dtype):
    """The plain version against the Pallas kernel (interpret mode) at the
    card kernel's edge shapes, from a running state, with a causal bias
    whose first rows see a single key."""
    dt = NP[dtype]
    b, h, sq, skv, d = shape
    q, (k, v, _, _) = _inputs(shape, dt, seed=sq * skv + d)
    rng = np.random.default_rng(d)
    m = rng.standard_normal((b, h, sq)).astype(dt)
    num = rng.standard_normal((b, h, sq, d)).astype(dt)
    den = (1.0 + np.abs(rng.standard_normal((b, h, sq)))).astype(dt)
    bias = _causal(sq, skv, 0, dt)
    for bb in (None, bias):
        want = jfa._update_pallas(q, k, v, m, num, den, bb, interpret=True)
        got = fa.update_plain(*map(_t, (q, k, v, m, num, den)),
                              None if bb is None else _t(bb))
        for g, w, what in zip(got, want, "m num den".split()):
            _close(g, w, BANDS[dtype], f"{shape} bias={bb is not None} {what}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_from_minus_inf_is_nan(dtype):
    """A row with every key masked at m = -inf: c = exp(-inf + inf) is NaN
    in the reference, and in the port at the same places."""
    dt = NP[dtype]
    b, h, sq, skv, d = 1, 2, 8, 8, 4
    q, (k, v, _, _) = _inputs((b, h, sq, skv, d), dt, seed=3)
    m = np.full((b, h, sq), -np.inf, dt)
    num, den = np.zeros((b, h, sq, d), dt), np.zeros((b, h, sq), dt)
    bias = _causal(sq, skv, -4, dt)            # rows 0-3 see nothing
    want = jfa._update_pallas(q, k, v, m, num, den, bias, interpret=True)
    got = fa.update_plain(*map(_t, (q, k, v, m, num, den, bias)))
    for g, w, what in zip(got, want, "m num den".split()):
        assert np.isnan(np.asarray(w, np.float32)).any() or what == "m"
        _close(g, w, BANDS[dtype], what)


def test_per_rank_bias_is_each_rows_own():
    """A bias (R, sq, skv) with R a prefix of q's leading dims: row r of
    the leading dim gets bias r, as R separate reference calls give."""
    dt = np.float32
    R, h, sq, skv, d = 3, 2, 16, 16, 8
    q, (k, v, _, _) = _inputs((R, h, sq, skv, d), dt, seed=5)
    m = np.zeros((R, h, sq), dt)
    num, den = np.zeros((R, h, sq, d), dt), np.ones((R, h, sq), dt)
    bias = np.stack([_causal(sq, skv, 3 * r, dt) for r in range(R)])
    got = fa.update_plain(*map(_t, (q, k, v, m, num, den, bias)))
    for r in range(R):
        want = jfa._update_pallas(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                  m[r:r + 1], num[r:r + 1], den[r:r + 1],
                                  bias[r], interpret=True)
        for g, w in zip(got, want):
            _close(g[r:r + 1], w, BANDS["float32"], f"rank {r}")


@pytest.mark.parametrize("biased", [False, True])
def test_gradients_match_custom_vjp(biased):
    """Two chained updates from m = -inf under autograd against jax.grad
    through the reference's custom_vjp, in both forms (float32)."""
    shape = (2, 2, 32, 32, 8)
    b, h, sq, skv, d = shape
    q, (k1, v1, k2, v2) = _inputs(shape, np.float32, seed=11)
    rng = np.random.default_rng(12)
    wm, wd = (rng.standard_normal((b, h, sq)).astype(np.float32)
              for _ in range(2))
    wn = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    bias1 = _causal(sq, skv, 0, np.float32)
    bias2 = _causal(sq, skv, sq // 2, np.float32)

    def jloss(q_, k1_, v1_, k2_, v2_):
        m = jnp.full((b, h, sq), -jnp.inf)
        num, den = jnp.zeros((b, h, sq, d)), jnp.zeros((b, h, sq))
        if biased:
            st = jfa.flash_block_update_biased(q_, k1_, v1_, m, num, den, bias1)
            st = jfa.flash_block_update_biased(q_, k2_, v2_, *st, bias2)
        else:
            st = jfa.flash_block_update(q_, k1_, v1_, m, num, den)
            st = jfa.flash_block_update(q_, k2_, v2_, *st)
        m, num, den = st
        return jnp.sum(m * wm) + jnp.sum(num * wn) + jnp.sum(den * wd)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(q, k1, v1, k2, v2)

    xs = [_t(a).requires_grad_() for a in (q, k1, v1, k2, v2)]
    m = torch.full((b, h, sq), -math.inf)
    num, den = torch.zeros((b, h, sq, d)), torch.zeros((b, h, sq))
    if biased:
        st = fa.flash_block_update_biased(xs[0], xs[1], xs[2], m, num, den,
                                          _t(bias1))
        st = fa.flash_block_update_biased(xs[0], xs[3], xs[4], *st, _t(bias2))
    else:
        st = fa.flash_block_update(xs[0], xs[1], xs[2], m, num, den)
        st = fa.flash_block_update(xs[0], xs[3], xs[4], *st)
    m, num, den = st
    loss = (m * _t(wm)).sum() + (num * _t(wn)).sum() + (den * _t(wd)).sum()
    got = torch.autograd.grad(loss, xs)
    for g, w, what in zip(got, want, ["q", "k1", "v1", "k2", "v2"]):
        _close(g, w, 1e-5, f"d loss / d {what}")


def test_bias_gradient_flows():
    """The bias is differentiable, as in the reference's custom_vjp."""
    shape = (1, 2, 8, 8, 4)
    q, (k, v, _, _) = _inputs(shape, np.float32, seed=13)
    bias = np.random.default_rng(14).standard_normal((8, 8)).astype(np.float32)
    m = np.zeros((1, 2, 8), np.float32)
    num, den = np.zeros((1, 2, 8, 4), np.float32), np.ones((1, 2, 8), np.float32)

    def jloss(bias_):
        return jnp.sum(jfa.flash_block_update_biased(q, k, v, m, num, den,
                                                     bias_)[1])

    want = jax.grad(jloss)(bias)
    tb = _t(bias).requires_grad_()
    out = fa.flash_block_update_biased(*map(_t, (q, k, v, m, num, den)), tb)
    (got,) = torch.autograd.grad(out[1].sum(), [tb])
    _close(got, want, 1e-5, "d loss / d bias")


@pytest.mark.parametrize("bad, match", [
    (dict(k=torch.zeros(1, 2, 8, 3)), "k is"),
    (dict(m=torch.zeros(1, 2, 7)), "m is"),
    (dict(v=torch.zeros(1, 2, 8, 4, dtype=torch.bfloat16)), "share one dtype"),
    (dict(q=torch.zeros(1, 2, 8, 4, dtype=torch.float16),
          k=torch.zeros(1, 2, 8, 4, dtype=torch.float16),
          v=torch.zeros(1, 2, 8, 4, dtype=torch.float16)), "float32 or bfloat16"),
    (dict(bias=torch.zeros(3, 8, 8)), "prefix"),
    (dict(k=torch.zeros(1, 2, 0, 4), v=torch.zeros(1, 2, 0, 4),
          bias=None), "non-empty"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    args = dict(q=torch.zeros(1, 2, 8, 4), k=torch.zeros(1, 2, 8, 4),
                v=torch.zeros(1, 2, 8, 4), m=torch.zeros(1, 2, 8),
                num=torch.zeros(1, 2, 8, 4), den=torch.zeros(1, 2, 8),
                bias=torch.zeros(8, 8))
    args.update(bad)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.update(**args)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper computes update_plain and launches nothing."""
    before = fa.launches["flash_block"]
    q, (k, v, _, _) = _inputs((1, 2, 8, 8, 4), np.float32, seed=9)
    args = [_t(a) for a in (q, k, v)] + [torch.zeros(1, 2, 8),
                                         torch.zeros(1, 2, 8, 4),
                                         torch.ones(1, 2, 8)]
    for g, w in zip(fa.flash_block_update(*args), fa.update_plain(*args)):
        assert torch.equal(g, w)
    assert fa.launches["flash_block"] == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K21 against update_plain on the card, float32 and bfloat16,
    unbiased and per-rank causal, ragged sq (run on a machine with a card;
    skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in ("float32", "bfloat16"):
        for shape in SHAPES + [(8, 2, 256, 256, 256)]:
            dt = NP[dtype]
            b, h, sq, skv, d = shape
            q, (k, v, _, _) = _inputs(shape, dt, seed=sq)
            rng = np.random.default_rng(d)
            m = rng.standard_normal((b, h, sq)).astype(dt)
            num = rng.standard_normal((b, h, sq, d)).astype(dt)
            den = np.abs(rng.standard_normal((b, h, sq))).astype(dt)
            bias = np.stack([_causal(sq, skv, r, dt) for r in range(b)])
            for bb in (None, bias):
                host = [_t(a) for a in (q, k, v, m, num, den)] + [
                    None if bb is None else _t(bb)]
                card = [None if a is None else a.cuda() for a in host]
                before = fa.launches["flash_block"]
                got = fa.update(*card)
                torch.cuda.synchronize()
                assert fa.launches["flash_block"] == before + 1
                for g, w in zip(got, fa.update_plain(*card)):
                    _close(g.cpu(), cudaenv.to_numpy(w), BANDS[dtype],
                           f"K21 {dtype} {shape}")


def _card_args(shape, dtype, seed, bias=True, m_inf=False):
    """K21's operands on the card from a running state (or the first ring
    step's), with a per-rank causal bias (one block per leading row b)."""
    dt = NP[dtype]
    b, h, sq, skv, d = shape
    q, (k, v, _, _) = _inputs(shape, dt, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if m_inf:
        m = np.full((b, h, sq), -np.inf, dt)
        num, den = np.zeros((b, h, sq, d), dt), np.zeros((b, h, sq), dt)
    else:
        m = rng.standard_normal((b, h, sq)).astype(dt)
        num = rng.standard_normal((b, h, sq, d)).astype(dt)
        den = (1.0 + np.abs(rng.standard_normal((b, h, sq)))).astype(dt)
    args = [_t(a).cuda() for a in (q, k, v, m, num, den)]
    if bias:
        args.append(_t(np.stack([_causal(sq, skv, 3 * r, dt)
                                 for r in range(b)])).cuda())
    else:
        args.append(None)
    return args


def _held(got, args, dtype, what):
    for g, w in zip(got, fa.update_plain(*args)):
        _close(g.cpu(), cudaenv.to_numpy(w), BANDS[dtype], what)


#: head dims of the card edges: off 4 elements (30, 66, 130: the element
#: path and padded columns), off 16 bytes in bfloat16 (100, 200), powers of
#: two, one and two column groups
EDGE_D = (30, 32, 64, 66, 100, 128, 130, 200, 256)
#: key counts at which the block's scores stay on chip (64 x skv floats fit
#: beside Q and the stages: up to 320 at d = 256 in float32, more at smaller
#: d or in bfloat16) and at which they cannot at any d or dtype (the 64 x skv
#: floats alone, 270 KB at 1055 keys, are above the 227 KB a CTA may have),
#: so the second pass recomputes q k^T, the last tile ragged
SCORES_SKV, RECOMPUTE_SKV = 256, 1055


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 2, 200, skv, d) for d in EDGE_D
                                   for skv in (100, RECOMPUTE_SKV)]
                         + [(2, 2, 64, skv, 256)
                            for skv in (1, 31, 64, 255, 256, 257, 320, 321,
                                        1024, RECOMPUTE_SKV)])
def test_kernel_edges_on_card(shape, dtype):
    """K21 at its edges, unbiased and with a per-rank causal bias, in the
    second-pass form its shape takes: the scores on chip up to 320 keys (at
    d = 256 in float32), q k^T recomputed from 1024 keys at every d
    (skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for bias in (False, True):
        args = _card_args(shape, dtype, shape[3] + shape[4], bias)
        got = fa.update(*args)
        torch.cuda.synchronize()
        _held(got, args, dtype, f"K21 {dtype} {shape} bias={bias}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skv", [SCORES_SKV, RECOMPUTE_SKV])
def test_kernel_masking_on_card(skv, dtype):
    """A fully masked block chained from a running state leaves it
    bit-equal; a fully masked row from m = -inf gives NaN and no other row
    does, with the scores on chip and recomputed (skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = (2, 2, 64, skv, 256)
    args = _card_args(shape, dtype, 21, bias=False)
    args[-1] = torch.full(shape[2:4], -math.inf, device="cuda",
                          dtype=args[0].dtype)
    got = fa.update(*args)
    for g, w in zip(got, args[3:6]):
        assert torch.equal(g, w)
    args = _card_args(shape, dtype, 22, bias=False, m_inf=True)
    mask = torch.zeros(shape[2:4], device="cuda", dtype=args[0].dtype)
    mask[:16] = -math.inf
    args[-1] = mask
    got = fa.update(*args)
    assert bool(torch.isnan(got[1][..., :16, :]).all())
    assert not bool(torch.isnan(got[1][..., 16:, :]).any())
    _held(got, args, dtype, f"K21 masked rows {dtype} skv={skv}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [100, 256])
def test_kernel_misaligned_base_on_card(d, dtype):
    """q, k, v as views at storage offset 1 (contiguous, not 16-byte
    aligned): the kernel takes its element path, within the bands, with
    the scores on chip and recomputed (skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for skv in (SCORES_SKV, RECOMPUTE_SKV):
        args = _card_args((2, 2, 64, skv, d), dtype, 31, bias=True)
        for i in range(3):
            buf = torch.empty(args[i].numel() + 1, device="cuda",
                              dtype=args[i].dtype)
            view = buf[1:].view(args[i].shape)
            view.copy_(args[i])
            assert view.data_ptr() % 16 != 0
            args[i] = view
        got = fa.update(*args)
        _held(got, args, dtype, f"K21 offset 1 {dtype} d={d} skv={skv}")
