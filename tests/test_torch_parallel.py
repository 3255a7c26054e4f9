"""The port's flagship training step (ompi_tpu_torch/parallel/*) held against
the JAX package's ``ompi_tpu.parallel``.

Same numpy inputs and the same ``init_params`` bytes go through both.  The
JAX side runs ``shard_map`` on the 8-virtual-CPU-device mesh (its flash
block in Pallas interpret mode), the port runs per-rank tensors on the CPU
(K21's plain version).  Bands, stated per comparison:

* collectives of ``parallel/axes.py`` on integer-valued float32: exact;
* attention and the pipeline against dense references: 2e-5 (the
  reference's own tests' band);
* the whole step in float32: loss within 1e-5 relative; each leaf's
  gradient (both steps built with lr = 1.0, so params − new params is the
  gradient) within 1e-5 of its largest magnitude.  Measured: ~3e-7;
* the whole step in bfloat16 compute: loss within 1e-3 relative, each
  gradient within 4·2^-7 (four bf16 ulps) of its largest magnitude: the
  two packages round the bf16 activations after sums taken in other
  orders.  Measured: up to 1.4e-2.
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from ompi_tpu.base.jaxenv import shard_map
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.parallel import mesh as jm
from ompi_tpu.parallel import model as jmodel
from ompi_tpu.parallel import train as jt
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.ops import flash_attention as fa
from ompi_tpu_torch.parallel import axes, dryrun, model, pipeline, train
from ompi_tpu_torch.parallel.mesh import (AXES, MeshSpec, default_axis_sizes,
                                          make_mesh)

DEFAULT = dict(dp=2, pp=1, sp=2, tp=2)
PP2 = dict(dp=1, pp=2, sp=2, tp=2)
F32_BAND, BF16_BAND = 1e-5, 4 * 2.0 ** -7


@contextlib.contextmanager
def parallel_vars(**values):
    """Set ``otpu_parallel_<name>`` in both packages' registries."""
    saved = []
    try:
        for reg in (jreg, treg):
            for name, value in values.items():
                var = reg.lookup(f"otpu_parallel_{name}")
                saved.append((var, var.value))
                var.set(value)
        yield
    finally:
        for var, value in reversed(saved):
            var.set(value)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# -- mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n, want", [
    (8, MeshSpec(dp=2, pp=1, sp=2, tp=2)),
    (16, MeshSpec(dp=2, pp=2, sp=2, tp=2)),
    (1, MeshSpec()),
])
def test_default_axis_sizes(n, want):
    assert default_axis_sizes(n) == want
    assert default_axis_sizes(n).sizes() == jm.default_axis_sizes(n).sizes()


@pytest.mark.parametrize("n", [4, 12, 6, 32])
def test_default_axis_sizes_cover_the_world(n):
    assert default_axis_sizes(n).n == n
    assert default_axis_sizes(n).sizes() == jm.default_axis_sizes(n).sizes()


def test_make_mesh_checks_the_world_size():
    mesh, spec = make_mesh(8, device="cpu")
    assert mesh.dims == (2, 1, 2, 2) and spec == default_axis_sizes(8)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices, got 4"):
        make_mesh(4, MeshSpec(**DEFAULT))
    with pytest.raises(NotImplementedError):
        make_mesh(4, MeshSpec(ep=4))


# -- the collectives of a shard_map body ----------------------------------

MESH_DIMS = (2, 1, 2, 2)

COLLECTIVES = {
    # name: (local shape, port fn, jax fn on one device's slice)
    "psum_dp_sp": ((3, 4), lambda t: axes.psum(t, ("dp", "sp")),
                   lambda a: jax.lax.psum(a, ("dp", "sp"))),
    "psum_all": ((5,), lambda t: axes.psum(t, AXES),
                 lambda a: jax.lax.psum(a, AXES)),
    "ppermute_sp": ((3, 2), lambda t: axes.ppermute_next(t, "sp"),
                    lambda a: jax.lax.ppermute(a, "sp", [(0, 1), (1, 0)])),
    "all_to_all_tp_0_1": ((4, 6), lambda t: axes.all_to_all(t, "tp", 0, 1),
                          lambda a: jax.lax.all_to_all(a, "tp", 0, 1,
                                                       tiled=True)),
    "all_to_all_sp_1_0": ((3, 4, 2), lambda t: axes.all_to_all(t, "sp", 1, 0),
                          lambda a: jax.lax.all_to_all(a, "sp", 1, 0,
                                                       tiled=True)),
    "all_to_all_sp_2_1": ((2, 2, 4, 3),
                          lambda t: axes.all_to_all(t, "sp", 2, 1),
                          lambda a: jax.lax.all_to_all(a, "sp", 2, 1,
                                                       tiled=True)),
    "all_to_all_untiled": ((2, 3, 2),
                           lambda t: axes.all_to_all_untiled(t, "tp", 0),
                           lambda a: jax.lax.all_to_all(a, "tp", 0, 0)),
    "all_gather_tp": ((3, 2), lambda t: axes.all_gather(t, "tp", 0),
                      lambda a: jax.lax.all_gather(a, "tp", axis=0,
                                                   tiled=True)),
    "psum_scatter_dp": ((2, 5), lambda t: axes.psum_scatter(t, "dp", 0),
                        lambda a: jax.lax.psum_scatter(
                            a, "dp", scatter_dimension=0, tiled=False)),
    "take_own_tp": ((4, 3), lambda t: axes.take_own(t, "tp", 0),
                    lambda a: jax.lax.dynamic_slice_in_dim(
                        a, jax.lax.axis_index("tp") * 2, 2, 0)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_matches_lax(name):
    """Each primitive on a (2, 1, 2, 2) mesh against its jax.lax twin in a
    shard_map over the 8 devices, on integer-valued float32: exact."""
    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    local, port_fn, jax_fn = COLLECTIVES[name]
    x = np.random.default_rng(len(name)).integers(
        -50, 50, MESH_DIMS + local).astype(np.float32)
    jmesh = JMesh(np.array(devs).reshape(MESH_DIMS), AXES)
    spec = P(*AXES)
    want = jax.jit(shard_map(
        lambda a: jax_fn(a[0, 0, 0, 0])[None, None, None, None],
        mesh=jmesh, in_specs=spec, out_specs=spec, check_vma=False))(x)
    got = port_fn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- attention and the pipeline --------------------------------------------

def _dense(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("impl", ["ring_flash", "ring_plain", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_dense(impl, causal):
    """Ring attention (flash path and plain path) and Ulysses over sp = 4
    against unsharded attention; causal against the masked reference."""
    sp, b, h, s, hd = 4, 2, 4, 16, 8
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((b, h, s, hd)).astype(np.float32)
               for _ in range(3))

    def per_rank(a):   # (b, h, s, hd) -> (1, 1, sp, 1, b, h, s/sp, hd)
        a = a.reshape(b, h, sp, s // sp, hd).transpose(2, 0, 1, 3, 4)
        return torch.from_numpy(np.ascontiguousarray(a))[None, None, :, None]

    tq, tk, tv = map(per_rank, (q, k, v))
    before = fa.launches["flash_block"]
    if impl == "ulysses":
        out = model.ulysses_attention(tq, tk, tv, "sp", sp, causal=causal)
    else:
        out = model.ring_attention(tq, tk, tv, "sp", sp, causal=causal,
                                   use_flash=impl == "ring_flash")
    assert fa.launches["flash_block"] == before      # the CPU launches nothing
    got = out[0, 0, :, 0].numpy().transpose(1, 2, 0, 3, 4).reshape(b, h, s, hd)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), rtol=2e-5,
                               atol=2e-5)


def test_ring_attention_gradient_matches_jax_single_shard():
    """n_shards = 1, causal: the flash path's gradient (recompute through
    the twin) against the reference's, through its custom_vjp."""
    b, h, s, hd = 1, 2, 8, 4
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b, h, s, hd)).astype(np.float32)
               for _ in range(3))
    want = jax.grad(lambda qq: jnp.sum(jmodel.ring_attention(
        qq, k, v, "sp", 1, use_flash=True, causal=True) ** 2))(q)
    tq = torch.from_numpy(q)[None, None, None, None].requires_grad_()
    out = model.ring_attention(tq, torch.from_numpy(k)[None, None, None, None],
                               torch.from_numpy(v)[None, None, None, None],
                               "sp", 1, use_flash=True, causal=True)
    (got,) = torch.autograd.grad((out ** 2).sum(), [tq])
    assert _rel(got[0, 0, 0, 0].numpy(), want) <= 1e-5


def test_pipeline_matches_sequential():
    """pp = 4 stages of tanh(z @ w_i) over M = 3 microbatches: the last
    stage collects the sequential stack, the others hold zeros."""
    pp, M, mb, d = 4, 3, 2, 4
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (M, mb, d)).astype(np.float32)
    w = rng.normal(0, 0.5, (pp, d, d)).astype(np.float32)
    tw = torch.from_numpy(w)[None, :, None, None]            # (1, pp, 1, 1, d, d)
    tx = torch.from_numpy(x).expand(1, pp, 1, 1, M, mb, d)
    out = pipeline.pipeline_apply(lambda wi, z: torch.tanh(z @ wi), tw, tx,
                                  pp=pp)
    ref = x
    for i in range(pp):
        ref = np.tanh(ref @ w[i])
    np.testing.assert_allclose(out[0, pp - 1, 0, 0].numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    assert not out[0, :pp - 1].any()


def _block_params(d, ff, E, ffe, seed, wr_zero=False):
    rng = np.random.default_rng(seed)
    p = {"w1": rng.normal(0, 0.3, (d, ff)), "w2": rng.normal(0, 0.3, (ff, d)),
         "wr": rng.normal(0, 0.3, (d, E)),
         "we1": rng.normal(0, 0.3, (E, d, ffe)),
         "we2": rng.normal(0, 0.3, (E, ffe, d))}
    if wr_zero:
        p["wr"] = np.zeros((d, E))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _one_rank(a):
    return torch.from_numpy(np.asarray(a))[None, None, None, None]


def test_mlp_block_uses_the_tanh_gelu():
    """jax.nn.gelu defaults to the tanh form; so does the port's MLP (the
    exact erf form differs from it by ~1e-3)."""
    p = _block_params(8, 16, 2, 4, seed=6)
    x = np.random.default_rng(7).standard_normal((2, 4, 8)).astype(np.float32)
    want = np.asarray(jmodel.mlp_block(p, x, tp=1))
    got = model.mlp_block({k: _one_rank(v) for k, v in p.items()},
                          _one_rank(x), tp=1)[0, 0, 0, 0].numpy()
    assert _rel(got, want) <= 1e-6
    erf = x + (torch.nn.functional.gelu(
        torch.from_numpy(np.array(jmodel.rmsnorm(x))) @ torch.from_numpy(p["w1"]))
        @ torch.from_numpy(p["w2"])).numpy()
    assert _rel(erf, want) > 1e-5


@pytest.mark.parametrize("wr_zero", [False, True])
def test_moe_block_matches_reference(wr_zero):
    """Top-1 routing with capacity overflow; with wr = 0 every router logit
    ties and both packages send every token to expert 0 (argmax's first
    index), so all but `capacity` tokens fall through on the residual."""
    d, E, cap = 8, 4, 3
    p = _block_params(d, 16, E, 4, seed=8, wr_zero=wr_zero)
    x = np.random.default_rng(9).standard_normal((2, 4, d)).astype(np.float32)
    want = np.asarray(jmodel.moe_block(p, x, tp=1, n_experts=E, capacity=cap))
    got = model.moe_block({k: _one_rank(v) for k, v in p.items()},
                          _one_rank(x), tp=1, n_experts=E,
                          capacity=cap)[0, 0, 0, 0].numpy()
    assert _rel(got, want) <= 1e-6
    if wr_zero:
        moved = np.any(got != x, axis=-1).reshape(-1)
        assert moved.tolist() == [True] * cap + [False] * (8 - cap)


# -- the whole step --------------------------------------------------------

def _run_both(sd, steps=1, lr=1.0, layers=None):
    """``steps`` steps of both packages from the same init and input;
    returns (p0, [(jax loss, port loss)], jax state, port state)."""
    js, ts = jm.MeshSpec(**sd), MeshSpec(**sd)
    dims = jt.model_dims(js, layers)
    x = np.random.RandomState(1).normal(
        0, 1, (dims["batch"], dims["seq"], dims["d"]))
    p0 = jt.init_params(js, layers=layers)
    jmesh, _ = jm.make_mesh(jax.devices()[:js.n], js)
    jstep, jplace = jt.build_train_step(jmesh, js, lr=lr, layers=layers)
    jstate, jx = jplace(p0, x)
    tmesh, _ = make_mesh(ts.n, ts, device="cpu")
    tstep, tplace = train.build_train_step(tmesh, ts, lr=lr, layers=layers)
    tstate, tx = tplace(p0, x)
    losses = []
    for _ in range(steps):
        jstate, jl = jstep(jstate, jx)
        tstate, tl = tstep(tstate, tx)
        losses.append((float(jl), float(tl)))
    return p0, losses, jstate, tstate


MODES = {
    "default": {},
    "causal": {"causal": True},
    "ulysses": {"sp_impl": "ulysses"},
    "remat": {"remat": True},
    "bucket_overlap": {"bucket_overlap": True},
    "zero1": {"zero1": True},
    "bfloat16": {"compute_dtype": "bfloat16"},
}


@pytest.mark.parametrize("mesh", ["default", "pp2"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_matches_jax(mode, mesh):
    """One step of each mode on the default and the pp = 2 mesh: the loss
    and every leaf's gradient against the JAX step's."""
    with parallel_vars(**MODES[mode]):
        p0, losses, jstate, tstate = _run_both(
            DEFAULT if mesh == "default" else PP2)
    jp = jstate[0] if isinstance(jstate, tuple) else jstate
    tp = tstate[0] if isinstance(tstate, tuple) else tstate
    band = BF16_BAND if mode == "bfloat16" else F32_BAND
    (jl, tl), = losses
    assert math.isfinite(tl)
    assert abs(tl - jl) <= (1e-3 if mode == "bfloat16" else 1e-5) * abs(jl)
    got = train.gather_params(tp)
    for k in sorted(p0):
        rel = _rel(p0[k] - got[k], p0[k] - np.asarray(jp[k]))
        assert rel <= band, f"{mode}/{mesh} gradient of {k}: {rel:.3e}"


@pytest.mark.parametrize("mesh", ["default", "pp2"])
def test_zero1_momentum_two_steps_match_jax(mesh):
    """ZeRO-1 with momentum 0.9 over two steps: parameters and the
    dp-sharded momentum (global layout ``P(("dp", "pp", "tp"))``) against
    the reference's."""
    with parallel_vars(zero1=True, momentum=0.9):
        p0, losses, (jp, jmom), (tp, tmom) = _run_both(
            DEFAULT if mesh == "default" else PP2, steps=2, lr=0.05)
    for jl, tl in losses:
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    got = train.gather_params(tp)
    for k in sorted(p0):
        assert _rel(p0[k] - got[k], p0[k] - np.asarray(jp[k])) <= F32_BAND, k
    mom = tmom[:, :, 0].reshape(-1).numpy()      # sp holds copies
    assert _rel(mom, np.asarray(jmom)) <= F32_BAND
    assert np.array_equal(tmom[:, :, 0].numpy(), tmom[:, :, 1].numpy())


def test_gradient_scale_is_the_references():
    """The update is dp·sp times the loss's gradient (wr: dp·sp·tp): the
    reference's dp/sp psum runs on gradients its autodiff already summed
    over the replicas.  Pinned against autograd of the port's own loss."""
    spec = MeshSpec(**DEFAULT)
    mesh, _ = make_mesh(8, spec, device="cpu")
    step, place = train.build_train_step(mesh, spec, lr=1.0)
    dims = train.model_dims(spec)
    x = np.random.RandomState(1).normal(0, 1, (dims["batch"], dims["seq"],
                                               dims["d"]))
    p0 = train.init_params(spec)
    params, xd = place(p0, x)
    new, _ = step(params, xd)
    got = train.gather_params(new)
    # the loss as a function of ONE global parameter set
    glob = {k: torch.from_numpy(v).requires_grad_() for k, v in p0.items()}
    specs = train.param_specs()
    leaves = {k: train.shard(glob[k], specs[k], mesh) for k in glob}
    loss = _loss_of(spec, leaves, xd)
    grads = torch.autograd.grad(loss, [glob[k] for k in sorted(glob)])
    for k, g in zip(sorted(glob), grads):
        scale = 2 * 2 * (2 if k == "wr" else 1)
        assert _rel(p0[k] - got[k], scale * g.numpy()) <= 1e-5, k


def _loss_of(spec, leaves, xd):
    """The step's loss (float32, one layer a stage) on given per-rank
    leaves, written out from the reference's loss_fn."""
    dims = train.model_dims(spec)
    M, mb, s_l, d = dims["M"], dims["mb"], dims["s_local"], dims["d"]
    names = sorted(leaves)

    def stage_fn(ps, x_mb):
        layer = {k: ps[k].select(axes.MESH_NDIM, 0) for k in names}
        return model.transformer_block(
            layer, x_mb, sp=spec.sp, tp=spec.tp,
            n_heads_local=dims["h_local"], n_experts=dims["n_experts"],
            capacity=dims["capacity"])

    xmb = xd.reshape(*xd.shape[:4], M, mb, s_l, d)
    y = pipeline.pipeline_apply(stage_fn, leaves, xmb, pp=spec.pp)
    local = 0.5 * (y * y).sum(dim=tuple(range(4, y.dim())))
    local = torch.where(axes.axis_index(local, "tp") == 0, local, 0.0)
    return local.sum()


def test_pp2_matches_pp1_same_model():
    """The same 2-layer model stepped on pp = 2 (8 ranks) and pp = 1 (4
    ranks) in the port: the same loss and gradients — pipelining is an
    execution schedule, not a different function."""
    out = {}
    for name, sd in (("pp2", PP2), ("pp1", dict(dp=1, pp=1, sp=2, tp=2))):
        spec = MeshSpec(**sd)
        mesh, _ = make_mesh(spec.n, spec, device="cpu")
        step, place = train.build_train_step(mesh, spec, lr=1.0, layers=2)
        dims = train.model_dims(spec, layers=2)
        x = np.random.RandomState(7).normal(0, 1, (dims["batch"], dims["seq"],
                                                   dims["d"]))
        p0 = train.init_params(spec, seed=3, layers=2)
        new, loss = step(*place(p0, x))
        out[name] = (float(loss), {k: p0[k] - v for k, v in
                                   train.gather_params(new).items()})
    (l2, g2), (l1, g1) = out["pp2"], out["pp1"]
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    for k in g2:
        assert _rel(g2[k], g1[k]) <= F32_BAND, k


def test_bucket_overlap_check_is_bit_identical(capsys):
    dryrun.run_bucket_overlap_check(device="cpu")
    assert "params bit-identical" in capsys.readouterr().out


def test_run_training_step_descends_on_both_meshes(capsys):
    loss = dryrun.run_training_step(device="cpu")
    assert math.isfinite(loss)
    out = capsys.readouterr().out
    assert "mesh={'dp': 2, 'pp': 1, 'sp': 2, 'tp': 2}" in out
    assert "mesh={'dp': 1, 'pp': 2, 'sp': 2, 'tp': 2}" in out


def test_make_step_and_args_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        dryrun.make_step_and_args()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        make_mesh(8)


def test_parse_spec_matches_reference():
    assert dryrun.parse_spec("dp=1,pp=2,sp=2,tp=2") == MeshSpec(**PP2)
    from ompi_tpu.parallel.dryrun import parse_spec

    assert parse_spec("dp=1, pp=2,sp=2,tp=2").sizes() == \
        dryrun.parse_spec("dp=1, pp=2,sp=2,tp=2").sizes()


@pytest.mark.parametrize("values", [
    {"momentum": 0.9},
    {"zero1": True, "bucket_overlap": True},
])
def test_forbidden_combinations_raise_the_references_text(values):
    errors = []
    with parallel_vars(**values):
        for build, mk in ((jt.build_train_step,
                           lambda s: jm.make_mesh(jax.devices()[:8], s)[0]),
                          (train.build_train_step,
                           lambda s: make_mesh(8, s, device="cpu")[0])):
            spec = (jm.MeshSpec if build is jt.build_train_step
                    else MeshSpec)(**DEFAULT)
            with pytest.raises(ValueError) as exc:
                build(mk(spec), spec)
            errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_ulysses_indivisible_heads_raises_the_references_text():
    b, s_l, d = 1, 4, 8
    x = np.ones((b, s_l, d), np.float32)
    p = {k: np.ones((d, 4), np.float32) for k in ("wq", "wk", "wv")}
    p["wo"] = np.ones((4, d), np.float32)
    with pytest.raises(ValueError) as want:
        jmodel.attention_block(p, x, sp=2, tp=1, n_heads_local=1,
                               sp_impl="ulysses")
    with pytest.raises(ValueError) as got:
        model.attention_block({k: _one_rank(v) for k, v in p.items()},
                              _one_rank(x), sp=2, tp=1, n_heads_local=1,
                              sp_impl="ulysses")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name, default, bad", [
    ("sp_impl", "ring", "zigzag"), ("compute_dtype", "float32", "float16")])
def test_enum_vars_match_reference(name, default, bad):
    tvar, jvar = (r.lookup(f"otpu_parallel_{name}") for r in (treg, jreg))
    assert tvar.default == jvar.default == default
    assert tvar.enum_values == jvar.enum_values
    for var in (tvar, jvar):
        with pytest.raises(ValueError, match="invalid enum value"):
            var.set(bad)
    assert sorted(v.name for v in treg.all_vars("parallel")) == sorted(
        v.name for v in jreg.all_vars("parallel") if v.name in {
            f"otpu_parallel_{n}" for n in ("sp_impl", "causal", "remat",
                                           "zero1", "bucket_overlap",
                                           "momentum", "compute_dtype")})


@pytest.mark.cuda
def test_step_on_card_launches_k21_per_ring_step():
    """On the card the step's ring attention launches K21 once per ring
    step: (M + pp − 1) × layers_local × sp a step, none in the backward
    (run on a machine with a card; skipped here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for sd, want in ((DEFAULT, 4), (PP2, 6)):
        step, (params, xd), _ = dryrun.make_step_and_args(spec=MeshSpec(**sd))
        before = fa.launches["flash_block"]
        _, loss = step(params, xd)
        torch.cuda.synchronize()
        assert fa.launches["flash_block"] - before == want
        assert math.isfinite(float(loss))
