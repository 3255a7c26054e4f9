"""The port's MoE tier (ompi_tpu_torch/parallel/moe.py, mca/coll/tuned.py,
parallel/{elastic,dryrun,mesh,axes}.py) held against the JAX package's
``ompi_tpu.parallel.moe`` and friends.

Same numpy inputs go through both packages.  Bands, stated per comparison:

* the gating, the elastic helpers, the int8 dispatch packing, the dispatch
  through the device worlds and the tolerance reports: bit-exact (numpy
  integer arithmetic, round-half-even, and the same float32 operations in
  the same order);
* the expert-axis collectives on integer-valued float32: exact;
* the expert-parallel block and step in float32: within 1e-5 of the largest
  magnitude (loss: relative), as the two packages take their matmuls' sums
  in other orders.  Measured: ~1e-7;
* ``expert_ffn_fused``: the fused cell (K20's plain version) against the
  unfused einsum within 2e-4, the reference's own test's band.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from ompi_tpu.base.jaxenv import shard_map
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.parallel import dryrun as jdryrun
from ompi_tpu.parallel import elastic as jelastic
from ompi_tpu.parallel import mesh as jm
from ompi_tpu.parallel import moe as jmoe
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.mca.coll import tuned
from ompi_tpu_torch.ops import overlap
from ompi_tpu_torch.ops import ring_collectives as rc
from ompi_tpu_torch.parallel import axes, dryrun, elastic, moe
from ompi_tpu_torch.parallel.mesh import AXES, EXPERT_AXIS, MeshSpec, make_mesh
from test_torch_world import jax_world, ring_worlds, torch_world  # noqa: F401

EP_SPEC = dict(dp=2, ep=4)
MOE_AXES = AXES + (EXPERT_AXIS,)
MOE_DIMS = (2, 1, 1, 1, 4)
#: the var the device tier reads, and those only the host trainer reads
#: (``MoeTrainer``, not ported yet: the port registers them with it)
VARS = ("capacity_factor",)
TRAINER_VARS = ("n_experts", "top_k", "drop_policy", "hot_expert",
                "hot_boost", "compute_us_per_token")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _np(t):
    return cudaenv.to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _jmesh(spec: dict):
    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return jm.make_mesh(devs, jm.MeshSpec(**spec))[0]


# -- vars and the pure gating ---------------------------------------------

@pytest.mark.parametrize("name", VARS)
def test_vars_match_reference(name):
    j, t = jreg.lookup(f"otpu_moe_{name}"), treg.lookup(f"otpu_moe_{name}")
    assert j is not None and t is not None
    assert (t.vtype.value, t.default, t.enum_values) == \
        (j.vtype.value, j.default, j.enum_values)


@pytest.mark.parametrize("name", TRAINER_VARS)
def test_trainer_vars_wait_for_the_trainer(name):
    """ROADMAP C: a var the port would accept and never read is not
    registered; it comes with ``MoeTrainer``, its reader."""
    assert jreg.lookup(f"otpu_moe_{name}") is not None
    assert treg.lookup(f"otpu_moe_{name}") is None


@pytest.mark.parametrize("args", [
    dict(step=0, tokens=32, n_experts=8, top_k=2, capacity_factor=1.25),
    dict(step=3, tokens=64, n_experts=8, top_k=3, capacity_factor=1.0, seed=5),
    dict(step=7, tokens=40, n_experts=4, top_k=1, capacity_factor=0.5, seed=2),
    dict(step=1, tokens=48, n_experts=8, top_k=2, capacity_factor=1.25,
         hot_expert=3, hot_boost=0.6),
    dict(step=2, tokens=16, n_experts=6, top_k=6, capacity_factor=2.0, seed=9),
])
def test_plans_equal_the_references(args):
    """Seeds, a hot expert and drops: the same plan, field by field."""
    jp, tp = jmoe.plan_step(**args), moe.plan_step(**args)
    assert tp.to_json() == jp.to_json()
    assert (tp.kept, tp.dropped, tp.loads) == (jp.kept, jp.dropped, jp.loads)
    assert tp.imbalance() == jp.imbalance()
    if args.get("capacity_factor") == 0.5 or args.get("hot_boost"):
        assert tp.dropped
    score_args = {k: args[k] for k in ("step", "tokens", "n_experts")}
    extra = {k: args[k] for k in ("seed", "hot_expert", "hot_boost") if k in args}
    np.testing.assert_array_equal(moe.gate_scores(**score_args, **extra),
                                  jmoe.gate_scores(**score_args, **extra))


def test_plan_step_rejects_bad_top_k():
    for k in (0, 5):
        with pytest.raises(ValueError, match="top_k"):
            moe.plan_step(0, 8, 4, k, 1.0)
        with pytest.raises(ValueError, match="top_k"):
            jmoe.plan_step(0, 8, 4, k, 1.0)


@pytest.mark.parametrize("k", range(1, 6))
def test_gate_weights_and_capacity(k):
    assert moe.gate_weights(k) == jmoe.gate_weights(k)
    assert sum(moe.gate_weights(k)) == 1.0
    for tokens, experts, factor in ((32, 8, 1.25), (7, 3, 0.1), (100, 16, 2.0)):
        assert moe.capacity_for(tokens, experts, k, factor) == \
            jmoe.capacity_for(tokens, experts, k, factor)


def test_reference_moe_run_and_elastic_helpers_bit_identical():
    w0 = np.random.default_rng(4).standard_normal(8 * 6)
    kw = dict(tokens=24, n_experts=8, expert_dim=6, top_k=2, seed=3,
              hot_expert=1, hot_boost=0.3)
    np.testing.assert_array_equal(_bits(moe.reference_moe_run(w0, 2, 6, **kw)),
                                  _bits(jmoe.reference_moe_run(w0, 2, 6, **kw)))
    assert (elastic.DEFAULT_LR, elastic._P1, elastic._P2, elastic._P3) == \
        (jelastic.DEFAULT_LR, jelastic._P1, jelastic._P2, jelastic._P3)
    for args in ((3, 0, 17, 5, 2), (0, 4, 9, 3, 0)):
        np.testing.assert_array_equal(_bits(elastic.grad_field(*args)),
                                      _bits(jelastic.grad_field(*args)))
    np.testing.assert_array_equal(moe.token_grad(5, 11, 7, 1),
                                  jmoe.token_grad(5, 11, 7, 1))
    for rank in range(5):
        assert elastic.partition(rank, 5, 23) == jelastic.partition(rank, 5, 23)
    np.testing.assert_array_equal(
        _bits(elastic.reference_run(w0[:5], 1, 4, 12, seed=2)),
        _bits(jelastic.reference_run(w0[:5], 1, 4, 12, seed=2)))


# -- the int8 dispatch packing --------------------------------------------

@pytest.mark.parametrize("shape", [(3, 512), (2, 5, 2048), (2, 2, 4, 1024)])
def test_int8_packing_bit_identical(shape):
    """Round-half-even, x·127/amax, little-endian lanes, float32 scale bits
    padded to 128 lanes: the same int32 slab, and the same decode."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[..., 0, :128] = 0.0                          # an all-zero block
    x[..., -1, 128:256] = np.arange(128) - 63.5    # exact .5 steps
    want = np.asarray(jmoe.encode_dispatch_int8(x))
    got = moe.encode_dispatch_int8(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    W = shape[-1]
    np.testing.assert_array_equal(
        _bits(moe.decode_dispatch_int8(got, W).numpy()),
        _bits(np.asarray(jmoe.decode_dispatch_int8(want, W))))
    # a ragged slice of rows decodes alike
    np.testing.assert_array_equal(
        _bits(moe.decode_dispatch_int8(got[..., :1, :], W).numpy()),
        _bits(np.asarray(jmoe.decode_dispatch_int8(want[..., :1, :], W))))


def test_int8_packing_rejects_unblockable_widths():
    for w in (100, 640):
        with pytest.raises(ValueError, match="width % 512"):
            moe.encode_dispatch_int8(np.zeros((2, w), np.float32))
    with pytest.raises(ValueError, match="scale budget"):
        moe.encode_dispatch_int8(np.zeros((1, 129 * 128 + 384), np.float32))


# -- dispatch through the device worlds -----------------------------------

def _dispatch_inputs():
    n, R, W = 8, 4, 512
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n, n, R, W)).astype(np.float32)
    counts = rng.integers(0, R + 1, (n, n)).astype(np.int32)
    counts[2] = 0           # a rank that sends nothing
    counts[:, 6] = 0        # a rank that receives nothing
    return x, counts


def _dispatch_both(jw, tw):
    """dispatch_tokens through both worlds, without and with the budget;
    returns [(jax outs, port outs, jax codec, port codec)] and each
    package's (quant_encodes, quant_decodes) deltas over both calls."""
    from ompi_tpu.runtime import spc as jspc
    from ompi_tpu_torch.runtime import spc as tspc

    names = ("quant_encodes", "quant_decodes")
    before = [[s.read(k) for k in names] for s in (jspc, tspc)]
    x, counts = _dispatch_inputs()
    runs = [(*jmoe.dispatch_tokens(jw, x, counts),
             *moe.dispatch_tokens(tw, x, counts))]
    jc, tc = jw.dup(), tw.dup()
    jc.info.set("otpu_quant_budget", "0.02")
    tc.info.set("otpu_quant_budget", "0.02")
    runs.append((*jmoe.dispatch_tokens(jc, x, counts),
                 *moe.dispatch_tokens(tc, x, counts)))
    deltas = [tuple(s.read(k) - b for k, b in zip(names, bs))
              for s, bs in zip((jspc, tspc), before)]
    return runs, deltas


def _check_dispatch(runs):
    x, counts = _dispatch_inputs()
    for (jouts, jcodec, touts, tcodec), codec in zip(runs, (None, "int8")):
        assert jcodec == tcodec == codec
        for i in range(8):
            for j in range(8):
                got, want = _np(touts[i][j]), _np(jouts[i][j])
                assert got.shape == want.shape == (int(counts[j][i]), 512)
                np.testing.assert_array_equal(_bits(got), _bits(want))
                if codec:
                    atol = float(np.abs(x[j, i]).max()) / 127.0
                    np.testing.assert_allclose(got, x[j, i, :counts[j][i]],
                                               atol=atol)
                else:
                    np.testing.assert_array_equal(got, x[j, i, :counts[j][i]])


def test_dispatch_tokens_matches_reference(jax_world, torch_world):
    """Without a budget the raw float32 rows, with 0.02 the int8 int32 slab
    decoded on arrival: bit for bit the reference's, at default priorities
    (coll/builtin against coll/xla)."""
    runs, _ = _dispatch_both(jax_world, torch_world)
    _check_dispatch(runs)


def test_dispatch_tokens_on_the_raised_ring(ring_worlds, monkeypatch):
    """The same through coll/ring (against coll/pallas), K15's plain
    version on the CPU: one all_to_all_v call each, the budgeted one on the
    int32 slab."""
    jw, tw = ring_worlds
    seen, real = [], rc.all_to_all_v
    monkeypatch.setattr(rc, "all_to_all_v",
                        lambda *a, **k: seen.append(a[0].dtype) or real(*a, **k))
    runs, _ = _dispatch_both(jw, tw)
    _check_dispatch(runs)
    assert seen == [torch.float32, torch.int32]


def test_dispatch_tokens_falls_back_for_thin_rows(torch_world):
    x = np.random.default_rng(2).standard_normal((8, 8, 4, 128)).astype(
        np.float32)
    c = torch_world.dup()
    c.info.set("otpu_quant_budget", "0.02")
    _outs, codec = moe.dispatch_tokens(c, x, np.full((8, 8), 4))
    assert codec is None


def test_dispatch_tokens_bumps_no_spc_counter(jax_world, torch_world):
    """SPC parity (the name kept from when the port had no SPC runtime):
    both packages record n * n quant_encodes and quant_decodes for the
    budgeted dispatch (moe.py:726, :730) and none for the exact one."""
    _runs, (want, got) = _dispatch_both(jax_world, torch_world)
    assert got == want == (64, 64)


def test_run_quant_dispatch_check_matches_reference(capsys):
    """The int8-packed ragged exchange (K15's plain version here, the
    reference's Pallas kernel in interpret mode on 4 devices) against the
    dispatch permutation: identical reports, inside the int8 band."""
    want = jmoe.run_quant_dispatch_check(nranks=4, sizes=(1 << 14,))
    got = moe.run_quant_dispatch_check(nranks=4, sizes=(1 << 14,),
                                       device="cpu")
    assert got == want and all(r <= 1.0 / 127 for r in got.values())
    assert "tolerance dryrun ok: alltoallv 1 cells" in capsys.readouterr().out


def test_run_tolerance_check_matches_reference(capsys):
    def bf16(stack):
        s = np.sum(stack.astype(np.float64), axis=0).astype(np.float32)
        return (s.view(np.uint32) & 0xFFFF0000).view(np.float32)

    kw = dict(sizes=(1 << 8, 1 << 10), dtypes=("float32", "float64"),
              nranks=3, band=0.01, seed=4)
    assert dryrun.run_tolerance_check("allreduce", bf16, **kw) == \
        jdryrun.run_tolerance_check("allreduce", bf16, **kw)
    kw["band"] = 1e-4
    with pytest.raises(RuntimeError) as jerr:
        jdryrun.run_tolerance_check("allreduce", bf16, **kw)
    with pytest.raises(RuntimeError) as terr:
        dryrun.run_tolerance_check("allreduce", bf16, **kw)
    assert str(terr.value) == str(jerr.value)
    assert "(allreduce, 256, float32)" in str(terr.value)


# -- the ep > 1 mesh and the expert-axis collectives ----------------------

def test_make_mesh_appends_the_expert_axis():
    mesh, spec = make_mesh(8, MeshSpec(**EP_SPEC), device="cpu")
    jmesh = _jmesh(EP_SPEC)
    assert mesh.names == tuple(jmesh.axis_names) == MOE_AXES
    assert mesh.dims == tuple(jmesh.devices.shape) == MOE_DIMS
    assert spec.sizes() == jm.MeshSpec(**EP_SPEC).sizes()
    dense, _ = make_mesh(8, MeshSpec(dp=2, sp=2, tp=2), device="cpu")
    assert dense.names == AXES and dense.dims == (2, 1, 2, 2)


EX = axes.MeshAxes(MOE_AXES)
EXPERT_COLLECTIVES = {
    # name: (local shape, port fn, jax fn on one device's slice)
    "psum_expert": ((3, 4), lambda t: EX.psum(t, EXPERT_AXIS),
                    lambda a: jax.lax.psum(a, EXPERT_AXIS)),
    "psum_dp_expert": ((5,), lambda t: EX.psum(t, ("dp", EXPERT_AXIS)),
                       lambda a: jax.lax.psum(a, ("dp", EXPERT_AXIS))),
    "all_to_all_expert_0_0": (
        (4, 2, 3), lambda t: EX.all_to_all(t, EXPERT_AXIS, 0, 0),
        lambda a: jax.lax.all_to_all(a, EXPERT_AXIS, 0, 0, tiled=True)),
    "all_to_all_expert_1_0": (
        (2, 8, 3), lambda t: EX.all_to_all(t, EXPERT_AXIS, 1, 0),
        lambda a: jax.lax.all_to_all(a, EXPERT_AXIS, 1, 0, tiled=True)),
    "all_gather_expert": ((3, 2), lambda t: EX.all_gather(t, EXPERT_AXIS, 0),
                          lambda a: jax.lax.all_gather(a, EXPERT_AXIS, axis=0,
                                                       tiled=True)),
    "axis_index_expert": (
        (2,), lambda t: t + EX.axis_index(t, EXPERT_AXIS, 1).float(),
        lambda a: a + jax.lax.axis_index(EXPERT_AXIS).astype(a.dtype)),
    "take_own_expert": ((8, 3), lambda t: EX.take_own(t, EXPERT_AXIS, 0),
                        lambda a: jax.lax.dynamic_slice_in_dim(
                            a, jax.lax.axis_index(EXPERT_AXIS) * 2, 2, 0)),
    "psum_dp": ((4,), lambda t: EX.psum(t, "dp"),
                lambda a: jax.lax.psum(a, "dp")),
}


@pytest.mark.parametrize("name", sorted(EXPERT_COLLECTIVES))
def test_expert_collective_matches_lax(name):
    """Each primitive on the (2, 1, 1, 1, 4) mesh against its jax.lax twin
    in a shard_map over the 8 devices, on integer-valued float32: exact."""
    local, port_fn, jax_fn = EXPERT_COLLECTIVES[name]
    jmesh = _jmesh(EP_SPEC)
    x = np.random.default_rng(len(name)).integers(
        -50, 50, MOE_DIMS + local).astype(np.float32)
    spec = P(*MOE_AXES)
    want = jax.jit(shard_map(
        lambda a: jax_fn(a[0, 0, 0, 0, 0])[None, None, None, None, None],
        mesh=jmesh, in_specs=spec, out_specs=spec, check_vma=False))(x)
    got = port_fn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_axes_are_the_module_functions():
    assert axes.DENSE.names == AXES and axes.MESH_NDIM == 4
    assert axes.psum.__self__ is axes.DENSE


# -- the expert-parallel block and step -----------------------------------

@pytest.mark.parametrize("probs", [
    [[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3], [0.4, 0.2, 0.4, 0.0]],
    [[0.0, 0.5, 0.5, 0.0], [0.3, 0.3, 0.1, 0.3], [0.2, 0.2, 0.2, 0.4]],
])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_to_the_lower_expert(probs, k):
    p = np.asarray(probs, np.float32)
    _, want = jax.lax.top_k(p, k)
    got = moe.top_k_indices(torch.from_numpy(p), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_both(spec: dict, params, x, capacity=None):
    """moe_ep_block in a shard_map over the reference mesh and on the
    port's per-rank tensors; returns the two global outputs."""
    js, ts = jm.MeshSpec(**spec), MeshSpec(**spec)
    dims = jmoe.moe_model_dims(js)
    kw = dict(ep=js.ep, n_experts=dims["n_experts"],
              capacity=capacity or dims["capacity"], top_k=dims["top_k"])
    jmesh = _jmesh(spec)
    pspecs = jmoe.moe_param_specs(P, js)
    want = jax.jit(shard_map(
        lambda p, a: jmoe.moe_ep_block(p, a, **kw), mesh=jmesh,
        in_specs=(pspecs, P("dp", None)), out_specs=P("dp", None),
        check_vma=False))(params, x)
    tmesh, _ = make_mesh(8, ts, device="cpu")
    _, place = moe.build_moe_train_step(tmesh, ts)
    tp, tx = place(params, x)
    got = moe.moe_ep_block(tp, tx, mesh_axes=axes.MeshAxes(tmesh.names), **kw)
    from ompi_tpu_torch.parallel.train import gather

    return gather(got, moe.X_SPEC, tmesh.names), np.asarray(want)


@pytest.mark.parametrize("case", ["random", "tied_router", "overflow"])
def test_moe_ep_block_matches_reference(case):
    """Random weights; a zero router (every probability ties, so both pick
    experts 0 and 1, and all but `capacity` tokens overflow onto the
    residual path); a capacity of 1 (positions past capacity clamp into the
    one-hot and the keep mask zeroes them)."""
    js = jm.MeshSpec(**EP_SPEC)
    params = jmoe.init_moe_params(js, seed=3)
    if case == "tied_router":
        params["wr"] = np.zeros_like(params["wr"])
    dims = jmoe.moe_model_dims(js)
    x = np.random.RandomState(5).normal(
        0, 1, (dims["tokens"], dims["d"])).astype(np.float32)
    got, want = _block_both(EP_SPEC, params, x,
                            capacity=1 if case == "overflow" else None)
    assert _rel(got, want) <= 1e-6
    if case == "tied_router":
        moved = np.any(got != x, axis=-1).reshape(2, 4, 4)
        # each expert rank's chunk of 4 tokens: both experts take the first
        # `capacity` of them, the rest keep x
        cap = dims["capacity"]
        assert moved[..., :cap].all() and not moved[..., cap:].any()


def test_moe_ep_block_ep1_matches_reference():
    spec = dict(dp=8)
    js = jm.MeshSpec(**spec)
    params = jmoe.init_moe_params(js, seed=1)
    dims = jmoe.moe_model_dims(js)
    x = np.random.RandomState(2).normal(
        0, 1, (dims["tokens"], dims["d"])).astype(np.float32)
    got, want = _block_both(spec, params, x)
    assert _rel(got, want) <= 1e-6


def _steps_both(spec: dict, steps: int):
    js, ts = jm.MeshSpec(**spec), MeshSpec(**spec)
    dims = jmoe.moe_model_dims(js)
    x = np.random.RandomState(0).normal(
        0, 1, (dims["tokens"], dims["d"])).astype(np.float32)
    p0 = jmoe.init_moe_params(js)
    jstep, jplace = jmoe.build_moe_train_step(_jmesh(spec), js)
    jp, jx = jplace(p0, x)
    tmesh, _ = make_mesh(8, ts, device="cpu")
    tstep, tplace = moe.build_moe_train_step(tmesh, ts)
    tp, tx = tplace(p0, x)
    losses = []
    for _ in range(steps):
        jp, jl = jstep(jp, jx)
        tp, tl = tstep(tp, tx)
        losses.append((float(jl), float(tl)))
    return p0, losses, jp, moe.gather_moe_params(tp, ts, tmesh)


@pytest.mark.parametrize("spec", [EP_SPEC, dict(dp=8)],
                         ids=["dp2_ep4", "dp8_ep1"])
def test_step_matches_jax(spec):
    """Three steps: the loss curve and each leaf after them within 1e-5 of
    the JAX step's (the update scale is the reference's: every leaf's
    gradient psum'd over dp, wr's over expert as well; at dp = 8 that
    scale makes lr = 0.02 overshoot in both packages)."""
    p0, losses, jp, tp = _steps_both(spec, 3)
    for jl, tl in losses:
        assert math.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl)
    for k in sorted(p0):
        assert _rel(tp[k], np.asarray(jp[k])) <= 1e-5, k
        assert _rel(p0[k] - tp[k], p0[k] - np.asarray(jp[k])) <= 1e-5, k


def test_run_moe_training_step_is_bit_stable(capsys):
    """The dryrun: two fresh builds give one loss curve (it raises
    otherwise), descending, within 1e-5 of the reference's dryrun."""
    got = moe.run_moe_training_step(device="cpu")
    out = capsys.readouterr().out
    assert "moe dryrun ok: mesh={'dp': 2, 'pp': 1, 'sp': 1, 'tp': 1, 'ep': 4}" in out
    want = jmoe.run_moe_training_step(jax.devices())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w)


def test_run_moe_training_step_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.run_moe_training_step()


# -- coll/tuned's device cell and the fused expert FFN --------------------

def test_tuned_var_matches_reference(torch_world, jax_world):
    j = jreg.lookup("otpu_coll_tuned_fused_cells")
    t = treg.lookup("otpu_coll_tuned_fused_cells")
    assert (t.vtype.value, t.default) == (j.vtype.value, j.default) == \
        ("string", "")
    assert (tuned.COMPONENT.name, tuned.COMPONENT.priority) == ("tuned", 30)
    assert tuned.DEVICE_CELLS == ("matmul_allreduce", "matmul_reduce_scatter")


def test_tuned_leaves_every_slot_owner_unchanged(torch_world):
    """A config home: comm_query answers None, so no module joins the
    comm: at default priorities coll/builtin owns every slot it fills (the
    device slots) and coll/conductor the host slots."""
    from ompi_tpu_torch.api.comm import COLL_FUNCTIONS
    from ompi_tpu_torch.mca.coll.base import coll_framework
    from ompi_tpu_torch.mca.coll.builtin import BuiltinCollModule

    assert "tuned" in coll_framework().components
    assert tuned.COMPONENT.comm_query(torch_world) is None
    assert [type(m).__name__ for m in torch_world.coll_modules] == \
        ["ConductorModule", "RingCollModule", "BuiltinCollModule"]
    for slot in COLL_FUNCTIONS:
        if slot not in torch_world.c_coll:
            continue
        want = ("BuiltinCollModule" if hasattr(BuiltinCollModule, slot)
                else "ConductorModule")
        assert type(torch_world.c_coll[slot].__self__).__name__ == want, slot


def test_expert_ffn_fused_matches_unfused(torch_world):
    """The fused cell (matmul_allreduce) and the unfused einsum agree, and
    the one force-var governs the device tier ('off' and the other cell
    disable this one), as in the reference's test."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 8, 16)).astype(np.float32)
    b = rng.standard_normal((4, 16, 8)).astype(np.float32)
    assert tuned.device_cell("matmul_allreduce") is overlap.matmul_allreduce
    fused = moe.expert_ffn_fused(torch.from_numpy(a), torch.from_numpy(b))
    try:
        treg.set("otpu_coll_tuned_fused_cells", "off")
        assert tuned.device_cell("matmul_allreduce") is None
        assert tuned.device_cell("matmul_reduce_scatter") is None
        unfused = moe.expert_ffn_fused(a, b, device="cpu")
        treg.set("otpu_coll_tuned_fused_cells", "matmul_reduce_scatter")
        assert tuned.device_cell("matmul_allreduce") is None
        assert tuned.device_cell("matmul_reduce_scatter") is \
            overlap.matmul_reduce_scatter
    finally:
        treg.set("otpu_coll_tuned_fused_cells", "")
    ref = np.einsum("nmk,nko->mo", a, b)
    np.testing.assert_allclose(fused.numpy(), ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(unfused.numpy(), ref, rtol=2e-4, atol=2e-4)
    with pytest.raises(KeyError):
        tuned.device_cell("bogus_cell")


def test_expert_ffn_fused_is_the_references_on_integers(torch_world, jax_world):
    """On integer-valued inputs the fused cell is bit for bit the
    reference's cell (its Pallas kernel in interpret mode on 4 devices)."""
    rng = np.random.default_rng(6)
    a = rng.integers(-6, 7, (4, 12, 16)).astype(np.float32)
    b = rng.integers(-6, 7, (4, 16, 8)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:4]), (EXPERT_AXIS,))
    want = np.asarray(jmoe.expert_ffn_fused(a, b, jmesh))
    got = moe.expert_ffn_fused(a, b, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


# -- on the card (skipped here) -------------------------------------------

@pytest.mark.cuda
def test_expert_ffn_fused_launches_k20_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ompi_tpu_torch.mca.coll.base import coll_framework

    coll_framework().open()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((8, 100, 24), generator=gen, device="cuda")
    b = torch.randn((8, 24, 40), generator=gen, device="cuda")
    before = dict(overlap.launches)
    fused = moe.expert_ffn_fused(a, b)
    torch.cuda.synchronize()
    assert overlap.launches["matmul_allreduce"] == \
        before["matmul_allreduce"] + 1
    treg.set("otpu_coll_tuned_fused_cells", "off")
    try:
        unfused = moe.expert_ffn_fused(a, b)
    finally:
        treg.set("otpu_coll_tuned_fused_cells", "")
    assert overlap.launches["matmul_allreduce"] == \
        before["matmul_allreduce"] + 1
    scale = torch.einsum("nmk,nko->mo", a.abs(), b.abs()).max()
    assert (fused - unfused).abs().max() <= 1e-5 * scale


@pytest.mark.cuda
def test_moe_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = moe.run_moe_training_step()
    want = moe.run_moe_training_step(device="cpu")
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w)
