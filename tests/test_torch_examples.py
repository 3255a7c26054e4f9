"""The port's device-world examples (``ompi_tpu_torch/examples/``) held
against the JAX package's ``examples/`` on the same seed-0 inputs.

The port runs each example's ``main`` in this process with ``--device
cpu`` (the kernels' plain versions).  The reference runs its own functions
on the 8-virtual-CPU-device mesh, Pallas in interpret mode, or its example
script in a subprocess where the script pins its platform itself.  Bands,
stated per comparison:

* ``ragged_dispatch``: the valid rows byte-equal both ways; the KiB line
  letter for letter;
* ``device_collectives``: allreduce ``rtol 1e-4`` / ``atol 1e-5``, the
  fused matmul ``1e-3`` / ``1e-3`` (the reference example's own bands),
  the torus reduce-scatter as allreduce; the bcast, the duplex gather and
  the torus gather bit-exact;
* ``train_tour`` (``OTPU_MODEL_SCALE=1``, 8 virtual ranks): each float32
  configuration's losses before and after its update within ``F32_BAND``
  relative of the reference tour's, each bfloat16 one within ``BF16_BAND``
  (``tests/test_torch_parallel.py``'s bands), and zero1's and the works'
  third step, where momentum reaches the loss; ``train_sharded`` within
  ``F32_BAND``.

Pinned divergences: the owner classes ``device_collectives`` prints are
the port's (``BuiltinCollModule``, ``RingCollModule``); ``train_tour`` and
``train_sharded`` take ``--lr`` (default the reference's 1e-4), since at
``OTPU_MODEL_SCALE=64`` the reference's lr overshoots.
"""
import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ompi_tpu.base.var import registry as jreg
from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu.ops import pallas_overlap as po
from ompi_tpu.parallel import dryrun as jdryrun
from ompi_tpu.parallel import train as jtrain  # noqa: F401  (registers the knobs)
from ompi_tpu_torch.examples import (connectivity, device_collectives, hello,
                                     ragged_dispatch, train_sharded,
                                     train_tour)
from ompi_tpu_torch.parallel import train as ttrain  # noqa: F401  (the knobs)
from ompi_tpu_torch.runtime import init as trt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_BAND, BF16_BAND = 1e-5, 4 * 2.0 ** -7
CPU = ["--device", "cpu"]


def _run(main, argv=CPU) -> tuple:
    """``main(argv)`` in a fresh port world: (its return value, stdout)."""
    trt.reset_for_testing()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = main(list(argv))
    finally:
        trt.reset_for_testing()
    return result, out.getvalue()


def _reference_env() -> dict:
    """The reference's examples on the CPU, the repo root importable."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def _reference_script(name: str, timeout: int = 120) -> str:
    """The reference example's stdout (it pins its own platform)."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples", name)],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=REPO, env=_reference_env())
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _mesh(*shape, names=("x",)):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape or (8,)), names)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


# -- ragged_dispatch --------------------------------------------------------

def test_ragged_dispatch_matches_reference_both_ways():
    got, said = _run(ragged_dispatch.main)
    counts, tokens = got["counts"], got["tokens"]
    mesh = _mesh(names=("ep",))
    ref = np.asarray(pc.all_to_all_v(jnp.asarray(tokens), counts, mesh, "ep"))
    ref_back = np.asarray(pc.all_to_all_v(jnp.asarray(ref), counts.T, mesh,
                                          "ep"))
    n = counts.shape[0]
    for i in range(n):
        for j in range(n):
            c = counts[i, j]
            assert got["dispatched"][j, i, :c].tobytes() == \
                ref[j, i, :c].tobytes()
            assert got["combined"][i, j, :c].tobytes() == \
                ref_back[i, j, :c].tobytes()
    assert said.splitlines() == [
        ln for ln in _reference_script("ragged_dispatch.py").splitlines()
        if ln.startswith(("dispatch verified", "combine"))]


# -- device_collectives -----------------------------------------------------

@pytest.fixture(scope="module")
def collectives():
    got, said = _run(device_collectives.main)
    return got, said


def _collective_inputs():
    """The example's inputs, drawn in its order from its seed."""
    n = 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 1024)).astype(np.float32)
    a = rng.standard_normal((n, 64, 16)).astype(np.float32)
    b = rng.standard_normal((n, 16, 32)).astype(np.float32)
    g = rng.standard_normal((n, 256)).astype(np.float32)
    x2 = rng.standard_normal((n, n, 128)).astype(np.float32)
    return x, a, b, g, x2


def test_device_collectives_allreduce_and_bcast_match_reference(collectives):
    from ompi_tpu.runtime import init as jrt
    import ompi_tpu

    got, _ = collectives
    x = _collective_inputs()[0]
    jrt.reset_for_testing()
    try:
        jw = ompi_tpu.init()
        want = np.asarray(jw.allreduce_array(x))
    finally:
        jrt.reset_for_testing()
    np.testing.assert_allclose(got["allreduce_builtin"], want, rtol=1e-4,
                               atol=1e-5)
    mesh = _mesh()
    ring = np.asarray(pc.all_reduce(jnp.asarray(x), mesh, "x", "sum"))
    np.testing.assert_allclose(got["allreduce_ring"], ring, rtol=1e-4,
                               atol=1e-5)
    bc = np.asarray(pc.bcast(jnp.asarray(x), mesh, "x", root=7))
    assert got["bcast"].tobytes() == bc.tobytes()


def test_device_collectives_fused_matmul_matches_reference(collectives):
    got, _ = collectives
    _, a, b, _, _ = _collective_inputs()
    want = np.asarray(po.matmul_allreduce(jnp.asarray(a), jnp.asarray(b),
                                          _mesh(), "x", interpret=True))
    np.testing.assert_allclose(got["matmul_allreduce"], want, rtol=1e-3,
                               atol=1e-3)


def test_device_collectives_duplex_and_torus_match_reference(collectives):
    got, _ = collectives
    *_, g, x2 = _collective_inputs()
    bidi = np.asarray(pc.all_gather(jnp.asarray(g), _mesh(), "x",
                                    variant="bidi"))
    assert got["all_gather_bidi"].tobytes() == bidi.tobytes()
    mesh2 = _mesh(2, 4, names=("x", "y"))
    rs = np.asarray(pc.reduce_scatter_torus(jnp.asarray(x2), mesh2))
    np.testing.assert_allclose(got["reduce_scatter_torus"], rs, rtol=1e-4,
                               atol=1e-5)
    ag = np.asarray(pc.all_gather_torus(jnp.asarray(g), mesh2))
    assert got["all_gather_torus"].tobytes() == ag.tobytes()


def test_device_collectives_prints_the_ports_owners_divergence_pinned(
        collectives):
    """The reference names its owners ``XlaCollModule`` and
    ``PallasCollModule``; the port prints its own classes, and every other
    line is the reference's."""
    _, said = collectives
    ref = _reference_script("device_collectives.py")
    renamed = ref.replace("XlaCollModule", "BuiltinCollModule").replace(
        "PallasCollModule", "RingCollModule")
    assert said.splitlines() == renamed.splitlines()
    assert "via BuiltinCollModule: ok" in said
    assert "via RingCollModule: ok" in said
    assert "Xla" not in said and "Pallas" not in said
    assert said.splitlines()[-1] == "DEVICE COLLECTIVES OK"


# -- train_tour, train_sharded ----------------------------------------------

_PAIR = re.compile(r"^dryrun ok: mesh=.* loss ([-\d.e+]+) -> ([-\d.e+]+)$",
                   re.M)


def _pairs(said: str) -> list:
    """Each ``dryrun ok`` line's losses before and after the update."""
    return [tuple(map(float, m)) for m in _PAIR.findall(said)]


def _reference_tour() -> tuple:
    """The reference tour's first losses by tag, and its stdout."""
    devs = jax.devices()[:8]
    spec = jdryrun.parse_spec(train_tour.SPEC)
    saved = {k: jreg.lookup(k).value for k in train_tour.KNOBS}
    losses, out = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            for tag, over in train_tour.CONFIGS.items():
                for k, dv in train_tour.KNOBS.items():
                    jreg.lookup(k).set(over.get(k, dv))
                losses[tag] = float(jdryrun.run_training_step(devs, spec))
    finally:
        for k, v in saved.items():
            jreg.lookup(k).set(v)
    return losses, out.getvalue()


def _band(tag: str) -> float:
    bf16 = train_tour.CONFIGS[tag].get(
        "otpu_parallel_compute_dtype") == "bfloat16"
    return BF16_BAND if bf16 else F32_BAND


def test_train_tour_losses_match_reference(monkeypatch):
    """Each configuration's loss before and after its update (so remat's
    backward and ZeRO-1's reduce-scatter and sharded update are held too)."""
    monkeypatch.setenv("OTPU_MODEL_SCALE", "1")
    got, said = _run(train_tour.main)
    want, ref_said = _reference_tour()
    assert list(got) == list(want) == [
        "baseline", "causal", "remat", "bf16", "zero1", "the works"]
    got_pairs, want_pairs = _pairs(said), _pairs(ref_said)
    assert len(got_pairs) == len(want_pairs) == 6
    for (tag, ref), g2, w2 in zip(want.items(), got_pairs, want_pairs):
        band = _band(tag)
        assert _rel(got[tag]["loss"], ref) <= band, (tag, got[tag], ref)
        assert all(_rel(a, b) <= band for a, b in zip(g2, w2)), (tag, g2, w2)
        assert f"{tag:10s} loss {got[tag]['loss']:10.4f}" in said
        assert got[tag]["launches"] == 0      # the CPU lane: plain versions
    assert said.splitlines()[-1] == "TRAIN TOUR OK"
    for k, v in train_tour.KNOBS.items():
        from ompi_tpu_torch.base.var import registry

        assert registry.lookup(k).value == v   # restored


def _three_steps(reg, make, over, momentum=None) -> list:
    """Three losses of ``make()``'s step under the tour's knobs ``over``.
    With ``momentum`` the heavy ball is added to the step's parameters
    here, ``p' = step(p) + mu (p - p_prev)`` (for a plain SGD step)."""
    saved = {k: reg.lookup(k).value for k in train_tour.KNOBS}
    try:
        for k, dv in train_tour.KNOBS.items():
            reg.lookup(k).set(over.get(k, dv))
        step, (state, x), _ = make()
        losses, prev = [], None
        for _ in range(3):
            new, loss = step(state, x)
            losses.append(float(loss))
            if momentum is not None:
                if prev is not None:
                    new = {k: v + momentum * (state[k] - prev[k])
                           for k, v in new.items()}
                prev = state
            state = new
    finally:
        for k, v in saved.items():
            reg.lookup(k).set(v)
    return losses


@pytest.mark.parametrize("tag", ["zero1", "the works"])
def test_train_tour_momentum_step_matches_reference(tag, monkeypatch):
    """A third step, where ZeRO-1's sharded momentum first reaches the
    loss: against the reference's on the same parameters at the tour's
    band, and within ``F32_BAND`` of the port's plain SGD step with the
    heavy ball added outside it, which differs from plain SGD."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import dryrun

    monkeypatch.setenv("OTPU_MODEL_SCALE", "1")
    over = train_tour.CONFIGS[tag]
    mu = over["otpu_parallel_momentum"]

    def port():
        return dryrun.make_step_and_args("cpu", dryrun.parse_spec(
            train_tour.SPEC))

    got = _three_steps(registry, port, over)
    want = _three_steps(jreg, lambda: jdryrun.make_step_and_args(
        jax.devices()[:8], jdryrun.parse_spec(train_tour.SPEC)), over)
    assert all(_rel(a, b) <= _band(tag) for a, b in zip(got, want)), (got, want)
    sgd_over = dict(over, otpu_parallel_zero1=False, otpu_parallel_momentum=0.0)
    ball = _three_steps(registry, port, sgd_over, momentum=mu)
    sgd = _three_steps(registry, port, sgd_over)
    assert all(_rel(a, b) <= F32_BAND for a, b in zip(got, ball)), (got, ball)
    assert got[:2] == sgd[:2] and _rel(got[2], sgd[2]) > 1e-3, (got, sgd)


def test_train_sharded_loss_matches_reference(monkeypatch):
    monkeypatch.setenv("OTPU_MODEL_SCALE", "1")
    got, said = _run(train_sharded.main)
    ref_said = io.StringIO()
    with contextlib.redirect_stdout(ref_said):
        want = float(jdryrun.run_training_step(jax.devices()[:8]))
    assert _rel(got, want) <= F32_BAND
    got_pairs, want_pairs = _pairs(said), _pairs(ref_said.getvalue())
    assert len(got_pairs) == len(want_pairs) == 2
    for g2, w2 in zip(got_pairs, want_pairs):
        assert all(_rel(a, b) <= F32_BAND for a, b in zip(g2, w2)), (g2, w2)
    assert said.splitlines()[-1] == f"done; initial loss {got:.4f}"


@pytest.mark.parametrize("example", [train_tour, train_sharded])
def test_lr_switch_divergence_pinned(example, monkeypatch):
    """The reference's tour and flagship demo train at lr 1e-4 with no
    switch; the port's take ``--lr``, default 1e-4 (at
    ``OTPU_MODEL_SCALE=64`` the card trains at 1e-5)."""
    from ompi_tpu_torch.parallel import dryrun

    seen = []

    def fake(device=None, spec=None, lr=1e-4):
        seen.append(lr)
        return 1.0

    monkeypatch.setattr(dryrun, "run_training_step", fake)
    _run(example.main)
    _run(example.main, CPU + ["--lr", "1e-5"])
    runs = len(seen) // 2
    assert seen == [1e-4] * runs + [1e-5] * runs and runs >= 1


# -- hello, connectivity in the device world ---------------------------------

@pytest.mark.parametrize("example", [hello, connectivity])
def test_device_world_lines_match_reference(example):
    _, said = _run(example.main)
    name = example.__name__.rsplit(".", 1)[1]
    ref = _reference_script(f"{name}.py").replace(
        "ompi_tpu ", "ompi_tpu_torch ")
    assert said.splitlines() == ref.splitlines()
    assert said.startswith(("Hello, world, I am 0 of 8",
                            "connectivity OK: 8 ranks fully connected"))
