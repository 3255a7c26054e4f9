"""coll/algorithms and coll/tuned's host ladder on the CPU lane, held
against the JAX package's: every entry of the nine menus runs SPMD with one
thread per rank over ``as_rank`` (the harness of
``tests/test_coll_algorithms.py``) on both packages' device worlds, over 8,
6 and 5 ranks (pof2 and not), at sizes around each schedule's edges (fewer
elements than ranks, one per rank, odd blocks), in float64, float32 and
int32 and with a non-commutative op; every rank's result must be
bit-identical to the reference's.  Then the fixed ladder
(``default_algorithm``, ``ladder_rules``) over a grid of collectives, comm
sizes and sizes around every threshold, the rules files (good and each
malformed kind), the force vars, an unknown algorithm's fallback, the eager
lane, and the schedule cache's SPC hits and misses.
"""
import contextlib
import threading
import traceback
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch

PKGS = ("jax", "torch")


def _ns(pkg):
    root = pkg.__name__
    mod = __import__
    return SimpleNamespace(
        pkg=pkg,
        algs=mod(f"{root}.mca.coll.algorithms", fromlist=["x"]),
        tuned=mod(f"{root}.mca.coll.tuned", fromlist=["x"]),
        op=mod(f"{root}.api.op", fromlist=["x"]),
        spc=mod(f"{root}.runtime.spc", fromlist=["x"]),
        registry=mod(f"{root}.base.var", fromlist=["x"]).registry,
        coll_framework=mod(f"{root}.mca.coll.base",
                           fromlist=["x"]).coll_framework)


NS = {"jax": _ns(ompi_tpu), "torch": _ns(ompi_tpu_torch)}


@pytest.fixture(scope="module")
def comms():
    """{pkg: {nranks: comm}}: each package's device world of 8 ranks and
    its sub-comms of ranks 0-5 and 0-4."""
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    tw = ompi_tpu_torch.init(device="cpu")
    out = {}
    for name, w in (("jax", jw), ("torch", tw)):
        out[name] = {8: w}
        for k in (6, 5):
            out[name][k] = w.create(w.group.incl(list(range(k))))
    yield out
    jrt.reset_for_testing()
    trt.reset_for_testing()


def spmd(comm, fn, timeout=60):
    """Run fn(rank_facade, rank) SPMD-style, one thread per rank."""
    size = comm.size
    results = [None] * size
    errors = []

    def run(i):
        try:
            results[i] = fn(comm.as_rank(i), i)
        except Exception:
            errors.append((i, traceback.format_exc()))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    alive = [i for i, t in enumerate(threads) if t.is_alive()]
    assert not alive, f"SPMD deadlock: ranks {alive} still running"
    assert not errors, "\n".join(f"[rank {i}]\n{tb}" for i, tb in errors)
    return results


def bits(x):
    """A result as comparable bytes (None stays None; lists element-wise)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [bits(v) for v in x]
    a = np.ascontiguousarray(np.asarray(x))
    return (str(a.dtype), a.shape, a.tobytes())


def both(comms, nranks, body):
    """``body(comm, rank, ns)`` on both packages' comm of ``nranks``; every
    rank's result must be bit-identical.  Returns the port's results."""
    got = {pkg: spmd(comms[pkg][nranks],
                     lambda c, r, ns=NS[pkg]: body(c, r, ns))
           for pkg in PKGS}
    for r in range(nranks):
        assert bits(got["torch"][r]) == bits(got["jax"][r]), r
    return got["torch"]


def signed_product(ns):
    """``inout = in * |inout|``: associative, not commutative (the sign is
    the left operand's), and every reordering changes the rounding."""
    def fn(invec, inoutvec, datatype=None):
        np.multiply(invec, np.abs(inoutvec), out=inoutvec)
    return ns.op.create(fn, commute=False)


def rank_data(nranks, nelem, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-1000, 1000, (nranks, nelem)).astype(dtype)
    return rng.standard_normal((nranks, nelem)).astype(dtype)


def sizes(n):
    """Element counts around the schedules' edges for an n-rank comm."""
    return (1, n - 1, n, 2 * n + 3, 1000)


DTYPES = (np.float64, np.float32, np.int32)


def reduction_cases(n):
    """(dtype, nelem, op name) cases: SUM over each dtype and size, and the
    non-commutative op on float64."""
    for nelem in sizes(n):
        for dt in DTYPES:
            yield dt, nelem, "SUM"
        yield np.float64, nelem, "NC"


def _op(ns, name):
    return signed_product(ns) if name == "NC" else getattr(ns.op, name)


def _nc_data(nranks, nelem, seed):
    """Magnitudes in [0.5, 1.5] with random signs: products stay bounded."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(0.5, 1.5, (nranks, nelem))
    return mag * rng.choice([-1.0, 1.0], (nranks, nelem))


def _data(nranks, nelem, dt, opname, seed):
    return _nc_data(nranks, nelem, seed) if opname == "NC" \
        else rank_data(nranks, nelem, dt, seed)


MENU = NS["torch"].algs
NRANKS = (8, 6, 5)


def test_menus_are_the_references():
    ref = NS["jax"].algs
    for menu in ("ALLREDUCE", "BCAST", "REDUCE", "ALLGATHER", "ALLTOALL",
                 "BARRIER", "REDUCE_SCATTER", "GATHER", "SCATTER"):
        assert sorted(getattr(MENU, menu)) == sorted(getattr(ref, menu))


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.ALLREDUCE))
def test_allreduce(comms, alg, nranks):
    for i, (dt, nelem, opname) in enumerate(reduction_cases(nranks)):
        data = _data(nranks, nelem, dt, opname, seed=i)
        both(comms, nranks, lambda c, r, ns: ns.algs.ALLREDUCE[alg](
            c, data[r], _op(ns, opname)))


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.REDUCE))
def test_reduce(comms, alg, nranks):
    for i, (dt, nelem, opname) in enumerate(reduction_cases(nranks)):
        data = _data(nranks, nelem, dt, opname, seed=100 + i)
        root = i % nranks
        out = both(comms, nranks, lambda c, r, ns: ns.algs.REDUCE[alg](
            c, data[r], _op(ns, opname), root))
        assert all(out[r] is None for r in range(nranks) if r != root)


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.REDUCE_SCATTER))
def test_reduce_scatter(comms, alg, nranks):
    for i, (dt, nelem, opname) in enumerate(reduction_cases(nranks)):
        data = _data(nranks, nelem, dt, opname, seed=200 + i)
        both(comms, nranks, lambda c, r, ns: ns.algs.REDUCE_SCATTER[alg](
            c, data[r], None, _op(ns, opname)))
    # caller recvcounts, uneven, one of them zero
    counts = [(k * 3) % 4 for k in range(nranks)]
    data = rank_data(nranks, sum(counts), np.float64, seed=299)
    both(comms, nranks, lambda c, r, ns: ns.algs.REDUCE_SCATTER[alg](
        c, data[r], counts, ns.op.SUM))


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.BCAST))
def test_bcast(comms, alg, nranks):
    for i, nelem in enumerate(sizes(nranks)):
        for dt in DTYPES:
            data = rank_data(1, nelem, dt, seed=300 + i)[0]
            root = (i * 3) % nranks
            both(comms, nranks, lambda c, r, ns: ns.algs.BCAST[alg](
                c, data if r == root else np.zeros_like(data), root))


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.ALLGATHER))
def test_allgather(comms, alg, nranks):
    for i, shape in enumerate(((1,), (nranks - 1,), (2 * nranks + 3,),
                               (2, 3))):
        for dt in DTYPES:
            data = rank_data(nranks, int(np.prod(shape)), dt,
                             seed=400 + i).reshape(nranks, *shape)
            both(comms, nranks, lambda c, r, ns: ns.algs.ALLGATHER[alg](
                c, data[r]))


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.ALLTOALL))
def test_alltoall(comms, alg, nranks):
    for i, k in enumerate((1, 3, 65)):
        for dt in DTYPES:
            data = rank_data(nranks, nranks * k, dt,
                             seed=500 + i).reshape(nranks, nranks, k)
            # each rank's stack is its own (size, k) block table
            both(comms, nranks, lambda c, r, ns: ns.algs.ALLTOALL[alg](
                c, data[r] + r))


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.BARRIER))
def test_barrier(comms, alg, nranks):
    def body(c, r, ns):
        for _ in range(3):
            ns.algs.BARRIER[alg](c)
        return np.array([r])

    both(comms, nranks, body)


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.GATHER))
def test_gather(comms, alg, nranks):
    for i, nelem in enumerate((1, nranks, 2 * nranks + 3)):
        for root in (0, nranks - 1):
            data = rank_data(nranks, nelem, np.float32, seed=600 + i)
            out = both(comms, nranks, lambda c, r, ns: ns.algs.GATHER[alg](
                c, data[r], root))
            np.testing.assert_array_equal(out[root], data)


@pytest.mark.parametrize("nranks", NRANKS)
@pytest.mark.parametrize("alg", sorted(MENU.SCATTER))
def test_scatter(comms, alg, nranks):
    for i, nelem in enumerate((1, nranks, 2 * nranks + 3)):
        for root in (0, nranks - 2):
            data = rank_data(nranks, nelem, np.int32, seed=700 + i)
            out = both(comms, nranks, lambda c, r, ns: ns.algs.SCATTER[alg](
                c, data if r == root else np.zeros(nelem, np.int32), root))
            for r in range(nranks):
                np.testing.assert_array_equal(out[r], data[r])


@pytest.mark.parametrize("nranks", NRANKS)
def test_segmented_entries_across_segments(comms, nranks):
    """The segmented entries with segments far below the payload: several
    chunks, each one a full ring or chain pass."""
    data = rank_data(nranks, 3001, np.float64, seed=800)
    nc = _nc_data(nranks, 3001, seed=801)
    both(comms, nranks, lambda c, r, ns: ns.algs.allreduce_ring_segmented(
        c, data[r], ns.op.SUM, segsize=512))
    both(comms, nranks, lambda c, r, ns: ns.algs.allreduce_ring_segmented(
        c, nc[r], signed_product(ns), segsize=512))
    both(comms, nranks, lambda c, r, ns: ns.algs.bcast_chain(
        c, data[1] if r == 1 else np.zeros_like(data[1]), 1, segsize=1000))
    both(comms, nranks, lambda c, r, ns: ns.algs.reduce_pipeline(
        c, nc[r], signed_product(ns), root=nranks - 1, segsize=1000))


# -- the fixed ladder -----------------------------------------------------

THRESHOLDS = (4096, 512 << 10, 4 << 20, 2048, 1 << 20, 64 << 10, 1024)


def _grid_sizes(comm_size):
    out = {0, 1}
    for t in THRESHOLDS + (256 * comm_size,):   # alltoall's 256 B block
        out.update((t - 1, t, t + 1))
    return sorted(out)


def test_default_algorithm_is_the_references():
    jt, tt = NS["jax"].tuned, NS["torch"].tuned
    n = 0
    for coll in tt._MENUS:
        for comm_size in range(2, 10):
            for nbytes in _grid_sizes(comm_size):
                for commute in (True, False):
                    want = jt.default_algorithm(coll, comm_size, nbytes,
                                                commute)
                    assert tt.default_algorithm(
                        coll, comm_size, nbytes, commute) == want, \
                        (coll, comm_size, nbytes, commute)
                    n += 1
            for per_block in (255, 256, 257):
                assert tt.default_algorithm(
                    "alltoall", comm_size, per_block * comm_size,
                    per_block=per_block) == jt.default_algorithm(
                    "alltoall", comm_size, per_block * comm_size,
                    per_block=per_block)
    assert n > 2000
    with pytest.raises(KeyError):
        tt.default_algorithm("scan", 4, 8)


@pytest.mark.parametrize("coll", sorted(NS["torch"].tuned._MENUS))
def test_ladder_rules_are_the_references(coll):
    jt, tt = NS["jax"].tuned, NS["torch"].tuned
    for comm_size in (2, 5, 8):
        for cap in (0, 4096, 1 << 20, 64 << 20):
            for commute in (True, False):
                assert tt.ladder_rules(coll, comm_size, cap, commute) == \
                    jt.ladder_rules(coll, comm_size, cap, commute)


# -- the tuned module: rules, force vars, fallback, eager lane -----------

@contextlib.contextmanager
def var_values(values: dict):
    """Set vars of both packages' registries by full name; restore after."""
    saved = []
    try:
        for pkg in PKGS:
            reg = NS[pkg].registry
            for name, value in values.items():
                var = reg.lookup(name)
                assert var is not None, (pkg, name)
                saved.append((var, var._value))
                reg.set(name, value)
        yield
    finally:
        for var, old in saved:
            var._value = old


@pytest.fixture
def tuned(comms):
    """{pkg: (TunedModule, its component)}, the frameworks opened."""
    out = {}
    for pkg in PKGS:
        ns = NS[pkg]
        fw = ns.coll_framework()
        fw.open()
        comp = fw.components["tuned"]
        out[pkg] = (ns.tuned.TunedModule(comp), comp)
    yield out
    for pkg in PKGS:
        out[pkg][1].rules = []


def tuned_both(comms, tuned, nranks, call):
    """``call(module, comm, rank, ns)`` through each package's TunedModule."""
    return both(comms, nranks, lambda c, r, ns: call(
        tuned["jax" if ns is NS["jax"] else "torch"][0], c, r, ns))


RULES = {
    "good": ("# comments are fine\n"
             "allreduce 8 4096 recursive_doubling\n"
             "allreduce 0 0 ring  # unbounded\n"
             "bcast 0 0 chain 65536\n"),
    "field_count": "allreduce 8 4096\n",
    "unknown_collective": "scan 8 4096 linear\n",
    "unknown_algorithm": "allreduce 8 4096 no_such_algorithm\n",
    "not_an_integer": "allreduce eight 4096 ring\n",
    "bad_segsize": "bcast 0 0 chain big\n",
    "missing_file": None,
}


@pytest.mark.parametrize("kind", sorted(RULES))
def test_rules_file_like_the_reference(tuned, tmp_path, kind):
    """Each package loads the same file to the same rules, or fails the
    same way: an OSError shows the help and falls back to the fixed
    ladder, anything else (a non-integer field) raises from ``open``."""
    path = tmp_path / "rules.conf"
    if RULES[kind] is not None:
        path.write_text(RULES[kind])
    seen = {}
    with var_values({"otpu_coll_tuned_dynamic_rules_filename": str(path)}):
        for pkg in PKGS:
            mod, comp = tuned[pkg]
            try:
                comp.open()
                seen[pkg] = ("ok", list(comp.rules), [
                    mod._pick("allreduce", 4, 100, "x"),
                    mod._pick("allreduce", 64, 100, "x"),
                    mod._pick("allreduce", 4, 1 << 20, "x"),
                    mod._pick("bcast", 99, 1 << 22, "x"),
                    mod._pick("barrier", 8, 0, "tree"),
                    mod._pick("allreduce", 4, 100, "nonoverlapping",
                              commute=False)])
            except Exception as exc:
                seen[pkg] = ("raised", type(exc).__name__)
    assert seen["torch"] == seen["jax"]
    if kind == "good":
        assert seen["torch"][2][:4] == [
            ("recursive_doubling", 0), ("ring", 0), ("ring", 0),
            ("chain", 65536)]
        assert seen["torch"][2][5] == ("nonoverlapping", 0)
    elif kind in ("not_an_integer", "bad_segsize"):
        assert seen["torch"] == ("raised", "ValueError")
    else:
        assert seen["torch"][1] == []


def test_rules_drive_the_module(comms, tuned, tmp_path):
    path = tmp_path / "rules.conf"
    path.write_text("allreduce 0 0 ring\nreduce 0 0 pipeline 256\n")
    data = rank_data(8, 300, np.float64, seed=900)
    with var_values({"otpu_coll_tuned_dynamic_rules_filename": str(path)}):
        for pkg in PKGS:
            tuned[pkg][1].open()
        tuned_both(comms, tuned, 8, lambda m, c, r, ns: m.allreduce(
            c, data[r], ns.op.SUM))
        tuned_both(comms, tuned, 8, lambda m, c, r, ns: m.reduce(
            c, data[r], ns.op.SUM, 2))


@pytest.mark.parametrize("nranks", NRANKS)
def test_the_ladder_end_to_end(comms, tuned, nranks):
    """Every slot of the module through its ladder at sizes on both sides
    of the thresholds, with the non-commutative op where it takes one."""
    for nelem in (3, 600, 20000, 70000):
        data = rank_data(nranks, nelem, np.float64, seed=nelem)
        nc = _nc_data(nranks, nelem, seed=nelem + 1)
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.allreduce(
            c, data[r], ns.op.SUM))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.allreduce(
            c, nc[r], signed_product(ns)))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.reduce(
            c, nc[r], signed_product(ns), 1))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.reduce(
            c, data[r], ns.op.SUM, 0))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns:
                   m.reduce_scatter(c, nc[r], None, signed_product(ns)))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns:
                   m.reduce_scatter(c, data[r], None, ns.op.SUM))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.bcast(
            c, data[0] if r == 0 else np.zeros_like(data[0]), 0))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.allgather(
            c, data[r][:nelem // 8 + 1]))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.gather(
            c, data[r], nranks - 1))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.scatter(
            c, data.reshape(nranks, -1) if r == 0 else data[r], 0))
        tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.alltoall(
            c, data[r][:nranks * (nelem // nranks)].reshape(nranks, -1)))
    tuned_both(comms, tuned, nranks, lambda m, c, r, ns: m.barrier(c))


def test_force_vars(comms, tuned):
    """A force var beats the ladder for commutative and non-commutative
    ops alike (the user's explicit override), in both packages."""
    data = rank_data(8, 100, np.float64, seed=901)
    nc = _nc_data(8, 100, seed=902)
    with var_values({"otpu_coll_tuned_allreduce_algorithm": "ring",
                     "otpu_coll_tuned_bcast_algorithm": "chain",
                     "otpu_coll_tuned_bcast_segsize": 128}):
        for pkg in PKGS:
            assert tuned[pkg][0]._pick("allreduce", 8, 100,
                                       "recursive_doubling") == ("ring", 0)
            assert tuned[pkg][0]._pick("allreduce", 8, 100, "x",
                                       commute=False) == ("ring", 0)
        tuned_both(comms, tuned, 8, lambda m, c, r, ns: m.allreduce(
            c, data[r], ns.op.SUM))
        tuned_both(comms, tuned, 8, lambda m, c, r, ns: m.allreduce(
            c, nc[r], signed_product(ns)))
        tuned_both(comms, tuned, 8, lambda m, c, r, ns: m.bcast(
            c, data[3] if r == 3 else np.zeros_like(data[3]), 3))


def test_unknown_algorithm_falls_back_to_the_ladder(comms, tuned, capfd):
    data = rank_data(8, 100, np.float64, seed=903)
    with var_values({"otpu_coll_tuned_allreduce_algorithm": "bogus"}):
        out = tuned_both(comms, tuned, 8, lambda m, c, r, ns: m.allreduce(
            c, data[r], ns.op.SUM))
    assert "bogus" in capfd.readouterr().err
    np.testing.assert_allclose(out[0], data.sum(0), rtol=1e-12)


def _spc_delta(pkg, names, fn):
    spc = NS[pkg].spc
    before = {n: spc.read(n) for n in names}
    fn()
    return {n: spc.read(n) - before[n] for n in names}


def test_eager_lane(comms, tuned):
    """Small allreduces take the SPC-counted eager lane (commutative, or
    non-commutative on more than 4 ranks); a force var or a rules file
    closes it.  The counts move alike in both packages."""
    small = rank_data(8, 16, np.float64, seed=904)
    nc = _nc_data(8, 16, seed=905)
    for nranks, opname, lane in ((8, "SUM", 8), (8, "NC", 8),
                                 (5, "SUM", 5), (6, "NC", 6)):
        deltas = {}
        for pkg in PKGS:
            mod = tuned[pkg][0]
            ns = NS[pkg]
            op = _op(ns, opname)
            src = nc if opname == "NC" else small
            deltas[pkg] = _spc_delta(pkg, ["fastpath_eager_lane"], lambda: spmd(
                comms[pkg][nranks], lambda c, r: mod.allreduce(c, src[r], op)))
        assert deltas["torch"] == deltas["jax"] == \
            {"fastpath_eager_lane": lane}
    with var_values({"otpu_coll_tuned_allreduce_algorithm": "ring"}):
        for pkg in PKGS:
            mod = tuned[pkg][0]
            d = _spc_delta(pkg, ["fastpath_eager_lane"], lambda: spmd(
                comms[pkg][8], lambda c, r: mod.allreduce(
                    c, small[r], NS[pkg].op.SUM)))
            assert d == {"fastpath_eager_lane": 0}


def test_sched_cache_counts_like_the_reference(comms):
    """The same sequence of schedule lookups records the same SPC hits and
    misses in both packages, and a repeated ring allreduce hits its cached
    schedules on every rank."""
    names = ["fastpath_sched_hits", "fastpath_sched_misses"]

    def lookups(algs):
        for f in (algs._blocks, algs._ring_schedule, algs._rd_peers,
                  algs._binomial_tree):
            f.cache_clear()
        for _ in range(2):
            algs._blocks(1000, 8)
            algs._ring_schedule(8, 3, 1000)
            algs._rd_peers(6, 1)
            algs._binomial_tree(5, 8, 2)

    deltas = {pkg: _spc_delta(pkg, names, lambda: lookups(NS[pkg].algs))
              for pkg in PKGS}
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"]["fastpath_sched_hits"] > 0
    data = rank_data(8, 4096, np.float64, seed=906)
    for pkg in PKGS:
        algs = NS[pkg].algs
        spmd(comms[pkg][8], lambda c, r: algs.allreduce_ring(c, data[r]))
        d = _spc_delta(pkg, names, lambda: spmd(
            comms[pkg][8], lambda c, r: algs.allreduce_ring(c, data[r])))
        assert d["fastpath_sched_misses"] == 0 and \
            d["fastpath_sched_hits"] >= 8, (pkg, d)


def test_a_tensor_is_staged_once_and_returns_numpy(comms, tuned):
    """A tensor given to a slot is staged to the host at the slot's entry
    (the reference's ``np.asarray`` of a ``jax.Array``); the result is
    numpy, bit-identical to the numpy input's."""
    import torch

    data = rank_data(8, 5000, np.float32, seed=907)
    mod = tuned["torch"][0]
    got = spmd(comms["torch"][8], lambda c, r: mod.allreduce(
        c, torch.from_numpy(data[r])))
    want = spmd(comms["torch"][8], lambda c, r: mod.allreduce(c, data[r]))
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and bits(g) == bits(w)
    got = spmd(comms["torch"][8], lambda c, r: mod.allgather(
        c, torch.from_numpy(data[r])))
    assert isinstance(got[0], np.ndarray) and bits(got[0]) == bits(data)


def test_selection_in_the_device_world(comms):
    """The new components answer None in the device world: its vote is
    unchanged."""
    from ompi_tpu_torch.mca.coll import (adapt, demo, han, libnbc, sync,
                                         tuned)

    w = comms["torch"][8]
    for comp in (tuned.COMPONENT, libnbc.COMPONENT, han.COMPONENT,
                 adapt.COMPONENT, sync.COMPONENT):
        assert comp.comm_query(w) is None, comp.name
    assert not demo.COMPONENT.open()
    new = {"TunedModule", "LibnbcModule", "HanModule", "AdaptModule",
           "SyncModule", "DemoModule"}
    assert not new & {type(m).__name__ for m in w.coll_modules}


def test_demo_declines_the_device_world_divergence_pinned(comms):
    """coll/demo raised to 100 answers None in the port's device world,
    where the reference's answers every communicator and would wrap the
    conductor's slots (ROADMAP C)."""
    from ompi_tpu.mca.coll import demo as ref_demo
    from ompi_tpu_torch.mca.coll import demo

    saved = demo.COMPONENT.priority, ref_demo.COMPONENT.priority
    demo.COMPONENT.priority = ref_demo.COMPONENT.priority = 100
    try:
        for k in (8, 5):
            assert demo.COMPONENT.comm_query(comms["torch"][k]) is None
            prio, mod = ref_demo.COMPONENT.comm_query(comms["jax"][k])
            assert prio == 100 and type(mod).__name__ == "DemoModule"
    finally:
        demo.COMPONENT.priority, ref_demo.COMPONENT.priority = saved
