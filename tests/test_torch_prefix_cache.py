"""The port's prefix cache (``ompi_tpu_torch/serving/prefix_cache.py``) held
against the JAX package's ``ompi_tpu.serving.prefix_cache`` on the CPU.

The same seeded inputs go through both packages, and every comparison is
exact:

* :func:`block_hashes`: the digest chains of seeded prompts at several
  block sizes and the default one, equal strings; stable across processes;
* :class:`PrefixRegistry` and :class:`PrefixStore`: a seeded sequence of
  inserts, lookups, forgets, invalidations, adds, checks, clears and codec
  changes, with every answer, LRU eviction, generation and stats snapshot
  equal to the reference's;
* the worker's prefix-skip prefill (``_prefill_or_skip``) with its reports
  and counter deltas, and the codec change that must make a hint stale;
* the reference's unit cases, run on both packages;
* prefix-aware routing end to end in the port: a single router with a
  registry under :class:`MixedPoissonDriver` traffic with shared prefixes,
  every token the reference's ``toy_token``.
"""
import subprocess
import sys
import threading

import numpy as np
import pytest

import ompi_tpu_torch
from ompi_tpu.serving import prefix_cache as jpc
from ompi_tpu.serving import worker as jworker
from ompi_tpu.runtime import spc as jspc
from ompi_tpu_torch.runtime import spc as tspc
from ompi_tpu_torch.serving import prefix_cache as tpc
from ompi_tpu_torch.serving import worker as tworker

B = 4   # explicit block size: the tests must not depend on the MCA var
PC = {"jax": jpc, "torch": tpc}
WK = {"jax": (jworker, jspc), "torch": (tworker, tspc)}
PKGS = ("jax", "torch")


@pytest.fixture(scope="module", autouse=True)
def _restore_trace_pvars():
    """The drivers' latency histograms register MPI_T pvars that outlive
    the run.  Put both packages' pvar tables and histograms back as the
    module found them, so that a later module in the same process reads
    the same pvars from both packages."""
    from ompi_tpu.base.var import registry as jvars
    from ompi_tpu.runtime import trace as jtrace
    from ompi_tpu_torch.base.var import registry as tvars
    from ompi_tpu_torch.runtime import trace as ttrace

    saved = [(reg, dict(reg._pvars)) for reg in (jvars, tvars)]
    yield
    for reg, pvars in saved:
        reg._pvars = pvars
    for tr in (jtrace, ttrace):
        tr.reset_for_testing()


def _prompts(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(0, 50000, 64)]
    out = []
    for _ in range(n):
        keep = int(rng.integers(0, 64))
        tail = [int(t) for t in rng.integers(-2 ** 40, 2 ** 40,
                                             int(rng.integers(0, 40)))]
        out.append(base[:keep] + tail)
    return out


@pytest.mark.parametrize("block", [1, B, 16, None], ids=["b1", "b4", "b16",
                                                         "default"])
def test_block_hashes_match_reference(block):
    """Digest chains of seeded prompts (shared prefixes, 64-bit tokens,
    empty and partial-block prompts): equal strings, one a full block."""
    for toks in _prompts(3):
        got = tpc.block_hashes(toks, block)
        assert got == jpc.block_hashes(toks, block)
        assert len(got) == len(toks) // (block or 16)
    assert tpc.block_size() == jpc.block_size() == 16


def test_block_hashes_stable_across_processes():
    """The port's digests in a fresh process with a random hash seed equal
    the reference's here."""
    toks = [17, 4093, 0, 88, 17, 17, 2, 9]
    out = subprocess.run(
        [sys.executable, "-c",
         "from ompi_tpu_torch.serving.prefix_cache import block_hashes\n"
         f"print(','.join(block_hashes({toks!r}, {B})))"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": ":".join(sys.path), "PYTHONHASHSEED": "random"})
    assert out.returncode == 0, out.stderr
    assert tuple(out.stdout.strip().split(",")) == jpc.block_hashes(toks, B)


def _hit(h):
    return None if h is None else (h.hash, h.worker, h.generation, h.blocks)


def _registry_log(pc, seed: int) -> list:
    rng = np.random.default_rng(seed)
    chains = [pc.block_hashes(p, B) for p in _prompts(seed, 24)]
    reg = pc.PrefixRegistry(capacity=20)
    log = []
    for _ in range(400):
        op = int(rng.integers(6))
        ch = chains[int(rng.integers(len(chains)))]
        w = int(rng.integers(1, 4))
        if op <= 1:
            reg.insert(ch, worker=w, generation=int(rng.integers(3)))
            log.append(("insert", len(reg)))
        elif op == 2:
            log.append(("lookup", _hit(reg.lookup(ch))))
        elif op == 3:
            reg.forget(ch[:int(rng.integers(len(ch) + 1))],
                       worker=w if rng.random() < 0.7 else None)
            log.append(("forget", len(reg)))
        elif op == 4 and rng.random() < 0.3:
            log.append(("invalidate_worker", reg.invalidate_worker(w)))
        elif rng.random() < 0.05:
            reg.invalidate_all()
            log.append(("invalidate_all", len(reg)))
        log.append(reg.stats())
    return log


def test_registry_sequence_matches_reference():
    """Longest-prefix lookups, LRU eviction at capacity, owner-checked
    forgets and both invalidations: every answer and stats snapshot of a
    seeded 400-operation sequence equal to the reference's."""
    got = _registry_log(tpc, 5)
    assert got == _registry_log(jpc, 5)
    assert got[-1]["hits"] > 0 and got[-1]["misses"] > 0


def _store_log(pc, seed: int) -> list:
    rng = np.random.default_rng(seed)
    chains = [pc.block_hashes(p, B) for p in _prompts(seed, 24)]
    store = pc.PrefixStore(capacity=12)
    log = []
    for _ in range(400):
        op = int(rng.integers(10))
        ch = chains[int(rng.integers(len(chains)))]
        if op <= 3:
            log.append(("add", store.add_all(ch)))
        elif op <= 7 and ch:
            h = ch[int(rng.integers(len(ch)))]
            gen = store.generation - int(rng.integers(2))
            log.append(("has", store.has(h, gen)))
        elif op == 8:
            store.set_codec(("", "int8", "bf16")[int(rng.integers(3))])
            log.append(("codec", store.generation))
        elif rng.random() < 0.3:
            store.clear()
            log.append(("clear", store.generation))
        log.append((len(store), store.generation))
    return log


def test_store_sequence_matches_reference():
    """Adds with their LRU evictions, generation-checked hits, clears and
    codec changes: the same answers and generations as the reference's."""
    got = _store_log(tpc, 9)
    assert got == _store_log(jpc, 9)
    assert ("has", True) in got and ("has", False) in got


def _bare_worker(wmod, pc, codec=""):
    wk = wmod.ShardWorker.__new__(wmod.ShardWorker)
    wk.kv_elems = 16
    wk._prefix = pc.PrefixStore(capacity=8)
    wk._prefix.set_codec(codec)
    wk._prefix_hits = 0
    wk._preport_installed, wk._preport_evicted = [], []
    wk._preport_prefills = 0
    return wk


def _skip_log(pkg) -> list:
    """Cold prefill, verified hint, stale hint after a clear, stale hint
    after a codec change: the KV, reports and counter deltas."""
    wmod, spc = WK[pkg]
    pc = PC[pkg]
    spc.init()
    names = ("serve_prefills", "serve_prefix_hits", "serve_prefix_stale")
    before = [spc.read(n) for n in names]
    wk = _bare_worker(wmod, pc)
    ch = pc.block_hashes(list(range(8)), B)
    out = []
    steps = [(11, None), (12, "hint"), ("clear", None), (13, (ch[1], 0, 2)),
             (14, "hint"), ("codec", None), (15, "old")]
    old = None
    for rid, hint in steps:
        if rid == "clear":
            wk._prefix.clear()
            continue
        if rid == "codec":
            old = (ch[1], wk._prefix.generation, 2)
            wk._prefix.set_codec("int8")
            continue
        if hint == "hint":
            hint = (ch[1], wk._prefix.generation, 2)
        elif hint == "old":
            hint = old
        kv = wk._prefill_or_skip(rid, 8, ch, hint)
        out.append((kv.tobytes(), wk._take_preport(), wk._prefix.generation))
    out.append([spc.read(n) - b for n, b in zip(names, before)])
    return out


def test_worker_prefill_skip_matches_reference():
    got = _skip_log("torch")
    assert got == _skip_log("jax")
    # cold, hit, stale, hit, stale: 3 full prefills, 2 hits, 2 stale hints
    assert got[-1] == [3, 2, 2]


# ---------------------------------------------- the reference's unit cases

@pytest.mark.parametrize("pkg", PKGS)
def test_block_hashes_boundaries_and_chain(pkg):
    bh = PC[pkg].block_hashes
    toks = list(range(10))
    assert len(bh(toks, B)) == 2 and bh(toks[:3], B) == ()
    assert len(bh(toks[:4], B)) == 1 and len(bh(toks[:7], B)) == 1
    assert bh((), B) == ()
    a = bh([1, 2, 3, 4, 5, 6, 7, 8], B)
    b = bh([1, 2, 3, 4, 9, 9, 9, 9], B)
    c = bh([0, 2, 3, 4, 5, 6, 7, 8], B)
    d = bh([9, 9, 9, 9, 5, 6, 7, 8], B)
    assert a[0] == b[0] and a[1] != b[1] and a[0] != c[0] and a[1] != d[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_lookup_lru_and_forget(pkg):
    pc = PC[pkg]
    reg = pc.PrefixRegistry(capacity=32)
    h8 = pc.block_hashes(list(range(8)), B)
    h12 = pc.block_hashes(list(range(12)), B)
    reg.insert(h8, worker=3, generation=1)
    hit = reg.lookup(h12)
    assert (hit.worker, hit.generation, hit.blocks, hit.hash) == \
        (3, 1, 2, h8[1])
    assert reg.lookup(pc.block_hashes([99] * 8, B)) is None
    assert reg.lookup(()) is None and reg.stats()["misses"] == 1
    small = pc.PrefixRegistry(capacity=3)
    chains = [pc.block_hashes([i] * 4, B) for i in range(5)]
    for i, ch in enumerate(chains):
        small.insert(ch, worker=i, generation=0)
    assert len(small) == 3 and small.lookup(chains[0]) is None
    ch = pc.block_hashes([5] * 4, B)
    reg.insert(ch, worker=1, generation=0)
    reg.forget(ch, worker=2)
    assert reg.lookup(ch).worker == 1
    reg.insert(ch, worker=2, generation=3)
    reg.forget(ch, worker=1)
    assert reg.lookup(ch).worker == 2
    assert reg.invalidate_worker(2) == 1 and reg.lookup(ch) is None
    assert pc.PrefixRegistry(capacity=0).capacity == 1
    assert pc.PrefixStore(capacity=-3).capacity == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_store_generation_mismatch_falls_back(pkg):
    pc = PC[pkg]
    store = pc.PrefixStore(capacity=8)
    ch = pc.block_hashes([7] * 8, B)
    store.add_all(ch)
    gen = store.generation
    assert store.has(ch[1], gen)
    store.clear()
    assert store.generation == gen + 1 and not store.has(ch[1], gen)
    store.add_all(ch)
    assert not store.has(ch[1], gen) and store.has(ch[1], store.generation)
    store.set_codec("int8")
    assert store.generation == gen + 2
    store.set_codec("int8")
    assert store.generation == gen + 2


# ------------------------------------------------ prefix routing end to end

@pytest.fixture(scope="module")
def world():
    from ompi_tpu_torch.mca.part import part_framework
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    w = ompi_tpu_torch.init(device="cpu")
    part_framework().open()
    yield w
    rt.reset_for_testing()


@pytest.mark.parametrize("stages", [False, True], ids=["colocated",
                                                       "staged"])
def test_prefix_routing_end_to_end(world, stages):
    """A router with a prefix registry under shared-prefix traffic: hits
    route to the worker holding the blocks and skip the full prefill,
    every request completes with the reference's tokens."""
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        MixedPoissonDriver, PrefixRegistry,
                                        Router, ShardWorker)

    if stages:
        workers = [ShardWorker(world.as_rank(1), router=0, role="prefill",
                               peer=[2, 3], slots=8, kv_elems=32),
                   ShardWorker(world.as_rank(2), router=0, role="decode",
                               peer=1, slots=8, kv_elems=32),
                   ShardWorker(world.as_rank(3), router=0, role="decode",
                               peer=1, slots=8, kv_elems=32)]
        kw = dict(prefill_ranks=[1], decode_ranks=[2, 3])
    else:
        workers = [ShardWorker(world.as_rank(r), router=0, kv_elems=32)
                   for r in (1, 2, 3)]
        kw = {}
    threads = [threading.Thread(target=w.serve, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    reg = PrefixRegistry(capacity=256)
    r = Router(world.as_rank(0),
               scheduler=ContinuousBatchScheduler(max_batch=8,
                                                  max_batch_tokens=1 << 14,
                                                  slots=8,
                                                  tenants={"a": 2, "b": 1}),
               workers=[1, 2, 3], prefix_registry=reg, decode_chunk=4,
               kv_elems=32, **kw)
    conf = {"a": dict(rate_rps=400, n_requests=20, prefixes=2,
                      prefix_len=32, prompt_lens=(4, 12)),
            "b": dict(rate_rps=200, n_requests=8, prompt_lens=(4, 12))}
    rep = MixedPoissonDriver(conf, seed=2).run(r, max_wall_s=90,
                                               check_invariants=True)
    r.shutdown()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert rep["requests"] == 28
    assert rep["tenants"]["a"]["requests"] == 20
    assert rep["prefix_hits"] > 0 and rep["prefills"] < 28
    assert rep["prefills"] + rep["prefix_hits"] == 28
    assert reg.stats()["hits"] >= rep["prefix_hits"]
    for q in r.completed():
        assert q.tokens == [jworker.toy_token(q.rid, i)
                            for i in range(q.max_new_tokens)]
