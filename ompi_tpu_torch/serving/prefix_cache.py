"""serving/prefix_cache — prefix-cache-aware routing state, both sides.

Copy of ``ompi_tpu/serving/prefix_cache.py`` with its imports re-pointed:
:func:`block_hashes` gives the reference's digests byte for byte, and the
registry's and the store's LRU, invalidation and generations are its.

Serving traffic is dominated by shared prompt prefixes (system prompts,
few-shot templates, multi-turn histories): the KV blocks of a prefix
already computed by one worker can serve every later request carrying
the same prefix, *if the router sends the request to that worker*.
This module is the pure state machine behind that affinity — no MPI,
no threads of its own, unit-testable in isolation:

* :func:`block_hashes` — hash a prompt's tokens at **KV-block
  granularity** into a chain of cumulative digests (one per full
  block), process-stable (``hashlib.blake2b`` over packed token bytes,
  never Python's salted ``hash()``), so the router, every worker, and
  a restarted replacement all agree on what a prefix is called;
* :class:`PrefixRegistry` — the ROUTER side: an LRU map
  ``prefix-hash → (worker, slab generation)``.  ``lookup`` returns the
  deepest known block of a prompt; the router routes the request to
  that worker and attaches the ``(hash, generation)`` hint.
* :class:`PrefixStore` — the WORKER side: a bounded LRU of the block
  hashes whose KV this worker still holds, stamped with a
  **generation** that bumps every time the store is cleared (failure
  recovery, re-shard, retirement).  ``has(hash, gen)`` is the hint
  check: a hit skips prefill, a mismatch — entry evicted since the
  router learned of it, or a different store generation entirely —
  falls back to a FULL prefill.

The generation check is the correctness story: a stale registry entry
(worker died and respawned, slab re-sharded, LRU evicted the block) is
always a **performance miss, never a correctness bug** — the worker
verifies before skipping anything, and the router's registry is only a
routing heuristic.  Invalidation keeps the registry fresh along the
same channels the KV eviction notices already ride: workers report
evicted hashes with every reply (idempotent ``forget``), and the
shrink / re-shard / retire paths call ``invalidate_worker`` /
``invalidate_all``.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from hashlib import blake2b
from typing import Optional

from ompi_tpu_torch.base.var import VarType, registry

_block_var = registry.register(
    "serving", None, "prefix_block", vtype=VarType.INT, default=16,
    help="Prefix-cache block size in prompt tokens: prompts are hashed "
         "at this granularity (one cumulative digest per full block), "
         "matching the KV-block unit the cache can actually reuse.  "
         "Router and workers must agree — it is read once per process "
         "from this var")
_store_cap_var = registry.register(
    "serving", None, "prefix_capacity", vtype=VarType.INT, default=128,
    help="Worker-side prefix store capacity (block entries).  The "
         "oldest entry is evicted LRU; evictions ride the next reply "
         "to the router so its registry forgets the entry too")
_registry_cap_var = registry.register(
    "serving", None, "registry_capacity", vtype=VarType.INT,
    default=1024,
    help="Router-side prefix registry capacity (block entries across "
         "all workers of one pool), evicted LRU")


def block_size() -> int:
    """The configured prefix block size (tokens per hashed block)."""
    return max(1, int(_block_var.value or 16))


def block_hashes(tokens, block: Optional[int] = None) -> tuple:
    """Cumulative block digests of a prompt: entry ``i`` names the
    prefix ``tokens[:(i + 1) * block]`` (full blocks only — a partial
    tail block is never cacheable).  Digests chain (``h_i = H(h_{i-1}
    || block_i)``) so two prompts share entry ``i`` iff they share the
    whole prefix up to it, and they are **process-stable**: blake2b
    over packed token bytes, usable across router, workers, and
    respawned replacements."""
    b = int(block) if block else block_size()
    toks = tuple(int(t) for t in tokens)
    out = []
    prev = b"\x00"
    for i in range(len(toks) // b):
        blk = toks[i * b:(i + 1) * b]
        h = blake2b(prev, digest_size=8)
        h.update(struct.pack(f"!{b}q", *blk))
        digest = h.hexdigest()
        out.append(digest)
        prev = digest.encode("ascii")
    return tuple(out)


class PrefixHit:
    """One registry lookup result: the deepest known block of a
    prompt.  ``blocks`` counts the matched full blocks (the prefill
    the hit can skip covers ``blocks * block_size()`` tokens)."""

    __slots__ = ("hash", "worker", "generation", "blocks")

    def __init__(self, h: str, worker: int, generation: int,
                 blocks: int) -> None:
        self.hash = h
        self.worker = int(worker)
        self.generation = int(generation)
        self.blocks = int(blocks)

    def __repr__(self) -> str:
        return (f"PrefixHit({self.hash}, worker={self.worker}, "
                f"gen={self.generation}, blocks={self.blocks})")


class PrefixRegistry:
    """Router-side prefix → (worker, generation) map (see module doc).

    Mutated by the router tick thread, snapshotted by the telemetry
    sampler thread through :meth:`stats` — every structure is under
    the registry lock."""

    _guarded_by = {"_entries": "_lock", "_hits": "_lock",
                   "_misses": "_lock", "_invalidated": "_lock"}

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = max(1, int(capacity) if capacity is not None
                            else int(_registry_cap_var.value or 1024))
        self._lock = threading.Lock()
        #: hash -> (worker, generation), LRU order (oldest first)
        self._entries: OrderedDict = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._invalidated = 0

    def lookup(self, hashes) -> Optional[PrefixHit]:
        """Deepest registered block of the prompt whose cumulative
        digests are ``hashes`` (longest-prefix match), or None.  Counts
        a hit or a miss — the hit/miss ratio IS the routing-quality
        signal the telemetry plane publishes."""
        with self._lock:
            for i in range(len(hashes) - 1, -1, -1):
                ent = self._entries.get(hashes[i])
                if ent is not None:
                    self._entries.move_to_end(hashes[i])
                    self._hits += 1
                    return PrefixHit(hashes[i], ent[0], ent[1], i + 1)
            if hashes:
                self._misses += 1
        return None

    def insert(self, hashes, worker: int, generation: int) -> None:
        """Register every cumulative block of a freshly prefilled
        prompt as held by ``worker`` at ``generation`` (called from the
        router when a worker reports the blocks it installed)."""
        with self._lock:
            for h in hashes:
                self._entries[h] = (int(worker), int(generation))
                self._entries.move_to_end(h)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def forget(self, hashes, worker: Optional[int] = None) -> None:
        """Drop entries (worker-reported evictions).  Idempotent — the
        eviction notices ride every reply like the KV free_rids deque,
        so repeats are harmless; with ``worker`` given only entries
        still owned by that worker are dropped (a fresh entry from a
        different worker under the same hash must survive a late
        notice)."""
        with self._lock:
            for h in hashes:
                ent = self._entries.get(h)
                if ent is None:
                    continue
                if worker is not None and ent[0] != int(worker):
                    continue
                del self._entries[h]

    def invalidate_worker(self, worker: int) -> int:
        """Drop every entry routed at ``worker`` — the re-shard /
        retire path (the worker's slabs are gone or about to be)."""
        with self._lock:
            dead = [h for h, ent in self._entries.items()
                    if ent[0] == int(worker)]
            for h in dead:
                del self._entries[h]
            self._invalidated += len(dead)
            return len(dead)

    def invalidate_all(self) -> None:
        """Drop everything — the shrink path: comm ranks just
        re-numbered, so every routed worker id is suspect.  Stale
        entries would only be perf misses, but a wholesale re-rank
        makes them all dead weight."""
        with self._lock:
            self._invalidated += len(self._entries)
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """Hit/miss/occupancy snapshot (telemetry ``fleet`` source)."""
        with self._lock:
            total = self._hits + self._misses
            return {"entries": len(self._entries),
                    "hits": self._hits, "misses": self._misses,
                    "invalidated": self._invalidated,
                    "hit_rate": round(self._hits / total, 4)
                    if total else 0.0}


class PrefixStore:
    """Worker-side record of which prefix blocks this worker still
    holds, with the generation stamp the hint check verifies (see
    module doc).  Single-threaded (the worker's serve loop), so no
    lock — but bounded and loud about what it evicts, because every
    eviction must reach the router's registry."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = max(1, int(capacity) if capacity is not None
                            else int(_store_cap_var.value or 128))
        self.generation = 0
        self._codec = ""
        self._lru: OrderedDict = OrderedDict()

    def has(self, h: str, generation: int) -> bool:
        """THE hint check: is this exact block still held, and was the
        router's registry entry minted against this store lifetime?
        Any mismatch means full prefill — stale hints are perf misses,
        never wrong KV."""
        if int(generation) != self.generation:
            return False
        if h not in self._lru:
            return False
        self._lru.move_to_end(h)
        return True

    def add_all(self, hashes) -> list:
        """Install freshly prefilled blocks; returns the hashes LRU
        eviction pushed out (the caller reports them to the router so
        the registry forgets them too)."""
        evicted = []
        for h in hashes:
            self._lru[h] = True
            self._lru.move_to_end(h)
        while len(self._lru) > self.capacity:
            old, _ = self._lru.popitem(last=False)
            evicted.append(old)
        return evicted

    def clear(self) -> None:
        """Drop everything and bump the generation — recovery /
        re-shard / retirement: hints minted against the old lifetime
        must never match again."""
        self.generation += 1
        self._lru.clear()

    def set_codec(self, codec: str) -> None:
        """Record the KV slab codec this store's blocks are held under.
        A codec CHANGE invalidates every held block the way a recovery
        does — the bytes a hint promised no longer exist in that
        encoding — so the generation bumps and hints minted against
        the old codec can never verify again: the stale-hint guarantee
        ("perf miss, never wrong KV") survives the reconfiguration.
        An idempotent re-set, or the first set over an empty store, is
        free (no hint was ever minted against another encoding)."""
        codec = str(codec or "")
        if codec == self._codec:
            return
        had_blocks = bool(self._lru)
        self._codec = codec
        if had_blocks:
            self.clear()

    def __len__(self) -> int:
        return len(self._lru)
