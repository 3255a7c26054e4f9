"""serving/worker — model-shard worker ranks.

Copy of ``ompi_tpu/serving/worker.py`` with its imports re-pointed.  The
toy model stays numpy on the host: its ``tanh`` passes price a forward
pass in host time (the speculative A/B rests on that price), so the worker
launches no kernel.  One divergence: :func:`worker_main`, the entry point
of an autoscaled worker, takes the device its world binds to as an
optional argument (``python -m ompi_tpu_torch.serving.worker cpu``; the
card by default), since the port's ``init`` never falls back to the CPU.
Revocation completes the port's pending requests with ``RevokedError``
(where the reference leaves them pending), which lands in the same
:meth:`ShardWorker._recover`.

A worker owns one shard of the (toy) model and executes the micro-batch
commands its router sends each engine tick over the eager lane — one
coalesced command message per worker per tick, one coalesced result
message back (per-request messages would pay the per-message software
overhead 2508.13397 measures in exactly this small-transfer regime).

Roles:

* ``colocated`` (default) — prefill AND decode on the same rank; the KV
  block of a sequence stays local from prefill to eviction.
* ``prefill`` — runs prefills only and streams each finished sequence's
  KV block to its paired decode rank through a
  :class:`~ompi_tpu_torch.serving.kv_stream.KvSlabSender` epoch per
  micro-batch.
* ``decode`` — receives KV blocks (``Parrived`` per slot), copies them
  into its local cache, and generates tokens.

The "model" is deliberately tiny but *checkable*: ``toy_kv`` and
``toy_token`` are deterministic functions of the request id, so the
decode stage verifies every streamed KV block bit-exactly and the
router verifies every decoded token — a correctness harness for the
transport, not an ML demo.

Failure story: any communication error that ULFM classifies
(revocation after the router saw a death, or a direct peer-failure
report) drops the worker into :meth:`ShardWorker._recover` — shrink to
the survivors (the coord service has already published
``mpi://surviving``), rebind to the shrunken communicator, fall back to
the colocated role (stage pairs may have lost a side), and keep
serving.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ompi_tpu_torch.api.errors import (ErrorClass, MpiError, ProcFailedError,
                                       RevokedError)
from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime import spc, trace

#: user-space tags of the serving protocol (below the 2^20 cap)
TAG_CMD = 601
TAG_RES = 602
TAG_KV = 603

_VOCAB = 50021
_KV_MOD = 997

#: simulated model-forward costs (f32 tanh pass sizes).  Autoregressive
#: decode pays one TARGET pass per emitted token; a speculative verify
#: round pays one target pass for the whole window plus one cheap DRAFT
#: pass per proposed token — the gap IS the speculative win the A/B
#: measures, so both sides must price their passes.
_TARGET_PASS_ELEMS = 1 << 20
_DRAFT_PASS_ELEMS = 1 << 14

_spec_k_var = registry.register(
    "serving", None, "spec_k", vtype=VarType.INT, default=0,
    help="Speculative-decoding window: the draft model proposes this "
         "many tokens per decode step and the target model verifies "
         "them in one batched pass (accepted prefix + one "
         "correction/bonus token emitted per round).  0 (the default) "
         "decodes one target pass per token — speculative off")


def toy_kv(rid: int, elems: int) -> np.ndarray:
    """Deterministic stand-in KV block for request ``rid`` — both stages
    can recompute it, which turns KV streaming into a checkable
    transport (the decode side verifies arrival bit-exactly)."""
    base = (int(rid) * 1009 + np.arange(elems, dtype=np.int64)) % _KV_MOD
    return (base.astype(np.float32) / _KV_MOD)


def toy_token(rid: int, t: int) -> int:
    """Deterministic token ``t`` of request ``rid`` — decode survives a
    worker death because a replacement regenerates the identical
    continuation from ``tokens_done``."""
    return (int(rid) * 1_000_003 + int(t) * 7919) % _VOCAB


def toy_draft_token(rid: int, t: int) -> int:
    """The draft model's proposal for token ``t``: agrees with the
    target on 7 of every 8 positions and is off-by-one on the rest
    (``(rid + t) % 8 == 5``) — a deterministic acceptance pattern, so
    the speculative accept/reject counters are exactly reproducible
    and the tests pin them instead of sampling them."""
    tok = toy_token(rid, t)
    if (int(rid) + int(t)) % 8 == 5:
        return (tok + 1) % _VOCAB
    return tok


class ShardWorker:
    """One worker rank's engine loop (see module doc)."""

    def __init__(self, comm, router: Optional[int] = None,
                 role: str = "colocated", peer=None,
                 slots: int = 8, kv_elems: int = 256,
                 kv_partitions: Optional[int] = None,
                 kv_codec: Optional[str] = None,
                 spec_k: Optional[int] = None) -> None:
        from ompi_tpu_torch import serving as _pkg
        from ompi_tpu_torch.mca.coll import quant as quant_mod
        from ompi_tpu_torch.serving.kv_stream import (KvSlabReceiver,
                                                      KvSlabSender)
        from ompi_tpu_torch.serving.prefix_cache import PrefixStore

        comm.set_errhandler(ERRORS_RETURN)   # ULFM: errors raise, not abort
        self.comm = comm
        self.router = _pkg.roles(comm)[0] if router is None else int(router)
        self.role = role
        self.slots, self.kv_elems = int(slots), int(kv_elems)
        # quantized KV slabs (None = the otpu_coll_quant_kv_codec
        # default; "" = raw f32): both sides of every slab pairing in
        # this job resolve the same var, so the pairings agree
        self._kv_codec = quant_mod.kv_codec() if kv_codec is None \
            else str(kv_codec or "")
        # speculative window (None = the otpu_serving_spec_k default;
        # 0 = plain one-pass-per-token decode).  Resolved once: both
        # decode modes of a job agree for its lifetime
        self.spec_k = int(_spec_k_var.value or 0) if spec_k is None \
            else int(spec_k)
        self._kv: dict = {}          # rid -> local KV block (decode state)
        #: rids whose otpu-req flow hops this rank already emitted (a
        #: rid gets many work commands; its hop-0 finish and hop-2
        #: start must fire exactly once).  Trimmed with the KV cache.
        self._req_seen: set = set()
        self._stopped = False
        # prefix store: which block hashes this worker's cache still
        # holds, generation-stamped (the router's routing hints are
        # verified against it — see serving/prefix_cache.py).  The
        # codec stamp makes a codec RECONFIGURATION look like a
        # recovery to every outstanding hint (generation bump).
        self._prefix = PrefixStore()
        self._prefix.set_codec(self._kv_codec)
        self._prefix_hits = 0
        self._preport_installed: list = []
        self._preport_evicted: list = []
        self._preport_prefills = 0
        #: one KV slab sender per DECODE PEER: a prefill pool sized
        #: independently of its decode pool streams to several decode
        #: ranks, each over its own partitioned persistent pairing
        self._senders: dict = {}
        self._receiver = None
        if role == "prefill":
            peers = [int(peer)] if isinstance(peer, int) else \
                [int(p) for p in (peer or ())]
            if not peers:
                raise MpiError(ErrorClass.ERR_ARG,
                               "prefill worker needs >= 1 decode peer")
            for p in peers:
                self._senders[p] = KvSlabSender(comm, p, self.slots,
                                                self.kv_elems, TAG_KV,
                                                codec=self._kv_codec)
        elif role == "decode":
            self._receiver = KvSlabReceiver(comm, int(peer), self.slots,
                                            self.kv_elems, TAG_KV,
                                            partitions=kv_partitions,
                                            codec=self._kv_codec)

    # -- compute ----------------------------------------------------------
    def _prefill(self, rid: int, prompt_len: int) -> np.ndarray:
        # simulated prefill cost scales with the prompt (a tanh pass
        # over prompt_len model rows), result is the checkable KV block.
        # serve_prefills counts exactly these FULL passes — the prefix
        # cache's value shows up as this counter staying below the
        # request count (the acceptance soak asserts the delta)
        spc.record("serve_prefills")
        _ = np.tanh(np.arange(int(prompt_len) * 8,
                              dtype=np.float32)).sum()
        return toy_kv(rid, self.kv_elems)

    def _prefill_or_skip(self, rid: int, prompt_len: int, phashes,
                         hint) -> np.ndarray:
        """Prefill with the prefix cache consulted: a verified hint —
        the hinted block is in THIS store at THIS generation — skips
        the full pass (the cached KV serves the prefix; the toy model
        regenerates the block directly).  Any mismatch, full prefill.
        Either way the prompt's blocks are (re-)installed and the
        caller's pending prefix report picks up what the LRU evicted."""
        hit = bool(hint) and self._prefix.has(hint[0], int(hint[1]))
        if not hit:
            self._preport_prefills += 1
        if hit:
            spc.record("serve_prefix_hits")
            self._prefix_hits += 1
            # only the UNCACHED suffix pays prefill compute: the hinted
            # blocks' KV is already resident (hint[2] counts them)
            from ompi_tpu_torch.serving.prefix_cache import block_size

            cached = int(hint[2]) * block_size() if len(hint) > 2 else 0
            suffix = max(0, int(prompt_len) - cached)
            if suffix:
                _ = np.tanh(np.arange(suffix * 8,
                                      dtype=np.float32)).sum()
            kv = toy_kv(rid, self.kv_elems)
        else:
            if hint:
                # stale hint (evicted entry or a previous store
                # lifetime): a perf miss, NEVER wrong KV
                spc.record("serve_prefix_stale")
            kv = self._prefill(rid, prompt_len)
        if phashes:
            self._preport_installed.extend(phashes)
            self._preport_evicted.extend(self._prefix.add_all(phashes))
        return kv

    def _take_preport(self):
        """Drain the pending prefix report (rides the next reply to
        the router, which folds it into its registry — the same
        idempotent piggyback channel as the KV eviction notices).
        ``prefills``/``hits`` carry the worker's full-pass and
        skipped-pass counts to the router: SPC counters are
        per-process, so the router side is where a fleet-wide
        prefill-delta can actually be read."""
        if not (self._preport_installed or self._preport_evicted
                or self._prefix_hits or self._preport_prefills):
            return None
        rep = {"gen": self._prefix.generation,
               "installed": self._preport_installed,
               "evicted": self._preport_evicted,
               "hits": self._prefix_hits,
               "prefills": self._preport_prefills}
        self._preport_installed = []
        self._preport_evicted = []
        self._prefix_hits = 0
        self._preport_prefills = 0
        return rep

    def _decode(self, rid: int, tokens_done: int, n: int) -> list:
        kv = self._kv.get(rid)
        if kv is None:
            raise MpiError(ErrorClass.ERR_INTERN,
                           f"decode of rid {rid} without its KV block")
        # one fused read of the KV block per chunk keeps the toy model
        # honest about touching its state
        n = int(n)
        _ = float(kv[: max(1, n)].sum())
        if self.spec_k <= 0:
            # plain autoregressive decode: one target forward pass per
            # emitted token (each token conditions on the previous)
            for _i in range(n):
                _ = np.tanh(np.arange(_TARGET_PASS_ELEMS,
                                      dtype=np.float32)).sum()
            return [toy_token(rid, tokens_done + i) for i in range(n)]
        return self._decode_speculative(rid, tokens_done, n)

    def _decode_speculative(self, rid: int, tokens_done: int,
                            n: int) -> list:
        """Speculative decode of one chunk: the draft proposes up to
        ``spec_k`` tokens, the target verifies the whole window in ONE
        batched pass, and the accepted prefix plus one target token
        (the correction at the first mismatch, or the bonus token after
        a fully accepted window) is emitted — so every round makes
        progress and the output is the target model's token stream
        bit-for-bit regardless of what the draft proposed (the router
        re-verifies every token downstream)."""
        out: list = []
        t = int(tokens_done)
        while len(out) < n:
            window = min(self.spec_k, n - len(out))
            proposals = []
            for i in range(window):
                _ = np.tanh(np.arange(_DRAFT_PASS_ELEMS,
                                      dtype=np.float32)).sum()
                proposals.append(toy_draft_token(rid, t + i))
            # one batched target pass verifies all `window` positions
            # (and yields the window+1'th logits for free)
            _ = np.tanh(np.arange(_TARGET_PASS_ELEMS,
                                  dtype=np.float32)).sum()
            accepted = 0
            for i, prop in enumerate(proposals):
                if prop != toy_token(rid, t + i):
                    break
                accepted += 1
            rejected = window - accepted
            if accepted:
                spc.record("serve_spec_accepts", accepted)
            if rejected:
                spc.record("serve_spec_rejects", rejected)
            out.extend(toy_token(rid, t + i) for i in range(accepted))
            t += accepted
            if len(out) < n:
                # the verify pass already computed this position's
                # target token: correction on a mismatch, bonus after
                # a clean window
                out.append(toy_token(rid, t))
                t += 1
        return out

    # -- command handlers --------------------------------------------------
    def _handle(self, msg) -> None:
        kind = msg[0]
        if kind == "work":
            self._on_work(msg[1], msg[2])
        elif kind == "prefill":
            self._on_prefill(msg[1], msg[2], msg[3])
        elif kind == "kv":
            self._on_kv(msg[1], msg[2])
        elif kind == "scale":
            self._on_scale(msg[1], msg[2])
        elif kind == "stop":
            self._stopped = True
        else:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"unknown serving command {kind!r}")

    def _on_work(self, batch, free_rids) -> None:
        """Colocated/decode micro-batch: (rid, prompt_len, tokens_done,
        n, phashes, hint) per entry; results are one coalesced reply
        carrying the pending prefix report."""
        from ompi_tpu_torch.ft import chaos

        if chaos.enabled:
            # serve-through-failure drills: 'kill:site=serve_work,
            # count=k' dies on the (k+1)-th micro-batch, mid-load with
            # results unsent (tests/test_torch_serving.py's victim schedule)
            chaos.kill_point("serve_work")
            # designed-slow-worker drills: 'delay:ms=8,rank=2,
            # site=serve_work' paces every micro-batch on that rank —
            # the tail cohort otpu_analyze --requests must attribute
            chaos.pace("serve_work")
        req_on = trace.requests_enabled
        firsts = set()                 # rids first seen THIS command
        results = []
        for rid, prompt_len, tokens_done, n, phashes, hint in batch:
            if req_on and rid not in self._req_seen:
                self._req_seen.add(rid)
                firsts.add(rid)
            if rid not in self._kv:
                if self.role == "decode":
                    raise MpiError(
                        ErrorClass.ERR_INTERN,
                        f"decode work for rid {rid} before its KV block")
                if rid in firsts:
                    # colocated: this work cmd carried the dispatch
                    # (otpu-req hop 0) AND runs the prefill stage
                    trace.flow_finish("serve_req", (rid, 0))
                    t0 = trace.now()
                self._kv[rid] = self._prefill_or_skip(rid, prompt_len,
                                                      phashes, hint)
                if rid in firsts:
                    trace.span("req_prefill", "serve_req", t0,
                               args={"rid": rid})
                    spc.record("req_stages")
            toks = self._decode(rid, tokens_done, n)
            spc.record("serve_tokens", len(toks))
            if rid in firsts:
                # hop 2 opens at this rid's first token chunk; the
                # router closes it when the request completes
                trace.flow_start("serve_req", (rid, 2))
            results.append((rid, toks))
        for rid in free_rids:          # router-confirmed evictions
            self._kv.pop(rid, None)
            self._req_seen.discard(rid)
        self.comm.send_obj(("res", results, self._take_preport()),
                           self.router, TAG_RES)

    def _on_prefill(self, peer, epoch, batch) -> None:
        """Prefill-stage micro-batch for ONE decode peer's slab:
        compute each block (prefix cache consulted), Pready it the
        moment it is final, aggregate-flush the slab tail."""
        sender = self._senders.get(int(peer))
        if sender is None:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"prefill asked to stream to decode rank "
                           f"{peer} but no slab pairing exists "
                           f"(peers: {sorted(self._senders)})")
        sender.begin_epoch(epoch)
        req_on = trace.requests_enabled
        rids = []
        for rid, slot, prompt_len, phashes, hint in batch:
            if req_on:
                # otpu-req hop 0 closes at command receipt; the prefill
                # stage span covers compute + slab write, and slot_ready
                # opens hop 1 (prefill -> decode, riding the Pready key)
                trace.flow_finish("serve_req", (rid, 0))
                t0 = trace.now()
            sender.write_slot(slot, self._prefill_or_skip(
                rid, prompt_len, phashes, hint))
            sender.slot_ready(slot, rid=rid if req_on else None)
            if req_on:
                trace.span("req_prefill", "serve_req", t0,
                           args={"rid": rid})
                spc.record("req_stages")
            rids.append(rid)
        sender.finish_epoch(wait=True)
        self.comm.send_obj(("prefilled", epoch, rids,
                            self._take_preport()), self.router,
                           TAG_RES)

    def _on_kv(self, epoch, batch) -> None:
        """Decode-stage KV intake: poll Parrived per assigned slot, copy
        the block out (verified against the deterministic model), then
        drain the epoch's tail so the next one may start."""
        from ompi_tpu_torch.runtime.progress import progress

        self._receiver.begin_epoch(epoch)
        req_on = trace.requests_enabled
        t0 = trace.now() if req_on else 0
        pending = list(batch)
        rids = []
        while pending:
            still = []
            for rid, slot in pending:
                if self._receiver.slot_arrived(slot):
                    # read_slot closes otpu-req hop 1 for this rid
                    # (the arrow the KV slab's Pready key launched)
                    block = self._receiver.read_slot(
                        slot, rid=rid if req_on else None)
                    expect = toy_kv(rid, self.kv_elems)
                    if self._kv_codec:
                        # quantized slab: the decoded block must land
                        # within the codec's band of the exact KV —
                        # outside it is transport corruption, not
                        # quantization
                        from ompi_tpu_torch.mca.coll import quant as _q

                        tol = _q.CODEC_BANDS[self._kv_codec] \
                            * max(1e-6, float(np.abs(expect).max()))
                        if not np.allclose(block, expect, atol=tol,
                                           rtol=0.0):
                            raise AssertionError(
                                f"KV stream corrupted rid {rid} slot "
                                f"{slot} (outside the "
                                f"{self._kv_codec} band)")
                    elif not np.array_equal(block, expect):
                        raise AssertionError(
                            f"KV stream corrupted rid {rid} slot {slot}")
                    self._kv[rid] = block
                    if req_on:
                        # KV intake wait for this rid: epoch start ->
                        # its slab partition arrived and verified
                        trace.span("req_kv", "serve_req", t0,
                                   args={"rid": rid})
                        spc.record("req_stages")
                    rids.append(rid)
                else:
                    still.append((rid, slot))
            pending = still
            if pending:
                progress()
        self._receiver.finish_epoch()
        self.comm.send_obj(("kv_ready", epoch, rids), self.router,
                           TAG_RES)

    def _on_scale(self, argv, n) -> None:
        """Autoscale participation: spawn is collective over the comm,
        so every worker joins the router's MPI_Comm_spawn + merge; the
        merged communicator (parents first) replaces ours."""
        inter = self.comm.spawn(list(argv), int(n), root=self.router)
        full = inter.merge(high=False)
        full.set_errhandler(ERRORS_RETURN)
        self.comm = full               # router keeps comm-rank 0 ordering

    # -- engine loop -------------------------------------------------------
    def step(self) -> bool:
        """Handle at most one pending command; False when idle."""
        found, _st = self.comm.iprobe(self.router, TAG_CMD)
        if not found:
            return False
        msg = self.comm.recv_obj(self.router, TAG_CMD)
        self._handle(msg)
        return True

    def serve(self) -> None:
        """Loop until the router says stop.  Revocation (the router saw
        a death) or a direct peer-failure report drops into recovery;
        a dead ROUTER ends the loop — workers cannot serve without
        admission control."""
        idle_s = 0.0005
        while not self._stopped:
            try:
                if not self.step():
                    time.sleep(idle_s)
            except RevokedError:
                self._recover()
            except ProcFailedError:
                from ompi_tpu_torch.ft import state as ft_state

                router_world = self.comm.group.world_rank(self.router)
                if ft_state.is_failed(router_world):
                    return             # no admission control left
                self._recover()

    def _recover(self) -> None:
        """Serve-through-failure, worker side: shrink with the other
        survivors, rebind, fall back to the colocated role (a stage
        pair may have lost its other half), keep serving.  The prefix
        store clears WITH a generation bump: every routing hint minted
        against the pre-shrink store must miss, never alias."""
        for stream in list(self._senders.values()) + [self._receiver]:
            if stream is not None:
                try:
                    stream.free()
                except Exception:
                    pass               # stream rode the dead comm
        self._senders = {}
        self._receiver = None
        self._req_seen.clear()         # replays re-emit their hops
        self._prefix.clear()
        self._preport_installed = []
        self._preport_evicted = []
        self._prefix_hits = 0
        self._preport_prefills = 0
        new = self.comm.shrink()
        new.set_errhandler(ERRORS_RETURN)
        self.comm = new
        from ompi_tpu_torch import serving as _pkg

        self.router = _pkg.roles(new)[0]
        self.role = "colocated"


def worker_main(argv: Optional[list] = None) -> int:
    """Entry point of an AUTOSCALED worker process (``python -m
    ompi_tpu_torch.serving.worker [DEVICE]``): meet the parents through
    ``MPI_Comm_get_parent``, merge into their serving communicator
    (children rank after parents, so the router's rank is unchanged),
    and serve.  ``DEVICE`` is the device the world binds to (default:
    the card; ``cpu`` where there is none)."""
    import sys

    import ompi_tpu_torch

    args = sys.argv[1:] if argv is None else list(argv)
    ompi_tpu_torch.init(device=args[0] if args else None)
    parent = ompi_tpu_torch.get_parent()
    if parent is None:
        raise SystemExit("serving worker_main: not a spawned process")
    full = parent.merge(high=True)
    ShardWorker(full, router=0).serve()
    return 0


if __name__ == "__main__":
    raise SystemExit(worker_main())
