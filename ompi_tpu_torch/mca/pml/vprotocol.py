"""pml/v + vprotocol/pessimist — message-event logging for replay FT.

Copy of ``ompi_tpu/mca/pml/vprotocol.py`` (after the reference's
``ompi/mca/pml/v``, the interposition shell, and
``ompi/mca/vprotocol/pessimist``): pessimistic message logging records,
to stable storage, every nondeterministic event a rank observes — most
importantly the DELIVERY ORDER of receives (any-source matches are where
replay diverges) — plus send envelopes, so a restarted rank can be
re-driven to its pre-failure state by replaying the log against re-sent
messages.

Enable with ``otpu_vprotocol_pessimist_log=<dir>``: each rank appends
JSONL events to ``<dir>/events.<world_rank>.log``.  Payload hashes make
the log auditable without storing data; ``log_payloads`` stores the bytes
too (full sender-based logging).  The lines are the reference's, key for
key: the same program logs the same ``ev``, ``sc``, ``sha`` and
``payload`` in both packages.

A tensor sent while logging or replaying (on the card or not) is staged
to the host once, through ``torch_acc.to_host`` (``api.comm.host_buffer``):
its digest and payload are those host bytes, as the reference's
``np.asarray`` of a ``jax.Array``, and the staged array is what goes on to
the pml, so ob1 does not stage it a second time.

The interposition mirrors pml/monitoring: the selected pml module is
wrapped at init, outside monitoring's wrapper, transparently for every
caller.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np

from ompi_tpu_torch.base.var import VarType, registry

_log_var = registry.register(
    "vprotocol", "pessimist", "log", vtype=VarType.STRING, default="",
    help="Directory for pessimistic message-event logs (empty = disabled)")
_payload_var = registry.register(
    "vprotocol", "pessimist", "log_payloads", vtype=VarType.BOOL,
    default=False,
    help="Store full payload bytes (sender-based logging), not just hashes")


def enabled() -> bool:
    return bool((_log_var.value or "").strip())


def _staged(buf) -> tuple:
    """``(buffer for the pml, ndarray of its bytes)``: a tensor is staged
    to the host once and the staged array stands for it in both; anything
    else is passed on as given and read through ``np.asarray``, as the
    reference reads it."""
    from ompi_tpu_torch.api.comm import host_buffer, is_tensor

    if is_tensor(buf):
        arr = host_buffer(buf)
        return arr, arr
    return buf, np.asarray(buf)


class PessimistPml:
    """Interposition pml recording send envelopes + delivery order."""

    def __init__(self, inner, rte) -> None:
        self._inner = inner
        self._dir = (_log_var.value or "").strip()
        os.makedirs(self._dir, exist_ok=True)
        self._path = os.path.join(self._dir,
                                  f"events.{rte.my_world_rank}.log")
        self._fh = open(self._path, "a", buffering=1)
        self._lock = threading.RLock()   # clock bump + event write nest
        self._seq = 0
        self._payloads = bool(_payload_var.value)
        # per-channel event clocks (the reference's
        # ``vprotocol_pessimist_event.h`` clock stamps): a channel is
        # (peer world rank, cid, tag) — within one, MPI matching is
        # non-overtaking, so the channel sequence number pins each recv
        # to exactly one send even when several comms or tags carry
        # concurrent traffic between the same pair
        self._send_clk: dict[tuple, int] = {}
        self._recv_clk: dict[tuple, int] = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _event(self, kind: str, **fields) -> None:
        with self._lock:
            self._seq += 1
            fields.update(kind=kind, ev=self._seq)
            self._fh.write(json.dumps(fields) + "\n")

    def _digest(self, buf) -> str:
        try:
            return hashlib.sha1(np.ascontiguousarray(buf)
                                .view(np.uint8)).hexdigest()[:16]
        except Exception:
            return "?"

    # -- send side: envelope (+ payload when sender-based logging) -------
    def _log_send(self, comm, buf, dest, tag):
        """Log the send's envelope; returns the buffer the pml gets (a
        tensor staged to the host once, anything else as given)."""
        buf, arr = _staged(buf)
        grp = comm.remote_group if comm.is_inter else comm.group
        # WORLD ranks in the log: events.<world>.log files are keyed by
        # world rank, so replay's cross-log pairing must be too
        dst = int(grp.world_rank(dest))
        chan = (dst, comm.cid, int(tag))
        rec = dict(cid=comm.cid, dst=dst, tag=int(tag),
                   nbytes=int(arr.nbytes), sha=self._digest(arr))
        if self._payloads:
            rec["payload"] = np.ascontiguousarray(arr).view(np.uint8) \
                .tobytes().hex()
        with self._lock:   # clock bump + write atomic: events must land
            sc = self._send_clk[chan] = \
                self._send_clk.get(chan, -1) + 1   # in sc order per chan
            self._event("send", sc=sc, **rec)
        return buf

    def send(self, comm, buf, dest, tag, **kw):
        buf = self._log_send(comm, buf, dest, tag)
        return self._inner.send(comm, buf, dest, tag, **kw)

    def isend(self, comm, buf, dest, tag, **kw):
        buf = self._log_send(comm, buf, dest, tag)
        return self._inner.isend(comm, buf, dest, tag, **kw)

    # -- recv side: the nondeterministic event is the MATCH --------------
    def _log_match(self, comm, req) -> None:
        self._log_match_st(comm, req.status)

    def recv(self, comm, buf, source, tag):
        st = self._inner.recv(comm, buf, source, tag)
        self._log_match_st(comm, st)
        return st

    def _log_match_st(self, comm, st) -> None:
        grp = comm.remote_group if comm.is_inter else comm.group
        src = int(grp.world_rank(st.source))
        chan = (src, comm.cid, int(st.tag))
        with self._lock:   # clock bump + write atomic (sc order)
            sc = self._recv_clk[chan] = self._recv_clk.get(chan, -1) + 1
            self._event("recv", cid=comm.cid, src=src, tag=int(st.tag),
                        sc=sc)

    def irecv(self, comm, buf, source, tag):
        req = self._inner.irecv(comm, buf, source, tag)
        req.on_complete(lambda r: self._log_match(comm, r))
        return req

    def finalize(self):
        try:
            self._fh.close()
        except Exception:
            pass
        return self._inner.finalize()


_replay_var = registry.register(
    "vprotocol", "pessimist", "replay", vtype=VarType.STRING, default="",
    help="Replay directory: re-drive this rank's execution from the "
         "pessimist logs (recvs satisfied from logged delivery order, "
         "sends envelope-verified + suppressed when provably delivered), "
         "then fall through to live execution")
_replay_rank_var = registry.register(
    "vprotocol", "pessimist", "replay_rank", vtype=VarType.INT, default=-1,
    help="World rank whose log to replay (default: this process's rank)")


def replay_enabled() -> bool:
    return bool((_replay_var.value or "").strip())


class ReplayDivergence(RuntimeError):
    """The re-executed program issued an operation that does not match
    the logged envelope — the piecewise-deterministic assumption broke."""


class ReplayPml:
    """Re-drive a restarted rank from the pessimist logs.

    The reference's pessimist replay (``ompi/mca/vprotocol/pessimist/``)
    re-delivers logged messages in their logged order until the restarted
    rank catches up, then switches to live execution.  Same model here,
    receiver-pull form over the shared log directory:

    - each **recv** consumes the next logged delivery event: the source
      is pinned to the logged one (the any-source nondeterminism this
      protocol exists to remove), and the payload is pulled from the
      SENDER's log (which is why replay requires
      ``otpu_vprotocol_pessimist_log_payloads=1`` job-wide — full
      sender-based logging);
    - each **send** is verified against the next logged send envelope
      (dst/tag/bytes/sha — a mismatch raises :class:`ReplayDivergence`)
      and then SUPPRESSED iff the receiver's log proves delivery
      (its recv-event count from me covers this send); an in-flight
      send the receiver never matched is re-sent live, so a peer
      resuming just past the crash boundary still receives it;
    - when the log is exhausted every operation passes through to the
      live pml.

    Matching is ORDER-based per rank (the k-th recv of the re-execution
    consumes the k-th logged delivery): the piecewise-deterministic
    execution assumption pessimistic logging is built on.  All log ranks
    are WORLD ranks.

    Payload pairing is by **channel event clock** — a channel is
    (peer, cid, tag) and both sides stamp events with their channel
    sequence number (``sc``), mirroring the reference's per-event clock
    stamps (``vprotocol_pessimist_event.h``): the receiver's k-th
    logged delivery on a channel pairs with the sender's k-th send on
    it, which is exact even when several communicators or tags carry
    concurrent, arbitrarily interleaved traffic between the same pair
    (MPI matching is non-overtaking only WITHIN a channel).  Delivery
    proofs for send suppression are per-channel for the same reason — a
    global count could let another channel's deliveries suppress a send
    that never arrived.
    """

    def __init__(self, inner, rte) -> None:
        self._inner = inner
        self._dir = (_replay_var.value or "").strip()
        rr = int(_replay_rank_var.value)
        self._rank = rr if rr >= 0 else rte.my_world_rank
        events = read_log(self._dir, self._rank)
        self._sends = [e for e in events if e["kind"] == "send"]
        self._recvs = [e for e in events if e["kind"] == "recv"]
        self._si = 0
        self._ri = 0
        # per-source, per-(cid,tag)-channel queues of the sender's
        # logged sends addressed to me (channel-clock pairing)
        self._src_sends: dict[int, dict[tuple, list]] = {}
        # delivery proof per (dst, cid, tag) channel: how many of MY
        # sends on it the dst's log shows matched; sends beyond that
        # are re-sent live
        self._delivered: dict[int, dict[tuple, int]] = {}
        self._sent_to: dict[tuple, int] = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def replay_active(self) -> bool:
        return self._si < len(self._sends) or self._ri < len(self._recvs)

    # -- log plumbing ----------------------------------------------------
    def _sends_from(self, src: int, cid: int, tag: int) -> list:
        chans = self._src_sends.get(src)
        if chans is None:
            chans = {}
            for e in read_log(self._dir, src):
                if e["kind"] == "send" and int(e["dst"]) == self._rank:
                    chans.setdefault(
                        (int(e["cid"]), int(e["tag"])), []).append(e)
            self._src_sends[src] = chans
        return chans.get((int(cid), int(tag)), [])

    def _delivered_count(self, dst: int, cid: int, tag: int) -> int:
        chans = self._delivered.get(dst)
        if chans is None:
            chans = {}
            try:
                for e in read_log(self._dir, dst):
                    if (e["kind"] == "recv"
                            and int(e["src"]) == self._rank):
                        k = (int(e["cid"]), int(e["tag"]))
                        chans[k] = chans.get(k, 0) + 1
            except OSError:
                pass   # peer never logged: nothing provably delivered
            self._delivered[dst] = chans
        return chans.get((int(cid), int(tag)), 0)

    # -- send side -------------------------------------------------------
    def _replay_send(self, comm, buf, dest, tag) -> bool:
        """True when the send was consumed by the log (suppressed or
        re-sent live); False when the log is exhausted."""
        if self._si >= len(self._sends):
            return False
        e = self._sends[self._si]
        buf, arr = _staged(buf)
        grp = comm.remote_group if comm.is_inter else comm.group
        dst_world = int(grp.world_rank(dest))
        if (int(e["dst"]) != dst_world or int(e["tag"]) != int(tag)
                or int(e["cid"]) != int(comm.cid)
                or int(e["nbytes"]) != int(arr.nbytes)):
            raise ReplayDivergence(
                f"send #{self._si} diverged: logged (dst={e['dst']} "
                f"cid={e['cid']} tag={e['tag']} nbytes={e['nbytes']}) "
                f"vs replayed (dst={dst_world} cid={comm.cid} tag={tag} "
                f"nbytes={arr.nbytes})")
        sha = hashlib.sha1(np.ascontiguousarray(arr)
                           .view(np.uint8)).hexdigest()[:16]
        if e.get("sha") not in ("?", sha):
            raise ReplayDivergence(
                f"send #{self._si} payload hash diverged "
                f"(logged {e['sha']}, replayed {sha})")
        self._si += 1
        chan = (dst_world, int(e["cid"]), int(tag))
        seq = self._sent_to.get(chan, 0)
        self._sent_to[chan] = seq + 1
        if seq < self._delivered_count(dst_world, e["cid"], tag):
            return True            # provably delivered: suppress
        self._inner.send(comm, buf, dest, tag)   # in-flight at crash
        return True

    def send(self, comm, buf, dest, tag, **kw):
        if self._replay_send(comm, buf, dest, tag):
            return None
        return self._inner.send(comm, buf, dest, tag, **kw)

    def isend(self, comm, buf, dest, tag, **kw):
        from ompi_tpu_torch.api.request import CompletedRequest

        if self._replay_send(comm, buf, dest, tag):
            return CompletedRequest()
        return self._inner.isend(comm, buf, dest, tag, **kw)

    # -- recv side -------------------------------------------------------
    def _replay_recv(self, comm, buf, source, tag):
        from ompi_tpu_torch.api.status import ANY_SOURCE, ANY_TAG, Status

        if self._ri >= len(self._recvs):
            return None
        e = self._recvs[self._ri]
        src = int(e["src"])            # world rank
        grp = comm.remote_group if comm.is_inter else comm.group
        if source != ANY_SOURCE and int(grp.world_rank(source)) != src:
            raise ReplayDivergence(
                f"recv #{self._ri} diverged: logged src world {src}, "
                f"replayed explicit source {source}")
        if tag != ANY_TAG and int(e["tag"]) != int(tag):
            raise ReplayDivergence(
                f"recv #{self._ri} diverged: logged tag {e['tag']}, "
                f"replayed tag {tag}")
        if int(e["cid"]) != int(comm.cid):
            raise ReplayDivergence(
                f"recv #{self._ri} diverged: logged cid {e['cid']}, "
                f"replayed on cid {comm.cid}")
        self._ri += 1
        q = self._sends_from(src, e["cid"], e["tag"])
        if not q:
            raise ReplayDivergence(
                f"recv #{self._ri - 1}: rank {src}'s log has no remaining "
                f"send for me on channel (cid={e['cid']} tag={e['tag']}) "
                f"— was the job run with "
                f"otpu_vprotocol_pessimist_log_payloads=1?")
        se = q.pop(0)
        if "sc" in se and "sc" in e and int(se["sc"]) != int(e["sc"]):
            raise ReplayDivergence(
                f"recv #{self._ri - 1}: channel clock mismatch (sender "
                f"sc={se['sc']}, delivery sc={e['sc']}) — logs are from "
                f"different runs or corrupted")
        if "payload" not in se:
            raise ReplayDivergence(
                f"sender {src} logged no payloads; replay requires "
                "otpu_vprotocol_pessimist_log_payloads=1 job-wide")
        data = bytes.fromhex(se["payload"])
        from ompi_tpu_torch.api.comm import as_buffer
        from ompi_tpu_torch.datatype import Convertor

        arr, count, dt = as_buffer(buf)
        conv = Convertor(dt, count, arr)
        n = conv.unpack(data[:conv.packed_size])
        return Status(source=int(grp.rank_of(src)), tag=int(e["tag"]),
                      _nbytes=n)

    def recv(self, comm, buf, source, tag):
        st = self._replay_recv(comm, buf, source, tag)
        if st is not None:
            return st
        return self._inner.recv(comm, buf, source, tag)

    def irecv(self, comm, buf, source, tag):
        from ompi_tpu_torch.api.request import CompletedRequest

        st = self._replay_recv(comm, buf, source, tag)
        if st is not None:
            return CompletedRequest(st)
        return self._inner.irecv(comm, buf, source, tag)


def maybe_wrap_pml(pml_module, rte):
    if replay_enabled() and getattr(rte, "client", None) is not None:
        # replay takes precedence; live ops after log exhaustion are not
        # re-logged (appending to the consumed log would corrupt it)
        return ReplayPml(pml_module, rte)
    if enabled() and getattr(rte, "client", None) is not None:
        return PessimistPml(pml_module, rte)
    return pml_module


def read_log(directory: str, rank: int) -> list:
    """Parse one rank's event log (the input of a replay)."""
    path = os.path.join(directory, f"events.{rank}.log")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
