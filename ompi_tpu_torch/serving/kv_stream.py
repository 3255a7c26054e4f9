"""serving/kv_stream — KV-cache slabs streamed prefill → decode over
MPI-4 partitioned persistent requests.

Copy of ``ompi_tpu/serving/kv_stream.py`` with its imports re-pointed,
over the port's ``mca/part`` (``psend_init``, ``precv_init``, ``pready``,
``pready_list``, ``parrived``).  The slabs are host numpy arrays, as in the
reference: float32 rows raw, ``uint8`` rows of coll/quant's host codec
bytes with a codec, so a slot holds the reference's bytes for each codec.
The port's partitioned receive takes each wire message with ``irecv`` and
lands it at the receive's completion (``mca/part/persist.py``), so a slot
readied with ``Pready`` is visible to ``Parrived`` before the epoch's tail
flush, at the receiver's sub-slot granularity too.

One stage pair (a prefill worker and its decode peer) shares a fixed
slab of ``slots`` KV blocks.  The pair binds the slab ONCE —
``Psend_init`` on the prefill side, ``Precv_init`` on the decode side —
and then runs one partitioned *epoch* per prefill micro-batch:

* the sender starts the epoch, writes each sequence's KV block into its
  assigned slot and releases it with ``Pready(slot)`` the moment that
  sequence's prefill finishes — transfer of finished sequences overlaps
  the prefill compute of the rest (the bucketed-gradient-overlap
  pattern of ``mca/part`` pointed at inference);
* slots not used by this micro-batch are flushed in one aggregated tail
  (``Pready_range`` + ``otpu_part_persist_min_partitions`` coalescing),
  which is what completes the epoch — MPI-4 partitioned semantics make
  the whole slab the message, so the slab should be sized to the batch;
* the receiver polls ``Parrived`` per slot (exact even when its
  partition count differs from the sender's — the byte-framed wire
  protocol counts arrival against RECEIVER partitions) and copies each
  block out before the next epoch overwrites the slab.

Epoch numbering is explicit and checked: the router stamps every
prefill micro-batch with the epoch index both sides must be on, so a
desync (a stage skipping a round) is a loud error, not silent
corruption — ``mca/part``'s epoch-stamped wire protocol underneath
already keeps a restarted sender's bytes out of the previous epoch.

**Quantized slabs** (``otpu_coll_quant_kv_codec``): with a codec, each
slot holds the coll/quant block-scale ENCODING of its KV block (int8 +
per-block f32 scales: ~3.9x smaller; bf16: 2x) over the SAME
partitioned persistent pairing — the slab is just bytes to ``mca/part``
— so a worker's fixed slab budget holds 2-4x more concurrent
sequences.  Both sides of a pairing must agree on the codec (they are
built from the same MCA var/config); the fleet's stale-hint guarantee
survives a codec change because the worker's PrefixStore bumps its
generation on ``set_codec`` — a hint minted against the old encoding
can only ever be a perf miss, never wrong KV.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.mca.coll import quant as quant_mod
from ompi_tpu_torch.runtime import spc, trace


class _KvSlabBase:
    """Shared geometry of one stage pair's slab."""

    def __init__(self, slots: int, elems_per_slot: int,
                 codec: Optional[str] = None) -> None:
        if slots <= 0 or elems_per_slot <= 0:
            raise MpiError(ErrorClass.ERR_ARG,
                           "KV slab needs positive slots/elems")
        self.slots = int(slots)
        self.elems_per_slot = int(elems_per_slot)
        # codec None = the MCA var's job-wide default; "" = raw f32
        self.codec = quant_mod.kv_codec() if codec is None \
            else str(codec or "")
        if self.codec:
            if self.codec not in quant_mod.CODECS:
                raise MpiError(
                    ErrorClass.ERR_ARG,
                    f"unknown KV slab codec {self.codec!r} (known: "
                    f"{', '.join(quant_mod.CODECS)})")
            self._block = quant_mod.block_elems()
            self.slot_nbytes = quant_mod.encoded_nbytes(
                self.elems_per_slot, self.codec, self._block)
            self.slab = np.zeros((self.slots, self.slot_nbytes),
                                 np.uint8)
        else:
            self._block = 0
            self.slot_nbytes = 4 * self.elems_per_slot
            self.slab = np.zeros((self.slots, self.elems_per_slot),
                                 np.float32)
        self.epoch = -1

    @property
    def capacity_multiplier(self) -> float:
        """How many more sequences a fixed byte budget holds under the
        codec (1.0 for raw slabs) — the users-per-chip multiplier."""
        return (4.0 * self.elems_per_slot) / self.slot_nbytes

    def _check_slot(self, slot: int) -> int:
        if not 0 <= int(slot) < self.slots:
            raise MpiError(ErrorClass.ERR_ARG,
                           f"KV slot {slot} out of [0, {self.slots})")
        return int(slot)

    def _check_epoch(self, epoch: int) -> None:
        if int(epoch) != self.epoch:
            raise MpiError(
                ErrorClass.ERR_REQUEST,
                f"KV stream desync: asked for epoch {epoch} while the "
                f"slab is on epoch {self.epoch} — a stage skipped or "
                "repeated a prefill round")


class KvSlabSender(_KvSlabBase):
    """Prefill side of one stage pair."""

    def __init__(self, comm, peer: int, slots: int, elems_per_slot: int,
                 tag: int, codec: Optional[str] = None) -> None:
        super().__init__(slots, elems_per_slot, codec)
        self.req = comm.psend_init(self.slab, self.slots, dest=peer,
                                   tag=tag)
        self._readied: set = set()

    def begin_epoch(self, epoch: int) -> None:
        """Start partitioned epoch ``epoch`` (must be the successor of
        the previous one — both sides count rounds)."""
        if int(epoch) != self.epoch + 1:
            raise MpiError(
                ErrorClass.ERR_REQUEST,
                f"KV sender asked to begin epoch {epoch} after "
                f"{self.epoch} — epochs are consecutive")
        self.req.start()
        self.epoch = int(epoch)
        self._readied.clear()
        spc.record("serve_kv_epochs")

    def write_slot(self, slot: int, kv: np.ndarray) -> None:
        """Land one finished sequence's KV block in its slot (pad/trim
        to the slab row — a toy stand-in for paged KV layout).  With a
        codec armed the slot holds the block-scale ENCODING."""
        s = self._check_slot(slot)
        row = np.asarray(kv, np.float32).reshape(-1)
        n = min(row.size, self.elems_per_slot)
        if self.codec:
            full = np.zeros(self.elems_per_slot, np.float32)
            full[:n] = row[:n]
            self.slab[s, :] = quant_mod.encode_f32(full, self.codec,
                                                   self._block)
            return
        self.slab[s, :n] = row[:n]
        self.slab[s, n:] = 0.0

    def slot_ready(self, slot: int, rid: Optional[int] = None) -> None:
        """``Pready`` for one finished sequence — its block starts
        travelling while later sequences are still prefilling.  With a
        ``rid`` (otpu-req armed) the Pready doubles as the producing
        half of the request's hop-1 flow edge: the per-sequence
        partition key the slab already carries IS the causal link
        prefill -> decode, so the arrow costs one ring slot, no wire
        bytes."""
        s = self._check_slot(slot)
        self.req.pready(s)
        self._readied.add(s)
        if rid is not None:
            trace.flow_start("serve_req", (rid, 1))

    def finish_epoch(self, wait: bool = True) -> None:
        """Flush the unused remainder of the slab (one aggregated tail
        run — ``Pready_list``; the final ready force-flushes contiguous
        runs as single wire messages) to complete the epoch; ``wait``
        blocks until every block is on the wire."""
        self.req.pready_list([s for s in range(self.slots)
                              if s not in self._readied])
        self._readied.update(range(self.slots))
        if wait:
            self.req.wait()

    def free(self) -> None:
        self.req.free()


class KvSlabReceiver(_KvSlabBase):
    """Decode side of one stage pair.

    ``partitions`` may exceed the sender's slot count (any multiple of
    ``slots``): arrival is then tracked at sub-slot granularity and
    :meth:`slot_arrived` maps a slot onto its RUN of receiver
    partitions — the mismatched-partition-count exactness of
    ``mca/part``'s byte-framed protocol, which the serving tests pin.
    """

    def __init__(self, comm, peer: int, slots: int, elems_per_slot: int,
                 tag: int, partitions: Optional[int] = None,
                 codec: Optional[str] = None) -> None:
        super().__init__(slots, elems_per_slot, codec)
        self.partitions = int(partitions) if partitions else self.slots
        if self.partitions % self.slots:
            raise MpiError(
                ErrorClass.ERR_ARG,
                f"{self.partitions} receiver partitions do not tile "
                f"{self.slots} KV slots")
        self._parts_per_slot = self.partitions // self.slots
        self.req = comm.precv_init(self.slab, self.partitions,
                                   source=peer, tag=tag)

    def begin_epoch(self, epoch: int) -> None:
        if int(epoch) != self.epoch + 1:
            raise MpiError(
                ErrorClass.ERR_REQUEST,
                f"KV receiver asked to begin epoch {epoch} after "
                f"{self.epoch} — epochs are consecutive")
        self.req.start()
        self.epoch = int(epoch)

    def slot_arrived(self, slot: int) -> bool:
        """Has this sequence's whole block landed (all of the slot's
        receiver partitions, exact under mismatched counts)?"""
        s = self._check_slot(slot)
        lo = s * self._parts_per_slot
        return self.req.parrived_range(lo, lo + self._parts_per_slot - 1)

    def read_slot(self, slot: int,
                  rid: Optional[int] = None) -> np.ndarray:
        """COPY one arrived block out — the next epoch reuses the slab,
        so decode state must not alias it.  With a codec armed the
        block is dequantized here (the decode owns its memory).  A
        ``rid`` closes the request's hop-1 flow edge (the consuming
        half of the arrow :meth:`KvSlabSender.slot_ready` launched)."""
        s = self._check_slot(slot)
        if not self.slot_arrived(s):
            raise MpiError(ErrorClass.ERR_REQUEST,
                           f"KV slot {s} read before it arrived "
                           f"(epoch {self.epoch})")
        if rid is not None:
            trace.flow_finish("serve_req", (rid, 1))
        if self.codec:
            return quant_mod.decode_f32(self.slab[s], self.codec,
                                        self.elems_per_slot,
                                        self._block)
        return self.slab[s].copy()

    def finish_epoch(self) -> None:
        """Block until the whole slab (the epoch's tail flush included)
        has landed — after this the sender may begin the next epoch."""
        self.req.wait()

    def free(self) -> None:
        self.req.free()
