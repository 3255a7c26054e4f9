"""coll/quant — block-scale quantization: the codec and its decision ladder.

Port of ``ompi_tpu/mca/coll/quant.py``, its three datapaths and the host
wire stage:

* the device tier: the rule that decides, per communicator, whether a
  device collective may run through a lossy block codec, and which.
  coll/builtin consumes it (``allreduce_array``, ``allgather_array``); the
  codec kernels are in ``ompi_tpu_torch/ops/quant.py`` (int8, K17–K19) and,
  for bf16, plain torch casts, as the reference computes that codec outside
  any Pallas kernel;
* the host tier: the numpy codec (``encode_f32``/``decode_f32``) and the
  tuned ladder's quant arm, ``allreduce_blockq``/``allgather_blockq`` (a
  tensor staged to the host once, at their entry);
* the wire stage of btl/tcp (``otpu_coll_quant_wire``, off by default):
  pml/ob1 stamps each fragment of a contiguous float32 message of
  ``min_bytes`` or more with :func:`wire_codec_for`, btl/tcp encodes its
  payload with :func:`encode_wire` between the convertor's pack and the
  out-queue and decodes it on the receive parse (:func:`decode_wire`) back
  to the original bytes; :func:`wire_stats` counts the original and the
  encoded bytes this process sent.

Codec formats (pure numpy, round-half-even everywhere so every process
encodes IDENTICAL bytes, the reference's bytes):

* ``int8``: per ``block`` elements one f32 scale ``max(|x|)/127``; layout
  ``[f32 scales x nblocks][int8 q x n]`` — ~3.9x smaller at the default
  block of 128;
* ``bf16``: round-to-nearest-even truncation to the top 16 bits; NaNs skip
  the rounding add and keep a forced mantissa bit; layout ``[u16 x n]``.

Quantization is LOSSY, so it engages only under an EXPLICIT
per-communicator accuracy budget (the info key :data:`BUDGET_KEY`), never
for non-commutative reductions (the codec reorders rounding error the way
a ring reorders operands), and never for exact or non-float32 dtypes.

The host codec's ``quant.encode`` and ``quant.decode`` stage clocks are the
reference's (``quant.py:116-159``), behind ``profile.enabled``.  The third
datapath is the serving KV slabs' (``otpu_coll_quant_kv_codec``,
:func:`kv_codec`): ``serving/kv_stream.py`` holds each slot as this host
codec's bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.output import register_help, show_help
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.runtime import profile, spc

#: codec names, and the accuracy band each one charges against the declared
#: budget.  bf16 rounds to 7 stored mantissa bits: per-element relative error
#: <= 2^-8.  int8's single-encode bound is half a step of the block max
#: (0.5/127), but a reduction folds one independent quantization error per
#: rank, so the ladder charges a full step (1/127).  The ladder admits a
#: codec only when the comm's declared budget covers its band.
CODECS = ("int8", "bf16")
CODEC_BANDS = {"int8": 1.0 / 127.0, "bf16": 2.0 ** -8}
#: the codec byte of btl/tcp's quant sub-header (the reference's ids)
_CODEC_IDS = {"int8": 1, "bf16": 2}
_CODEC_BY_ID = {v: k for k, v in _CODEC_IDS.items()}

#: collectives the quant tier implements (the reference's list; alltoallv's
#: quantized path is the MoE dispatch's int8 packing, which asks ``pick``
#: for "alltoallv" in ``parallel/moe.py``'s ``dispatch_tokens``)
QUANT_COLLS = ("allreduce", "allgather", "alltoallv")

DEFAULT_BLOCK = 128        # elements per scale block (= one lane row)
DEFAULT_MIN_BYTES = 64 << 10

#: the comm info key carrying the accuracy budget (max relative error the
#: application accepts).  Mutable through the budget_key var; this module
#: global IS the current name (one dict probe on the device fast path).
BUDGET_KEY = "otpu_quant_budget"


#: THE wire-stage guard: the pml and btl hot paths read this bool and
#: branch; nothing else happens while quantize-on-pack is disabled
wire_enabled = False


def _set_wire(value) -> None:
    global wire_enabled
    wire_enabled = bool(value)


def _set_budget_key(value) -> None:
    global BUDGET_KEY
    BUDGET_KEY = str(value or "otpu_quant_budget")


# -- the shared block-scale codec (numpy) --------------------------------

def nblocks(nelems: int, block: int) -> int:
    return -(-int(nelems) // int(block))


def encoded_nbytes(nelems: int, codec: str, block: int = None) -> int:
    """Encoded size in bytes of ``nelems`` f32 elements."""
    n = int(nelems)
    if codec == "bf16":
        return 2 * n
    if codec == "int8":
        return n + 4 * nblocks(n, block or block_elems())
    raise KeyError(f"unknown quant codec {codec!r}")


def encode_f32(x, codec: str, block: int = None) -> np.ndarray:
    """Encode an f32 array into the codec's byte layout (owned uint8).

    Deterministic (round-half-even, pure numpy): every process encodes
    identical bytes for identical input."""
    _pt = profile.now() if profile.enabled else 0
    try:
        x = np.ascontiguousarray(x, np.float32).reshape(-1)
        n = x.size
        if codec == "bf16":
            u = x.view(np.uint32)
            # round-to-nearest-even on the dropped 16 bits, in uint64 so the
            # carry can never wrap the sign bit.  NaNs bypass the rounding add
            # (it can carry into the exponent and flush a payload NaN to
            # +/-0.0): truncate them and force a mantissa bit so the result
            # stays a NaN.
            rounded = (((u.astype(np.uint64) + 0x7FFF + ((u >> 16) & 1))
                        >> 16).astype(np.uint16))
            nan = ((u & 0x7F800000) == 0x7F800000) \
                & ((u & 0x007FFFFF) != 0)
            out = np.where(nan, ((u >> 16) | 0x0040).astype(np.uint16),
                           rounded).view(np.uint8).copy()
        elif codec == "int8":
            b = int(block or block_elems())
            nb = nblocks(n, b)
            pad = nb * b - n
            xp = (np.pad(x, (0, pad)) if pad else x).reshape(nb, b)
            amax = np.abs(xp).max(axis=1)
            scale = (amax * (1.0 / 127.0)).astype(np.float32)
            inv = np.zeros_like(amax)
            np.divide(127.0, amax, out=inv, where=amax > 0.0)
            q = np.rint(xp * inv[:, None]).astype(np.int8)
            out = np.empty(4 * nb + n, np.uint8)
            out[:4 * nb] = scale.view(np.uint8)
            out[4 * nb:] = q.reshape(-1)[:n].view(np.uint8)
        else:
            raise KeyError(f"unknown quant codec {codec!r}")
        spc.record("quant_encodes")
        return out
    finally:
        if profile.enabled:
            profile.stage_span("quant.encode", _pt)


def decode_f32(buf, codec: str, nelems: int,
               block: int = None) -> np.ndarray:
    """Decode a codec byte layout back to ``nelems`` f32 elements."""
    _pt = profile.now() if profile.enabled else 0
    try:
        n = int(nelems)
        b8 = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
            else buf.reshape(-1).view(np.uint8)
        want = encoded_nbytes(n, codec, block)
        if b8.size != want:
            raise ValueError(
                f"quant {codec} payload of {b8.size} bytes does not "
                f"match {n} elements (expected {want})")
        if codec == "bf16":
            u16 = np.ascontiguousarray(b8).view(np.uint16)
            out = (u16.astype(np.uint32) << 16).view(np.float32).copy()
        else:
            b = int(block or block_elems())
            nb = nblocks(n, b)
            scale = np.ascontiguousarray(b8[:4 * nb]).view(np.float32)
            q = b8[4 * nb:].view(np.int8)
            pad = nb * b - n
            qp = (np.pad(q, (0, pad)) if pad else q).reshape(nb, b)
            out = (qp.astype(np.float32)
                   * scale[:, None]).reshape(-1)[:n].copy()
        spc.record("quant_decodes")
        return out
    finally:
        if profile.enabled:
            profile.stage_span("quant.decode", _pt)


# -- the (dtype, size, accuracy_budget) decision ladder ------------------

def _is_float32(dtype) -> bool:
    """True for torch.float32 and numpy float32 (the reference's
    ``np.dtype(dtype) == np.float32``, which raises TypeError on a torch
    dtype and so would never quantize a tensor)."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


def decide(coll: str, dtype, nbytes: int, budget: Optional[float],
           commute: bool = True, min_bytes: int = None) -> Optional[str]:
    """The quant rule key as a pure function: codec name, or None.

    A cell quantizes only when EVERY gate passes: an explicit positive
    budget, a supported collective, a commutative reduction, a float32
    payload, and a message big enough to earn the encode."""
    if not budget or budget <= 0.0:
        return None
    if coll not in QUANT_COLLS or not commute:
        return None
    if dtype is None or not _is_float32(dtype):
        return None
    if nbytes < (DEFAULT_MIN_BYTES if min_bytes is None else min_bytes):
        return None
    for codec in ("int8", "bf16"):   # deepest compression first
        if budget >= CODEC_BANDS[codec]:
            return codec
    return None


def budget_of(comm) -> Optional[float]:
    """The comm's declared accuracy budget (info key), or None."""
    raw = comm.info.get(BUDGET_KEY)
    if raw is None:
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        show_help("help-coll-quant", "bad-budget",
                  info_key=BUDGET_KEY, value=raw)
        return None
    return value if value > 0.0 else None


def pick(comm, coll: str, dtype, nbytes: int, op=None) -> Optional[str]:
    """Ladder entry for the dispatch sites (coll/builtin): the comm's
    budget and the min_bytes var through :func:`decide`."""
    budget = budget_of(comm)
    if budget is None:
        return None
    commute = bool(getattr(op, "commute", True)) if op is not None else True
    return decide(coll, dtype, int(nbytes), budget, commute, min_bytes())


# -- host collective variants (the tuned ladder's quant arm) -------------

def allreduce_blockq(comm, sendbuf, op, codec: str):
    """Block-quantized host allreduce: encode once, allgather the encoded
    payloads, dequant-accumulate locally.

    Every rank folds the decoded contributions in RANK ORDER, so all ranks
    compute bit-identical results; wire traffic is (n-1) ENCODED payloads
    per rank instead of ~2x the raw buffer."""
    from ompi_tpu_torch.mca.coll import algorithms as algs
    from ompi_tpu_torch.mca.coll.basic import staged

    arr = np.ascontiguousarray(staged(sendbuf), np.float32)
    b = block_elems()
    enc = encode_f32(arr.reshape(-1), codec, b)
    gathered = algs.allgather_recursive_doubling(comm, enc)
    acc = decode_f32(gathered[0], codec, arr.size, b)
    for r in range(1, comm.size):
        part = decode_f32(gathered[r], codec, arr.size, b)
        acc = op.reduce_arrays(part, acc)
    return acc.reshape(arr.shape)


def allgather_blockq(comm, sendbuf, codec: str):
    """Block-quantized host allgather: each rank's block travels encoded
    and is decoded at every receiver (within the codec band)."""
    from ompi_tpu_torch.mca.coll import algorithms as algs
    from ompi_tpu_torch.mca.coll.basic import staged

    arr = np.ascontiguousarray(staged(sendbuf), np.float32)
    b = block_elems()
    enc = encode_f32(arr.reshape(-1), codec, b)
    gathered = algs.allgather_recursive_doubling(comm, enc)
    return np.stack([decode_f32(gathered[r], codec, arr.size,
                                b).reshape(arr.shape)
                     for r in range(comm.size)])


# -- wire codec stage (btl/tcp quantize-on-pack) -------------------------

#: wire volume (module ints): original vs encoded bytes of every quantized
#: frame this process sent
_wire_orig = 0
_wire_enc = 0


def wire_stats() -> dict:
    return {"orig": _wire_orig, "enc": _wire_enc}


def codec_id(codec: str) -> int:
    return _CODEC_IDS[codec]


def wire_codec_for(convertor, nbytes: int) -> Optional[str]:
    """pml-side eligibility: the codec for this message's fragments, or
    None.  Only contiguous float32 streams qualify: the btl sees opaque
    packed bytes, so the layer that still knows the dtype stamps the
    fragment."""
    if nbytes < min_bytes():
        return None
    if not getattr(convertor, "_contig", False):
        return None
    try:
        seg_dtype = convertor.datatype.segments[0].dtype
    except (AttributeError, IndexError):
        return None
    if seg_dtype != np.float32:
        return None
    codec = wire_codec_name()
    return codec if codec in CODECS else None


def encode_wire(payload, codec: str) -> Optional[np.ndarray]:
    """The codec stage between the pack and the tcp out-queue: an owned
    encoded payload, or None when this fragment cannot carry the codec
    (element-misaligned split, too small to earn the scales)."""
    global _wire_orig, _wire_enc
    nbytes = len(payload)
    if nbytes % 4 or nbytes < 1024:
        return None
    enc = encode_f32(np.frombuffer(payload, np.float32), codec,
                     block_elems())
    _wire_orig += nbytes
    _wire_enc += enc.nbytes
    spc.record("quant_wire_bytes_saved", nbytes - enc.nbytes)
    return enc


def decode_wire(payload, codec_byte: int, raw_len: int,
                block: int) -> np.ndarray:
    """Receive-parse decode back to the original float32 byte stream.

    Loud on any inconsistency: a quant frame that does not decode exactly
    is wire corruption and must fail like a crc32 mismatch, never deliver
    garbage bytes."""
    codec = _CODEC_BY_ID.get(int(codec_byte))
    if codec is None:
        raise ValueError(f"unknown quant codec id {codec_byte} on the wire")
    if raw_len % 4:
        raise ValueError(f"quant frame raw length {raw_len} is not "
                         "f32-aligned")
    out = decode_f32(np.frombuffer(payload, np.uint8) if not
                     isinstance(payload, np.ndarray) else payload,
                     codec, raw_len // 4, int(block))
    return out.view(np.uint8)


class QuantCollComponent(Component):
    """Codec and config home.  comm_query answers None: quant is not a
    per-comm module — coll/builtin, the tuned ladder and btl/tcp's wire
    stage consume its codec and ladder directly."""

    name = "quant"
    priority = 0

    def register_vars(self, fw) -> None:
        self._block = self.register_var(
            "block", vtype=VarType.INT, default=DEFAULT_BLOCK,
            help="Elements per block scale in the int8 codec (128 = one "
                 "lane row; smaller tracks outliers closer at more scale "
                 "overhead)")
        self._min = self.register_var(
            "min_bytes", vtype=VarType.SIZE, default="64k",
            help="Smallest payload (the whole (n, ...) world tensor) the "
                 "quant ladder and the wire codec stage consider — below "
                 "this the encode costs more than the bytes it saves")
        self._wire = self.register_var(
            "wire", vtype=VarType.BOOL, default=False,
            on_set=_set_wire,
            help="Arm quantize-on-pack for contiguous f32 streams on the "
                 "btl/tcp fastpath (LOSSY within the codec band; "
                 "dequantized on the receive parse).  Disabled cost is one "
                 "module-bool check per send")
        self._wire_codec = self.register_var(
            "wire_codec", vtype=VarType.STRING, default="int8",
            help=f"Wire-stage codec: one of {', '.join(CODECS)}")
        self._kv_codec = self.register_var(
            "kv_codec", vtype=VarType.STRING, default="",
            help="Serving KV-slab codec (empty = raw f32 slabs): int8 holds "
                 "~3.9x more sequences per slab, bf16 2x, within the codec "
                 "band")
        self._budget_key = self.register_var(
            "budget_key", vtype=VarType.STRING,
            default="otpu_quant_budget", on_set=_set_budget_key,
            help="Comm info key read for the per-communicator accuracy "
                 "budget (max relative error) that arms the quant decision "
                 "ladder")

    def comm_query(self, comm):
        return None


COMPONENT = QuantCollComponent()


def block_elems() -> int:
    v = getattr(COMPONENT, "_block", None)
    value = int(v.value) if v is not None and v.value else DEFAULT_BLOCK
    return max(1, value)


def min_bytes() -> int:
    v = getattr(COMPONENT, "_min", None)
    return int(v.value) if v is not None and v.value is not None \
        else DEFAULT_MIN_BYTES


def wire_codec_name() -> str:
    v = getattr(COMPONENT, "_wire_codec", None)
    return str(v.value or "int8") if v is not None else "int8"


def kv_codec() -> str:
    """The serving KV slabs' codec ("" = raw float32 slabs)."""
    v = getattr(COMPONENT, "_kv_codec", None)
    return str(v.value or "") if v is not None else ""


register_help(
    "help-coll-quant", "bad-budget",
    "The communicator info key {info_key!r} carries {value!r}, which does "
    "not parse as a positive float.  The accuracy budget is the max "
    "relative error the application accepts (>= 1/127 ~ 0.0079 admits "
    "the int8 block codec, >= 2^-8 ~ 0.0039 bf16); quantization stays "
    "OFF for this communicator.")
register_help(
    "help-coll-quant", "wire-frame-bad",
    "A quantized tcp frame from rank {peer} does not decode: {error}. "
    "The frame is treated as wire corruption (the crc32 discipline) and "
    "the job is being aborted — a quant frame must fail loudly, never "
    "deliver garbage bytes.")
