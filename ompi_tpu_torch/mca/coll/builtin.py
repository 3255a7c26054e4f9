"""coll/builtin — device-buffer collectives as plain torch operations over the rank axis.

Port of ``XlaCollModule`` (``ompi_tpu/mca/coll/xla.py:96-248``,
``:324-406``, ``:502-533``), the coll/xla component at priority 90.  Data
model: the world of n virtual ranks is one tensor with a leading rank axis,
``x[i]`` being rank i's buffer, on the world's device.  A replicated result
is one tensor; a rank-sharded result has a leading rank axis.

* ``allreduce_array`` — ``(n, *S)`` to ``(*S)``.  The reference lowers
  SUM/MAX/MIN to ``psum``/``pmax``/``pmin``; here they are plain torch
  reductions over the rank axis (``sum``/``amax``/``amin`` of dim 0) — the
  baseline the hand-written ring kernels are measured against.  Every
  other op gathers (free on one device) and folds the stack: one pass
  through the op framework's stack reduction (``cuda_vpu``'s
  ``reduce_stack``, kernel K1, on the card) or, when no component offers
  one, chained two-operand folds.
* ``reduce_scatter_array`` (and ``psum_scatter_array``, its SUM) —
  ``(n, n, *S)`` to ``(n, *S)``.  The reference's gather, stack reduction
  and ``dynamic_index_in_dim`` (or ``psum_scatter`` for SUM) is, on one
  device, the same reduction applied to the ``(n, n, *S)`` stack.
* ``bcast_array`` — a new ``(n, *S)`` of copies of ``x[root % n]``, and
  ``allgather_array`` — a new ``(n, *S)`` equal to ``x``: plain torch
  copies, as XLA computes them outside any Pallas kernel.  Both deliver the
  bytes they were given.  The reference's bcast has two regimes: a
  binomial tree below ``bcast_sa_min_bytes`` (256 KB per rank) and a masked
  ``psum_scatter`` plus ``all_gather`` above, where ``(-0.0) + 0.0`` turns
  root's negative zeros positive.  On one card both regimes are the same
  copy, so that var is not registered (it would select nothing), and the
  sign flip is not copied: MPI_Bcast delivers root's bytes.
* The exchange tier (``xla.py:438-451``, ``:535-573``): ``alltoall_array``
  — ``(n, n, *S)``, ``out[j, i] = x[i, j]``, a transpose copy;
  ``alltoallv_array`` — the padded exchange, returned as the reference's
  list of views ``out[i][j] = full[i, j, :counts[j][i]]``;
  ``allgatherv_array`` — ``allgather_array`` and the views ``full[i,
  :counts[i]]``; ``ppermute_array`` — ``lax.ppermute``: ``out[d] = x[s]``
  for each pair, zeros on a rank that is no destination.  A counts table of
  the wrong shape raises ``MpiError(ERR_BUFFER)`` (coll/xla raises an
  ``IndexError`` or ``TypeError`` there, or slices a larger table); a perm
  that repeats a rank raises ``ValueError``, as ``lax.ppermute`` does.

The rooted and prefix collectives (``xla.py:281-322``, ``:453-500``,
``:575-666``), plain torch over the rank axis as the reference computes
them outside any Pallas kernel, each keeping the reference's contract:

* ``reduce_array`` — ``(n, *S)`` to ``(n, *S)``: root's row holds the
  reduction, the other rows zeros.  The fold runs along the reference's
  binomial tree toward root, ``ceil(log2 n)`` rounds in which the ranks
  ``rel`` in ``[k, min(2k, n))`` (``rel`` counted from root) fold into
  ``rel - k``, as ``fold(receiver, sender)``: the same operands in the
  same order, so float SUM is bit-exact.  The fold is the op framework's
  for the tensor's dtype, one call per round over all of its pairs (K2,
  ``combine2``, on the card; the reference's ``jax_fold(op, None)`` is
  ``combine2`` on a TPU for SUM, PROD, MAX and MIN).
* ``gather_array`` — ``(n, *S)`` to ``(n, n, *S)``: root's row holds every
  rank's block, the other rows zeros.  ``scatter_array`` — ``(n, n, *S)``,
  of which only root's row is read, to ``(n, *S)``: rank i gets block i.
  Both deliver the bytes they were given.  The reference's trees paste each
  block with an add (``buf + contrib``), which turns a -0.0 into +0.0; the
  port does not copy the sign flip, as for bcast.
* ``scan_array`` and ``exscan_array`` — ``(n, *S)`` to ``(n, *S)``: row i
  folds rows 0..i (exscan: rows 0..i-1, row 0 zeros) with the op's plain
  torch fold (``fusable``: no kernel), along ``lax.associative_scan``'s
  combine tree (pairs, the recursion, then the even elements), not a
  sequential scan, so float SUM is bit-exact.
* ``barrier``/``device_barrier`` — an allreduce of ``(n, 1)`` zeros and a
  synchronize of the current stream; ``reshard`` — the ``(n, *S)`` tensor
  in row-per-rank layout (the conductor's device scatter).

The quantized branches (``xla.py:225-279``, ``:384-436``): on a comm whose
info carries the accuracy budget (``coll/quant``'s ``BUDGET_KEY``, probed
first, before the cached fast path), a float32 ``allreduce_array`` SUM and
an ``allgather_array`` of at least ``otpu_coll_quant_min_bytes`` — the
bytes of the whole ``(n, *S)`` tensor, as ``xla.py:233`` and ``:391``
count them — go through the codec ``quant.pick`` chooses (commutative ops
only; MAX, MIN, PROD and the bitwise ops stay exact).  int8: every rank's
row is block-encoded (K17) and the n encoded rows, which on one card are
the gathered payloads themselves, are folded by K18 (allreduce) or decoded
by K19 (allgather).  bf16: a cast to bfloat16 and back, then for the
allreduce a float32 ``sum`` over the ranks — plain torch, as XLA computes
that codec outside any Pallas kernel.

Reductions and the rooted and prefix collectives are cached under the
reference's program-cache keys (``_keyfor``, ``xla.py:694-715``) with the
device added, so a cache hit is one dict probe and the call; the quantized
programs per ``("allreduce_quant", codec, op, shape, dtype, device)`` and
``("allgather_quant", codec, shape, dtype, device)``.

``persistent_coll`` (``xla.py:669-683``) runs the collective once on the
template and returns a ``PersistentColl`` (``xla.py:60-93``) bound to the
cached callable, as the reference binds its cached program; a collective
with no cached callable (the copies, and an allreduce on a comm with a
budget, whose codec is picked per call) is bound to its slot.
``partitioned_coll`` (``xla.py:685-692``) binds one such handle a bucket
for ``Comm.pallreduce_init``; only this module has the slot, as only
coll/xla has it in the reference, so a raised coll/ring leaves it here.

Every slot call records one device collective and its input's bytes in the
SPC counters (``spc.bump_device``, ``xla.py:150-185``), as do the binding
and every call or start of a persistent handle (``xla.py:60-93``).  While
tracing is on, each of those launches is an ``xla_<coll>`` span of category
``device`` named by its cache key's collective (``xla.py:45-57``): it times
the launch of the torch program, never the card's work (no synchronize, no
host read inside it).  With tracing off the slots run as before.

In the multi-process device world (``tpurun --device-world``: the rte's
``device_world_booted``) ``comm_query`` answers with ``MpCollModule``, the
twin of ``XlaMpCollModule`` (``xla.py:732-906``, ``:933-947``), whose
slots cross the processes through the job's ``torch.distributed`` group.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.coll import quant as quant_mod
from ompi_tpu_torch.runtime import spc, trace


def counts_table(counts, shape: tuple, what: str) -> np.ndarray:
    """A ragged collective's counts as a host array of ``shape`` (one copy
    back from the card if they lie there: the views need host ints); any
    other shape raises ``MpiError(ERR_BUFFER)``."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    table = np.asarray(counts)
    if table.shape != shape:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       f"{what} needs counts of shape {shape}, got "
                       f"{table.shape}")
    return table


def ragged_views(full, counts: np.ndarray) -> list:
    """The ragged collectives' return contract (``xla.py:451``, ``:560``):
    views of ``full`` sliced to the counts -- ``full[i, j, :counts[j, i]]``,
    what rank i received from rank j, for an (n, n) table, and ``full[i,
    :counts[i]]`` for an (n,) one."""
    n = len(counts)
    if counts.ndim == 2:
        return [[full[i, j, :int(counts[j, i])] for j in range(n)]
                for i in range(n)]
    return [full[i, :int(counts[i])] for i in range(n)]


def _key(coll, x, op):
    """Reduction cache key; the shape in it stands for the checks passed."""
    return (coll, op.name, x.shape, x.dtype, x.device)


#: collectives whose callable is cached under ``_keyfor`` (and so bound by
#: ``persistent_coll``)
_KEYED = ("allreduce", "reduce_scatter", "reduce", "gather", "scatter",
          "scan", "exscan")


def _keyfor(coll: str, x, *args):
    """The cache key of ``coll`` on ``x`` (``xla.py:694-715``, the device
    added): the one source of keys for the slots and ``persistent_coll``."""
    if coll in ("allreduce", "reduce_scatter", "scan", "exscan"):
        return _key(coll, x, args[0] if args else op_mod.SUM)
    if coll == "reduce":
        op = args[0] if args else op_mod.SUM
        root = args[1] if len(args) > 1 else 0
        return (coll, op.name, int(root), x.shape, x.dtype, x.device)
    return (coll, int(args[0]) if args else 0, x.shape, x.dtype, x.device)


def tree_rounds(n: int) -> list:
    """The strides of ``reduce_array``'s rounds: the largest power of two
    below n, halving down to 1 (none for n == 1)."""
    k = 1
    while k < n:
        k *= 2
    rounds = []
    k //= 2
    while k >= 1:
        rounds.append(k)
        k //= 2
    return rounds


def associative_scan(fold, t: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the rows of ``t`` with ``fold(earlier, later)``
    along ``jax.lax.associative_scan``'s combine tree (jax 0.9,
    ``lax/control_flow/loops.py``): fold adjacent pairs and scan the
    result, which gives the odd rows; each even row from 2 on is the odd
    row before it folded with its own; row 0 is itself.  The same operands
    meet in the same order as there."""
    m = t.shape[0]
    if m < 2:
        return t
    odd = associative_scan(fold, fold(t[0:m - 1:2], t[1::2]))
    out = torch.empty_like(t)
    out[0] = t[0]
    out[1::2] = odd
    if m > 2:
        out[2::2] = fold(odd if m % 2 else odd[:-1], t[2::2])
    return out


def _bf16_wire(t: torch.Tensor) -> torch.Tensor:
    """The bf16 codec: each element cast to bfloat16 and back."""
    return t.to(torch.bfloat16).to(torch.float32)


def _quant_allreduce_fn(codec: str):
    """``(n, *S)`` -> ``(*S)``, the reduction through ``codec``."""
    from ompi_tpu_torch.ops import quant as q_ops

    if codec == "bf16":
        return lambda t: _bf16_wire(t).sum(0, dtype=torch.float32)

    def int8(t):
        q, s = q_ops.encode_int8(t.contiguous())          # K17
        size = t[0].numel()
        out = q_ops.dequant_accumulate(q, s)               # K18
        return out.reshape(-1)[:size].reshape(t.shape[1:])

    return int8


def _quant_allgather_fn(codec: str):
    """``(n, *S)`` -> ``(n, *S)``, every row through ``codec``."""
    from ompi_tpu_torch.ops import quant as q_ops

    if codec == "bf16":
        return _bf16_wire

    def int8(t):
        q, s = q_ops.encode_int8(t.contiguous())          # K17
        dec = q_ops.decode_int8(q, s)                      # K19
        return dec.reshape(t.shape[0], -1)[:, :t[0].numel()].reshape(t.shape)

    return int8


def _traced_dispatch(fn, coll: str, nbytes: int):
    """``fn`` under an ``xla_<coll>`` device span (``xla.py:45-57``): the
    span times the launch, not the card.  Installed only while tracing is
    on."""
    def dispatch(*a):
        t0 = trace.now()
        try:
            return fn(*a)
        finally:
            trace.span(f"xla_{coll}", "device", t0,
                       args={"nbytes": int(nbytes)})
    return dispatch


def _device_span(coll: str, t0: int, nbytes: int) -> None:
    """Close an inline slot's ``xla_<coll>`` launch span begun at ``t0``."""
    trace.span(f"xla_{coll}", "device", t0, args={"nbytes": int(nbytes)})


class PersistentColl:
    """A bound device collective (``MPI_*_init`` analog): ``h(x)`` runs it,
    ``h.start(x)`` returns a request born complete with the result (the
    stream is the progress engine).  ``place`` puts a host stack on the
    device, as the reference's jitted program does implicitly.  Each call
    bumps the SPC device counters by ``nbytes``, the template's bytes (pre-
    bound, as the reference's); a handle bound to its slot (``nbytes`` None)
    leaves the bump to the slot."""

    __slots__ = ("fn", "coll", "_place", "_nbytes", "_bump")

    def __init__(self, fn, coll: str, place, nbytes=None) -> None:
        self.fn = fn
        self.coll = coll
        self._place = place
        self._nbytes = nbytes
        self._bump = spc.bump_device if nbytes is not None \
            else (lambda _n: None)

    def __call__(self, x):
        self._bump(self._nbytes)
        if trace.enabled and self._nbytes is not None:
            return _traced_dispatch(self.fn, self.coll,
                                    self._nbytes)(self._place(x))
        return self.fn(self._place(x))

    def start(self, x):
        from ompi_tpu_torch.api.request import CompletedRequest

        r = CompletedRequest()
        r.result = self(x)
        return r

    def free(self) -> None:
        self.fn = None


class BuiltinCollModule:
    def __init__(self, comm, device: torch.device, n: int) -> None:
        self.device = device
        self.n = n
        self._cache: dict = {}
        self._lock = threading.Lock()

    # -- helpers ---------------------------------------------------------
    def _check(self, comm, x, inner_n: bool = False) -> torch.Tensor:
        """Validate and place a buffer (slow path, memoized by cache key);
        ``inner_n`` also requires the ``(n, n, ...)`` layout."""
        if not isinstance(x, torch.Tensor):
            x = self.make_world_array(x)
        elif x.device != self.device:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"device collective on {self.device} got a tensor on "
                f"{x.device}")
        elif x.dim() == 0 or x.shape[0] != self.n:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"device collective needs leading rank axis {self.n}, "
                f"got shape {tuple(x.shape)}")
        if inner_n and (x.dim() < 2 or x.shape[1] != self.n):
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"this collective needs shape (n, n, ...), got "
                f"{tuple(x.shape)}")
        return x

    def make_world_array(self, host_stack) -> torch.Tensor:
        """Place a (size, ...) host stack so row i is rank i's buffer."""
        arr = np.asarray(host_stack)
        if arr.ndim == 0 or arr.shape[0] != self.n:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"world array needs leading rank axis {self.n}, got shape "
                f"{arr.shape}")
        return cudaenv.make_world_array(arr, self.device)

    def _reduce_fn(self, op: op_mod.Op, dtype):
        """The rank-axis reduction for op: native reduction or stack fold."""
        if op.torch_reduce == "sum":
            return lambda t: t.sum(0, dtype=t.dtype)
        if op.torch_reduce == "amax":
            return lambda t: t.amax(0)
        if op.torch_reduce == "amin":
            return lambda t: t.amin(0)
        # fused one-pass stack reduction (K1 on the card) when a component
        # provides one; else chained folds
        stack = op_mod.torch_stack_reduce(op, dtype)
        if stack is not None:
            return lambda t: stack(t.contiguous())
        fold = op_mod.torch_fold(op, dtype)
        n = self.n

        def chained(t):
            acc = t[0]
            for i in range(1, n):
                acc = fold(t[i].contiguous(), acc.contiguous())
            return acc

        return chained

    def _reduce_tree_fn(self, op: op_mod.Op, root: int, dtype):
        """``reduce_array``'s callable: the binomial tree toward root on the
        rows taken in ``rel`` order, one fold a round over its pairs."""
        fold = op_mod.torch_fold(op, dtype)
        n, rounds = self.n, tree_rounds(self.n)
        first = root % n

        def tree(t):
            t = t.contiguous()

            def rel_rows(lo: int, count: int):
                # rows rel lo.. of t: a view, or a copy where they wrap
                start = (first + lo) % n
                if start + count <= n:
                    return t[start:start + count]
                return torch.cat([t[start:], t[:start + count - n]])

            rows, live = rel_rows, n
            for k in rounds:
                # senders rel [k, live) fold into rel [0, live - k); the
                # first round reads its rows from t itself
                m = live - k
                head = fold(rows(0, m), rows(k, m))
                buf = head if m == k else torch.cat([head, rows(m, k - m)])
                rows, live = (lambda lo, count, b=buf: b[lo:lo + count]), k
            out = torch.zeros_like(t)
            if 0 <= root < n:
                out[root] = rows(0, 1)[0]
            return out

        return tree

    def _scan_fn(self, op: op_mod.Op, dtype, exclusive: bool):
        fold = op_mod.torch_fold(op, dtype, fusable=True)

        def scan(t):
            s = associative_scan(fold, t)
            if not exclusive:
                return s.clone() if s is t else s
            out = torch.zeros_like(t)
            out[1:] = s[:-1]
            return out

        return scan

    def _program(self, comm, coll: str, x, args: tuple, make,
                 inner_n: bool = False):
        """Run ``coll``'s callable on ``x``: one cache probe under
        ``_keyfor``, else check and place ``x`` and make it with
        ``make(x)``."""
        if isinstance(x, torch.Tensor):
            fn = self._cache.get(_keyfor(coll, x, *args))
            if fn is not None:
                spc.bump_device(x.nbytes)
                if trace.enabled:
                    return _traced_dispatch(fn, coll, x.nbytes)(x)
                return fn(x)
        x = self._check(comm, x, inner_n)
        spc.bump_device(x.nbytes)
        fn = self._cached(_keyfor(coll, x, *args), lambda: make(x))
        if trace.enabled:
            return _traced_dispatch(fn, coll, x.nbytes)(x)
        return fn(x)

    def _cached(self, key, make):
        fn = self._cache.get(key)
        if fn is None:
            with self._lock:
                fn = self._cache.setdefault(key, make())
        return fn

    def _reduction(self, coll: str, comm, x, op: op_mod.Op,
                   inner_n: bool = False):
        """The rank-axis reduction of ``x`` under op, cached per key."""
        # steady-state fast path: one dict probe, then the reduction
        if isinstance(x, torch.Tensor):
            fn = self._cache.get(_key(coll, x, op))
            if fn is not None:
                spc.bump_device(x.nbytes)
                if trace.enabled:
                    return _traced_dispatch(fn, coll, x.nbytes)(x)
                return fn(x)
        x = self._check(comm, x, inner_n)
        spc.bump_device(x.nbytes)
        fn = self._cached(_key(coll, x, op),
                          lambda: self._reduce_fn(op, x.dtype))
        if trace.enabled:
            return _traced_dispatch(fn, coll, x.nbytes)(x)
        return fn(x)

    # -- collective slots ------------------------------------------------
    def allreduce_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        # coll/quant tier: an EXPLICIT per-comm accuracy budget (the info
        # key) routes eligible (dtype, size) cells onto the codec; comms
        # that never declared a budget pay one dict probe
        if quant_mod.BUDGET_KEY in comm.info and op.torch_reduce == "sum":
            codec = quant_mod.pick(comm, "allreduce",
                                   getattr(x, "dtype", None),
                                   int(getattr(x, "nbytes", 0)), op)
            if codec is not None:
                x = self._check(comm, x)
                spc.bump_device(x.nbytes)
                fn = self._cached(
                    ("allreduce_quant", codec, op.name, x.shape, x.dtype,
                     x.device),
                    lambda: _quant_allreduce_fn(codec))
                if trace.enabled:
                    return _traced_dispatch(fn, "allreduce_quant",
                                            x.nbytes)(x)
                return fn(x)
        return self._reduction("allreduce", comm, x, op)

    def reduce_scatter_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        return self._reduction("reduce_scatter", comm, x, op, inner_n=True)

    def psum_scatter_array(self, comm, x):
        return self.reduce_scatter_array(comm, x, op_mod.SUM)

    def bcast_array(self, comm, x, root: int = 0):
        x = self._check(comm, x)
        spc.bump_device(x.nbytes)
        t0 = trace.now() if trace.enabled else 0
        out = x[int(root) % self.n].expand(x.shape).clone()
        if t0:
            _device_span("bcast", t0, x.nbytes)
        return out

    def allgather_array(self, comm, x):
        # coll/quant tier: the same explicit-budget gate as allreduce
        if quant_mod.BUDGET_KEY in comm.info:
            codec = quant_mod.pick(comm, "allgather",
                                   getattr(x, "dtype", None),
                                   int(getattr(x, "nbytes", 0)))
            if codec is not None:
                x = self._check(comm, x)
                spc.bump_device(x.nbytes)
                fn = self._cached(
                    ("allgather_quant", codec, x.shape, x.dtype, x.device),
                    lambda: _quant_allgather_fn(codec))
                if trace.enabled:
                    return _traced_dispatch(fn, "allgather_quant",
                                            x.nbytes)(x)
                return fn(x)
        x = self._check(comm, x)
        spc.bump_device(x.nbytes)
        t0 = trace.now() if trace.enabled else 0
        out = x.clone()
        if t0:
            _device_span("allgather", t0, x.nbytes)
        return out

    def allgatherv_array(self, comm, x, counts):
        counts = counts_table(counts, (self.n,), "allgatherv")
        return ragged_views(self.allgather_array(comm, x), counts)

    def alltoall_array(self, comm, x):
        x = self._check(comm, x, inner_n=True)
        spc.bump_device(x.nbytes)
        t0 = trace.now() if trace.enabled else 0
        out = x.transpose(0, 1).contiguous()
        if t0:
            _device_span("alltoall", t0, x.nbytes)
        return out

    def alltoallv_array(self, comm, x, counts):
        counts = counts_table(counts, (self.n, self.n), "alltoallv")
        return ragged_views(self.alltoall_array(comm, x), counts)

    def reduce_array(self, comm, x, op: op_mod.Op = op_mod.SUM,
                     root: int = 0):
        root = int(root)
        return self._program(comm, "reduce", x, (op, root),
                             lambda t: self._reduce_tree_fn(op, root, t.dtype))

    def gather_array(self, comm, x, root: int = 0):
        root, n = int(root), self.n

        def make(_):
            def gather(t):
                out = t.new_zeros((n,) + tuple(t.shape))
                if 0 <= root < n:
                    out[root] = t
                return out
            return gather

        return self._program(comm, "gather", x, (root,), make)

    def scatter_array(self, comm, x, root: int = 0):
        root = int(root)
        return self._program(comm, "scatter", x, (root,),
                             lambda _: lambda t: t[root % self.n].clone(),
                             inner_n=True)

    def scan_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        return self._program(comm, "scan", x, (op,),
                             lambda t: self._scan_fn(op, t.dtype, False))

    def exscan_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        return self._program(comm, "exscan", x, (op,),
                             lambda t: self._scan_fn(op, t.dtype, True))

    def device_barrier(self, comm) -> None:
        tok = self._cache.get("barrier_token")
        if tok is None:
            tok = self._cache.setdefault("barrier_token", torch.zeros(
                (self.n, 1), dtype=torch.float32, device=self.device))
        # the reference's barrier program is its own cache entry
        # (("barrier",), xla.py:722), so its span is xla_barrier
        fn = self._cached(_key("allreduce", tok, op_mod.SUM),
                          lambda: self._reduce_fn(op_mod.SUM, tok.dtype))
        spc.bump_device(tok.nbytes)
        if trace.enabled:
            _traced_dispatch(fn, "barrier", tok.nbytes)(tok)
        else:
            fn(tok)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def barrier(self, comm) -> None:
        self.device_barrier(comm)

    def reshard(self, x) -> torch.Tensor:
        """The ``(n, *S)`` buffer in row-per-rank layout: on one device, the
        placed, contiguous tensor."""
        return self._check(None, x).contiguous()

    def _perm_index(self, perm: tuple, device):
        """(sources, destinations) of ``perm`` as index tensors on
        ``device``, ordered by destination; cached per perm."""
        key = ("ppermute", perm, device)
        idx = self._cache.get(key)
        if idx is None:
            srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
            if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts):
                raise ValueError("ppermute sources and destinations must be "
                                 f"unique, got {perm}")
            if not all(0 <= r < self.n for r in srcs + dsts):
                raise ValueError(f"ppermute ranks must lie in [0, {self.n}), "
                                 f"got {perm}")
            order = sorted(perm, key=lambda pair: pair[1])
            idx = tuple(torch.tensor([pair[k] for pair in order],
                                     dtype=torch.int64, device=device)
                        for k in (0, 1))
            with self._lock:
                idx = self._cache.setdefault(key, idx)
        return idx

    def ppermute_array(self, comm, x, perm):
        x = self._check(comm, x)
        spc.bump_device(x.nbytes)
        t0 = trace.now() if trace.enabled else 0
        perm = tuple((int(s), int(d)) for s, d in perm)
        src, dst = self._perm_index(perm, x.device)
        if len(perm) == self.n:             # every rank receives
            out = x.index_select(0, src)
        else:
            out = torch.zeros_like(x).index_copy_(0, dst,
                                                  x.index_select(0, src))
        if t0:
            _device_span("ppermute", t0, x.nbytes)
        return out

    def persistent_coll(self, comm, coll: str, template, *args):
        """Bind ``coll`` for ``template``'s shape: run it once (checks the
        buffer and caches the reduction), then hand back the cached
        reduction, or the slot where nothing is cached for it."""
        method = getattr(self, coll + "_array", None)
        if method is None:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           f"no device collective '{coll}'")
        template = self._check(comm, template)
        method(comm, template, *args)
        fn = None
        if coll in _KEYED and not (
                coll == "allreduce" and quant_mod.BUDGET_KEY in comm.info):
            fn = self._cache.get(_keyfor(coll, template, *args))
        if fn is None:
            def fn(x):
                return method(comm, x, *args)
            return PersistentColl(fn, coll, lambda x: self._check(comm, x))
        return PersistentColl(fn, coll, lambda x: self._check(comm, x),
                              template.nbytes)

    def partitioned_coll(self, comm, coll: str, buckets, *args):
        """Device side of the partitioned persistent collective
        (``Comm.pallreduce_init``, ``xla.py:685-692``): one bound handle a
        bucket, so each ``Pready`` costs one SPC bump and one launch that
        does not wait for the card."""
        return [self.persistent_coll(comm, coll, b, *args)
                for b in buckets]


#: the process groups of the multi-process device world's communicators,
#: by the comm's process ranks (made once a process: a second
#: ``new_group`` over the same ranks would name another group)
_mp_groups: dict = {}
_mp_groups_lock = threading.Lock()

#: the ops the process group reduces itself; every other op is gathered
#: and folded in rank order
_DIST_OPS = {"sum": "SUM", "amax": "MAX", "amin": "MIN"}


def _mp_group(procs: tuple):
    """The process group over the processes ``procs`` (ranks of the job's
    group): the job's own group when they are all of it, else one made
    with ``use_local_synchronization=True``, so that only the members take
    part (``create_from_group`` is called by members alone; a group made
    over the default group would wait for the others)."""
    import torch.distributed as dist

    if len(procs) == dist.get_world_size():
        return dist.group.WORLD
    with _mp_groups_lock:
        group = _mp_groups.get(procs)
        if group is None:
            group = _mp_groups[procs] = dist.new_group(
                list(procs), use_local_synchronization=True)
        return group


class MpCollModule:
    """coll/builtin for the MULTI-PROCESS device world
    (``XlaMpCollModule``, ``ompi_tpu/mca/coll/xla.py:732-906``): the
    communicator's ranks are processes of a ``tpurun --device-world`` job,
    which joined one ``torch.distributed`` process group at boot, and the
    slots cross the process boundary through it.

    Data model (the reference's multi-controller one): every member calls
    the same collective with ITS OWN contribution, no leading rank axis, a
    tensor on its device (or anything ``np.asarray`` takes, placed there).
    ``allreduce_array``, ``bcast_array`` and ``allgather_array`` return a
    new tensor on that device that every member holds (the gather as
    ``(n, *S)`` in comm rank order); ``reduce_scatter_array`` takes ``(n,
    *S)`` and returns this member's reduced block as ``(1, *S)``, the
    reference's addressable shard of its rank-sharded result, and raises
    ``ERR_BUFFER`` on a wrong leading axis (``xla.py:856-861``).

    SUM, MAX and MIN go through the process group's reduce ops; every other
    op is the reference's ``_reduce_body`` fallback (``xla.py:794-811``):
    an all-gather, then the fold in rank order, ``acc = fold(g[i], acc)``,
    on the device with the op framework's fold for the dtype.  The bcast is
    the group's broadcast from root's process (root's bytes: the
    reference's masked psum turns a root's -0.0 into +0.0, which the port
    does not copy, as for the single-process bcast).  ``device_barrier`` is
    an allreduce of one float and a synchronize of the current stream.
    Host slots (``barrier`` among them) stay with the host modules, as in
    the reference.

    The backend is gloo: NCCL refuses two ranks on one card.  Gloo's
    all-reduce, broadcast and all-gather take a CUDA tensor directly (gloo
    stages it through host memory itself), and the slots use only those.

    Hot path: a cached collective is one dict probe, the relaxed
    ``spc.bump_device`` and the call, under an ``xla_<coll>`` device span
    while tracing is on."""

    def __init__(self, comm, rte) -> None:
        procs = tuple(rte.device_world_process(w)
                      for w in comm.group.world_ranks)  # ValueError: not ours
        self.n = len(procs)
        self.device = rte.device
        self._procs = procs
        # the process group orders its ranks ascending; comm rank r is
        # process procs[r], at this position of the group's gather
        order = sorted(procs)
        self._slot = [order.index(p) for p in procs]
        self.rank = comm.rank
        self.group = _mp_group(tuple(order)) if self.n > 1 else None
        self._cache: dict = {}
        self._lock = threading.Lock()

    # -- helpers ---------------------------------------------------------
    def _place(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            return cudaenv.make_world_array(np.asarray(x), self.device)
        if x.device != self.device:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"device collective on {self.device} got a tensor on "
                f"{x.device}")
        return x

    def _gather(self, t: torch.Tensor) -> list:
        """Every member's ``t``, in comm rank order."""
        import torch.distributed as dist

        t = t.contiguous()
        if self.group is None:
            return [t]
        bufs = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(bufs, t, group=self.group)
        return [bufs[i] for i in self._slot]

    def _reduce_fn(self, op: op_mod.Op, dtype):
        """The cross-process reduction for op: the group's reduce op, or
        the gather and the fold in rank order."""
        import torch.distributed as dist

        name = _DIST_OPS.get(op.torch_reduce)
        if name is not None:
            rop = getattr(dist.ReduceOp, name)

            def native(t):
                out = t.clone()
                if self.group is not None:
                    dist.all_reduce(out, op=rop, group=self.group)
                return out
            return native
        fold = op_mod.torch_fold(op, dtype)

        def gathered(t):
            g = self._gather(t)
            acc = g[0]
            for i in range(1, self.n):
                acc = fold(g[i], acc)
            return acc.clone() if acc is t else acc
        return gathered

    def _run(self, coll: str, key, x, make):
        """The collective under ``key``: one probe, the bump, the call."""
        fn = self._cache.get(key)
        if fn is None:
            with self._lock:
                fn = self._cache.setdefault(key, make())
        spc.bump_device(x.nbytes)
        if trace.enabled:
            return _traced_dispatch(fn, coll, x.nbytes)(x)
        return fn(x)

    # -- collective slots ------------------------------------------------
    def allreduce_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        x = self._place(x)
        return self._run("allreduce", ("allreduce", op.name, x.dtype), x,
                         lambda: self._reduce_fn(op, x.dtype))

    def bcast_array(self, comm, x, root: int = 0):
        import torch.distributed as dist

        x, root = self._place(x), int(root)

        def make():
            if not 0 <= root < self.n:
                # no member's axis index is root: every contribution is
                # masked out, as in the reference
                return torch.zeros_like
            if self.group is None:
                return torch.clone
            src = self._procs[root]     # broadcast names the job's rank

            def bcast(t):
                out = t.clone() if self.rank == root else torch.empty_like(t)
                dist.broadcast(out, src=src, group=self.group)
                return out
            return bcast

        return self._run("bcast", ("bcast", root), x, make)

    def allgather_array(self, comm, x):
        x = self._place(x)
        return self._run("allgather", ("allgather",), x,
                         lambda: lambda t: torch.stack(self._gather(t)))

    def reduce_scatter_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        x = self._place(x)
        if x.dim() < 1 or x.shape[0] != self.n:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"reduce_scatter needs a leading rank axis {self.n}, "
                f"got shape {tuple(x.shape)}")

        def make():
            full = self._reduce_fn(op, x.dtype)
            me = self.rank
            return lambda t: full(t)[me:me + 1]

        return self._run("reduce_scatter",
                         ("reduce_scatter", op.name, x.dtype), x, make)

    def psum_scatter_array(self, comm, x):
        return self.reduce_scatter_array(comm, x, op_mod.SUM)

    def device_barrier(self, comm) -> None:
        tok = self._cache.get("barrier_token")
        if tok is None:
            tok = self._cache.setdefault("barrier_token", torch.zeros(
                1, dtype=torch.float32, device=self.device))
        self._run("barrier", ("allreduce", "SUM", tok.dtype), tok,
                  lambda: self._reduce_fn(op_mod.SUM, tok.dtype))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


class BuiltinCollComponent(Component):
    name = "builtin"
    priority = 90

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=90,
            help="Selection priority of coll/builtin (device collectives as "
                 "plain torch operations over the rank axis)")

    def comm_query(self, comm):
        rte = comm.rte
        if rte is None:
            return None
        if not rte.is_device_world:
            # the multi-process device world (xla.py:933-947): the comm's
            # ranks are processes of a job whose process group booted; the
            # cross-process module fills the *_array slots only (the host
            # collectives keep their own modules)
            if not getattr(rte, "device_world_booted", False) \
                    or comm.is_inter:
                return None
            try:
                module = MpCollModule(comm, rte)
            except Exception:
                return None
            return self._prio.value, module
        return self._prio.value, BuiltinCollModule(
            comm, rte.device_of(0), comm.size)


COMPONENT = BuiltinCollComponent()
