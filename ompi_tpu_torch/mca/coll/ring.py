"""coll/ring — hand-written ring collective kernels for the device world.

Port of ``PallasCollModule`` (``ompi_tpu/mca/coll/pallas_coll.py``), the
coll/pallas component at priority 85: below coll/builtin's 90, so the torch
operations stay the default; ``--mca coll_ring_priority 95`` (or
``OTPU_MCA_coll_ring_priority=95``) makes it own the slots.  Its kernels are
those of ``ompi_tpu_torch/ops/ring_collectives.py``:

* ``allreduce_array`` and ``reduce_scatter_array`` (``psum_scatter_array``
  is its SUM): float16/32/64 SUM, MAX, MIN and PROD.  Per-rank payloads up
  to ``vmem_max_bytes`` go to the fused kernels (K3, K5), larger ones to the
  segmented kernels (K4, K6, window of ``seg_bytes``).  With
  ``bidirectional`` on (default off: it changes the ring blocks, and so the
  fold order), the allreduce takes the duplex kernels instead: K8 in the
  fused regime, K9 in the segmented one; the reduce-scatter has no duplex
  kernel and keeps K5/K6.  With ``wire16`` on (default off: it changes the
  numbers), a float32 SUM whose regime is ``fused`` takes the bf16-wire
  kernels instead (K7, K5's wire16 form): the segmented and duplex regimes
  have no wire16 kernel, as in the reference (``pallas_coll.py:123-146``).
* ``allgather_array``: float16/32/64 payloads, to K10, or K11 with
  ``bidirectional`` on.
* ``bcast_array``: any dtype (the kernel copies bytes), to K12.
* ``alltoall_array``: any dtype shaped ``(n, n, ...)``, to K14.
* ``alltoallv_array``: any dtype shaped ``(n, n, R, W)`` with ``W % 128 ==
  0``, to K15; ``allgatherv_array``: any dtype shaped ``(n, R, W)``, the
  same width rule, to K16.  Both return the reference's views sliced to the
  counts, and a counts table of the wrong shape raises
  ``MpiError(ERR_BUFFER)``.  The 128-lane width is a TPU rule the card does
  not need; it is kept so that both packages route the same calls.
* ``ppermute_array``: the exact ``+1`` rotation ``((0, 1), (1, 2), ...,
  (n-1, 0))``, pairs in that order, on a float16/32/64 payload, to K13.

Every call it does not cover (other ops, other dtypes, sizes outside
``[min_bytes, max_bytes]``, a reduce-scatter or alltoall not shaped ``(n,
n, ...)``, a ragged payload of another layout, any other perm) is delegated
to coll/builtin, the way the reference falls through to coll/xla.
``persistent_coll`` (``Comm.allreduce_array_init``, ``Comm.coll_init``)
binds allreduce and reduce_scatter through the same routing rules as the
one-shot slots, allgather likewise, and bcast with its root baked in; every
other binding goes to coll/builtin.  coll/ring never reads a comm's
accuracy budget, as coll/pallas does not: a call it serves is exact (or
wire16) on a budgeted comm too, and only the calls it delegates reach
coll/builtin's quantized branches.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.coll.builtin import counts_table, ragged_views

#: MPI op name -> ring-kernel fold name (ompi_tpu_torch/ops/ring_collectives)
_RING_OPS = {"SUM": "sum", "MAX": "max", "MIN": "min", "PROD": "prod"}

#: payload dtypes of the ring kernels: the JAX package's gate is numpy kind
#: 'f' (float16/32/64), which leaves out bfloat16 (kind 'V' under ml_dtypes)
#: although torch counts it as floating point
_RING_DTYPES = (torch.float16, torch.float32, torch.float64)

#: per-rank payload ceiling on the CPU lane, where the ring runs its plain
#: versions — the reference's interpreter cap (pallas_coll.py:43), kept so
#: routing matches it in the tests; above this, delegate regardless of
#: max_bytes
_INTERPRET_MAX_BYTES = 16 << 20


class RingCollModule:
    def __init__(self, comm, device: torch.device, n: int, axis_name: str,
                 max_bytes: int, vmem_max_bytes: int, seg_bytes: int,
                 min_bytes: int = 0, wire16: bool = False,
                 bidirectional: bool = False) -> None:
        self.device = device
        self.n = n
        self.axis = axis_name
        self.max_bytes = max_bytes
        self.min_bytes = min_bytes
        self.vmem_max_bytes = vmem_max_bytes
        self.seg_bytes = seg_bytes
        self.wire16 = wire16
        self.bidirectional = bidirectional
        self._fallback = None   # resolved at comm_enable

    def comm_enable(self, comm) -> None:
        # next-lower provider of the device-array slots (coll/builtin):
        # unsupported calls fall through to it
        from ompi_tpu_torch.mca.coll.builtin import BuiltinCollModule

        self._fallback = next(
            (m for m in comm.coll_modules if isinstance(m, BuiltinCollModule)),
            None)

    # -- helpers ---------------------------------------------------------
    def _delegate(self, name, comm, x, *args):
        if self._fallback is None:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           f"coll/ring cannot run {name} and no fallback "
                           "module is present")
        return getattr(self._fallback, name)(comm, x, *args)

    def _place(self, comm, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x
        if self._fallback is not None:
            return self._fallback._check(comm, x)
        raise MpiError(ErrorClass.ERR_BUFFER,
                       f"coll/ring needs a tensor on {self.device}")

    def _size_ok(self, x) -> bool:
        cap = self.max_bytes
        if self.device.type != "cuda":
            cap = min(cap, _INTERPRET_MAX_BYTES)
        per_rank = x.nbytes // max(1, self.n)
        return self.min_bytes <= per_rank <= cap

    def _supported(self, x) -> bool:
        return x.dtype in _RING_DTYPES and self._size_ok(x)

    def _route(self, x):
        """Pick the accumulator regime of a ring reduction from the
        per-rank payload size ``x.nbytes // n``: fused kernel up to
        ``vmem_max_bytes``, segmented (window of ``seg_bytes``) above — the
        reference's selection between its linear and segmented rings
        (``coll_base_allreduce.c:618``) — each in its duplex form under
        ``bidirectional`` (``pallas_coll.py:108-121``)."""
        per_rank = x.nbytes // max(1, self.n)
        if per_rank > self.vmem_max_bytes:
            seg_elems = max(1, self.seg_bytes // x.element_size())
            return ("seg_bidi" if self.bidirectional else "seg"), seg_elems
        if self.bidirectional:
            return "bidi", None
        return "fused", None

    def _with_wire16(self, x, ring_op: str, variant: str) -> str:
        """The opt-in bf16 wire: a float32 SUM in the fused regime."""
        if (self.wire16 and ring_op == "sum" and x.dtype == torch.float32
                and variant == "fused"):
            return "wire16"
        return variant

    def _allreduce_variant(self, x, ring_op: str):
        """ONE routing rule for the one-shot and the persistent allreduce
        (``pallas_coll.py:123-133``): a handle never diverges numerically
        from the slot it mirrors."""
        variant, seg_elems = self._route(x)
        return self._with_wire16(x, ring_op, variant), seg_elems

    def _reduce_scatter_variant(self, x, ring_op: str):
        """The same for the reduce-scatter (``pallas_coll.py:135-146``),
        which has no duplex kernel: ``bidi`` is the fused ring, ``seg_bidi``
        the segmented one."""
        variant, seg_elems = self._route(x)
        if variant == "bidi":
            variant, seg_elems = "fused", None
        elif variant == "seg_bidi":
            variant = "seg"
        return self._with_wire16(x, ring_op, variant), seg_elems

    def _allgather_variant(self) -> str:
        return "bidi" if self.bidirectional else "ring"

    # -- collective slots ------------------------------------------------
    def allreduce_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        x = self._place(comm, x)
        ring_op = _RING_OPS.get(op.name)
        if ring_op is None or not self._supported(x):
            return self._delegate("allreduce_array", comm, x, op)
        from ompi_tpu_torch.ops import ring_collectives as rc

        variant, seg_elems = self._allreduce_variant(x, ring_op)
        return rc.all_reduce(x.contiguous(), self.n, ring_op, variant=variant,
                             seg_elems=seg_elems)

    def reduce_scatter_array(self, comm, x, op: op_mod.Op = op_mod.SUM):
        x = self._place(comm, x)
        ring_op = _RING_OPS.get(op.name)
        if (ring_op is None or not self._supported(x) or x.dim() < 2
                or x.shape[1] != self.n):
            # a malformed layout surfaces as coll/builtin's MpiError
            return self._delegate("reduce_scatter_array", comm, x, op)
        from ompi_tpu_torch.ops import ring_collectives as rc

        variant, seg_elems = self._reduce_scatter_variant(x, ring_op)
        return rc.reduce_scatter(x.contiguous(), self.n, ring_op,
                                 variant=variant, seg_elems=seg_elems)

    def psum_scatter_array(self, comm, x):
        return self.reduce_scatter_array(comm, x, op_mod.SUM)

    def allgather_array(self, comm, x):
        x = self._place(comm, x)
        if not self._supported(x):
            return self._delegate("allgather_array", comm, x)
        from ompi_tpu_torch.ops import ring_collectives as rc

        return rc.all_gather(x.contiguous(), self.n,
                             variant=self._allgather_variant())

    def bcast_array(self, comm, x, root: int = 0):
        x = self._place(comm, x)
        # no arithmetic: any dtype qualifies, only the size gates
        if not self._size_ok(x):
            return self._delegate("bcast_array", comm, x, root)
        from ompi_tpu_torch.ops import ring_collectives as rc

        return rc.bcast(x.contiguous(), self.n, root)

    def _exchange_ok(self, x, ndim: int | None = None) -> bool:
        """The exchange tier's gate: the size, the leading rank axis, and
        for the ragged pair ``ndim`` dims with a width of whole 128 lanes
        (``pallas_coll.py:190-191``, ``:205-207``, ``:236-237``)."""
        if not self._size_ok(x) or x.dim() < 1 or x.shape[0] != self.n:
            return False
        return ndim is None or (x.dim() == ndim and x.shape[-1] % 128 == 0)

    def alltoall_array(self, comm, x):
        x = self._place(comm, x)
        # no arithmetic: any dtype; a malformed layout surfaces as
        # coll/builtin's MpiError
        if not self._exchange_ok(x) or x.dim() < 2 or x.shape[1] != self.n:
            return self._delegate("alltoall_array", comm, x)
        from ompi_tpu_torch.ops import ring_collectives as rc

        return rc.all_to_all(x.contiguous(), self.n)

    def alltoallv_array(self, comm, x, counts):
        x = self._place(comm, x)
        if not self._exchange_ok(x, 4) or x.shape[1] != self.n:
            return self._delegate("alltoallv_array", comm, x, counts)
        from ompi_tpu_torch.ops import ring_collectives as rc

        counts = counts_table(counts, (self.n, self.n), "alltoallv")
        return ragged_views(rc.all_to_all_v(x.contiguous(), counts, self.n),
                            counts)

    def allgatherv_array(self, comm, x, counts):
        x = self._place(comm, x)
        if not self._exchange_ok(x, 3):
            return self._delegate("allgatherv_array", comm, x, counts)
        from ompi_tpu_torch.ops import ring_collectives as rc

        counts = counts_table(counts, (self.n,), "allgatherv")
        return ragged_views(rc.all_gather_v(x.contiguous(), counts, self.n),
                            counts)

    def ppermute_array(self, comm, x, perm):
        perm = tuple((int(s), int(d)) for s, d in perm)
        rot = tuple((i, (i + 1) % self.n) for i in range(self.n))
        x = self._place(comm, x)
        if perm != rot or not self._supported(x) or x.shape[0] != self.n:
            return self._delegate("ppermute_array", comm, x, perm)
        from ompi_tpu_torch.ops import ring_collectives as rc

        return rc.right_permute(x.contiguous(), self.n)

    def persistent_coll(self, comm, coll: str, template, *args):
        """``MPI_*_init`` analog (``pallas_coll.py:253-310``): a handle bound
        to the ring kernel the one-shot slot would take for ``template``,
        through the same routing rules; what the ring does not serve binds
        through coll/builtin.  The binding runs once now, to build and check
        it, as the reference's does."""
        from ompi_tpu_torch.mca.coll.builtin import PersistentColl

        template = self._place(comm, template)
        op = args[0] if args else op_mod.SUM
        ring_op = _RING_OPS.get(getattr(op, "name", "SUM"))
        reduction = (coll in ("allreduce", "reduce_scatter")
                     and ring_op is not None and self._supported(template)
                     and (coll == "allreduce" or (template.dim() >= 2 and
                                                  template.shape[1] == self.n)))
        if not (reduction or (coll == "bcast" and self._size_ok(template))
                or (coll == "allgather" and self._supported(template))):
            return self._delegate("persistent_coll", comm, coll, template,
                                  *args)
        from ompi_tpu_torch.ops import ring_collectives as rc

        n = self.n
        if coll == "allreduce":
            variant, seg = self._allreduce_variant(template, ring_op)

            def fn(x):
                return rc.all_reduce(x.contiguous(), n, ring_op,
                                     variant=variant, seg_elems=seg)
        elif coll == "reduce_scatter":
            variant, seg = self._reduce_scatter_variant(template, ring_op)

            def fn(x):
                return rc.reduce_scatter(x.contiguous(), n, ring_op,
                                         variant=variant, seg_elems=seg)
        elif coll == "allgather":
            variant = self._allgather_variant()

            def fn(x):
                return rc.all_gather(x.contiguous(), n, variant=variant)
        else:                       # bcast: the root is part of the binding
            root = int(args[0]) % n if args else 0

            def fn(x):
                return rc.bcast(x.contiguous(), n, root)
        fn(template)
        return PersistentColl(fn, coll, lambda x: self._place(comm, x))


class RingCollComponent(Component):
    name = "ring"
    priority = 85

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=85,
            help="Selection priority of coll/ring (hand-written ring "
                 "collective kernels); raise above coll/builtin's 90 to select")
        self._min = self.register_var(
            "min_bytes", vtype=VarType.SIZE, default="0",
            help="Smallest per-rank payload routed to the ring kernels; "
                 "smaller calls fall through to coll/builtin")
        self._max = self.register_var(
            "max_bytes", vtype=VarType.SIZE, default="1g",
            help="Largest per-rank payload routed to the ring kernels; "
                 "bigger calls fall through to coll/builtin")
        self._vmem_max = self.register_var(
            "vmem_max_bytes", vtype=VarType.SIZE, default="8m",
            help="Per-rank payload crossover from the fused ring kernels "
                 "(accumulator on chip) to the segmented ones (accumulator "
                 "in device memory); the default is the TPU's measured VMEM "
                 "ceiling, kept until card numbers move it")
        self._seg = self.register_var(
            "seg_bytes", vtype=VarType.SIZE, default="512k",
            help="Window of the segmented ring kernels; it rounds the "
                 "all-reduce's ring blocks up to whole windows")
        self._bidi = self.register_var(
            "bidirectional", vtype=VarType.BOOL, default=False,
            help="Use the bidirectional (duplex) ring schedules: the "
                 "all-reduce sends half of each ring block each way round "
                 "the ring (bidi in the fused regime, seg_bidi above "
                 "vmem_max_bytes), and the allgather ships blocks both ways "
                 "in ceil((n-1)/2) steps instead of n-1.  On one card no "
                 "link carries them: it changes the ring blocks (and so the "
                 "fold order), not the bytes moved")
        self._wire16 = self.register_var(
            "wire16", vtype=VarType.BOOL, default=False,
            help="Opt-in bf16 wire for float32 SUM allreduce and "
                 "reduce_scatter in the fused regime: float32 accumulation, "
                 "each hop's partial rounded to bf16 (the reference's "
                 "halved link bytes; on one card no link carries them).  "
                 "Changes the numbers, so never on by default")
        self._axis = self.register_var(
            "axis_name", default="mpi",
            help="Name of the rank axis (dim 0 of the world tensor), kept "
                 "for configuration parity with coll/pallas")

    def comm_query(self, comm):
        rte = comm.rte
        if rte is None or not rte.is_device_world:
            return None
        return self._prio.value, RingCollModule(
            comm, rte.device_of(0), comm.size, self._axis.value,
            int(self._max.value),
            vmem_max_bytes=int(self._vmem_max.value),
            seg_bytes=int(self._seg.value),
            min_bytes=int(self._min.value),
            wire16=bool(self._wire16.value),
            bidirectional=bool(self._bidi.value))


COMPONENT = RingCollComponent()
