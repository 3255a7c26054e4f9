"""coll/tuned — the decision layer picking algorithms from the menu.

Port of ``ompi_tpu/mca/coll/tuned.py`` (after the reference's
``ompi/mca/coll/tuned/``), both halves:

* the host ladder: *fixed rules* = hardcoded (commutativity, comm_size,
  message_size) ladders per collective (``coll_tuned_decision_fixed.c:
  55-124``, with its non-commutative exclusions ``:77-80``), *dynamic
  rules* = a runtime-loaded rule file (``coll_tuned_component.c:232-236``),
  and per-collective force vars (``otpu_coll_tuned_<coll>_algorithm``)
  overriding both; the small-message eager lane and coll/quant's arm.  A
  tensor given to a slot is staged to the host once, at the slot's entry
  (``torch_acc.to_host``), and the result is numpy, as coll/basic's is;
* the device-tier fused ladder cells: the communication-fused matmul
  programs (``ops/overlap.py``, K20) that call sites consult by name — the
  MoE expert FFN, ``parallel/moe.expert_ffn_fused`` — through
  :func:`device_cell` and ``otpu_coll_tuned_fused_cells``.  They are not
  rows of a host menu: a host algorithm takes ``(comm, buf, ...)``, a cell
  ``(a, b, n)``.

Priority 30 — above coll/libnbc (25) and coll/basic (10) so the tuned
ladders own the blocking host collectives of the multi-process world.
``comm_query`` answers None in the device world (coll/conductor and the
device components own it), on size-1 comms and on intercommunicators.

Dynamic rule file format (one rule per line, first match wins)::

    # coll  max_comm_size  max_bytes  algorithm  [segsize]
    allreduce  8  4096  recursive_doubling
    allreduce  0  0     ring            # 0 = unbounded

The ``coll.decide`` (the pick) and ``coll.alg`` (the algorithm's body,
its wire waits included) stage clocks are the reference's
(``tuned.py:219-288``), each behind ``profile.enabled``.
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.output import register_help, show_help
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.mca.coll import algorithms as algs
from ompi_tpu_torch.mca.coll import quant as quant_mod
from ompi_tpu_torch.mca.coll.basic import BasicCollModule, staged
from ompi_tpu_torch.runtime import profile, spc
from ompi_tpu_torch.runtime.hotpath import hot_path

_MENUS = {
    "allreduce": algs.ALLREDUCE,
    "bcast": algs.BCAST,
    "reduce": algs.REDUCE,
    "allgather": algs.ALLGATHER,
    "alltoall": algs.ALLTOALL,
    "barrier": algs.BARRIER,
    "reduce_scatter": algs.REDUCE_SCATTER,
    "gather": algs.GATHER,
    "scatter": algs.SCATTER,
}

#: the device-tier ladder cells (ops/overlap)
DEVICE_CELLS = ("matmul_allreduce", "matmul_reduce_scatter")


def device_cell(name: str):
    """Resolve a device-tier fused ladder cell, honoring the force-var.

    Returns the ``ops/overlap`` kernel callable, or None when the fused tier
    is disabled (``fused_cells=off``) or the var forces a DIFFERENT cell —
    the caller then takes its unfused form."""
    if name not in DEVICE_CELLS:
        raise KeyError(f"no device ladder cell {name!r} (known: "
                       f"{', '.join(DEVICE_CELLS)})")
    forced = COMPONENT.fused_cells_var()
    if forced == "off" or (forced and forced != name):
        return None
    from ompi_tpu_torch.ops import overlap

    return getattr(overlap, name)


def _nbytes(buf) -> int:
    # ndarrays answer .nbytes directly
    n = getattr(buf, "nbytes", None)
    return n if n is not None else np.asarray(buf).nbytes


def default_algorithm(coll: str, comm_size: int, nbytes: int,
                      commute: bool = True,
                      per_block: int = None) -> str:
    """The fixed decision ladder's pick for one (coll, comm_size, nbytes)
    cell — the ``decision_fixed.c`` tables as a pure function, with the
    reference's thresholds.

    ``per_block`` is the alltoall per-destination block size (derived from
    ``nbytes / comm_size`` when not supplied — the dispatch method passes
    the exact value).
    """
    if coll == "allreduce":
        if not commute:
            # ring/Rabenseifner reorder operands -> excluded (:77-80)
            return "nonoverlapping" if comm_size <= 4 \
                else "recursive_doubling"
        if nbytes <= 4096:
            return "recursive_doubling"
        if nbytes < (512 << 10):
            return "rabenseifner"
        if nbytes < (4 << 20):
            return "ring"
        return "ring_segmented"
    if coll == "bcast":
        if nbytes < 2048 or comm_size <= 4:
            return "binomial"
        return "scatter_allgather" if nbytes < (1 << 20) else "chain"
    if coll == "reduce":
        if not commute:
            # binomial reorders; pipeline and linear are rank-ordered
            return "linear" if nbytes < (64 << 10) else "pipeline"
        return "binomial" if nbytes < (64 << 10) else "pipeline"
    if coll == "allgather":
        if comm_size <= 2:
            return "linear"
        if nbytes < 1024:
            return "bruck"
        if nbytes < (512 << 10):
            return "recursive_doubling"  # falls to bruck for non-pof2
        return "neighbor"                # falls to ring for odd sizes
    if coll == "alltoall":
        if per_block is None:
            per_block = nbytes // max(1, comm_size)
        if comm_size <= 2:
            return "linear"
        return "bruck" if per_block < 256 else "pairwise"
    if coll == "barrier":
        return "recursive_doubling" \
            if not (comm_size & (comm_size - 1)) else "bruck"
    if coll == "reduce_scatter":
        if not commute:
            return "basic"           # reduce+scatter keeps rank order
        return "recursive_halving" if nbytes < (64 << 10) else "ring"
    if coll in ("gather", "scatter"):
        return "binomial" if nbytes < (64 << 10) else "linear"
    raise KeyError(f"no fixed ladder for collective {coll!r}")


def ladder_rules(coll: str, comm_size: int, cap_bytes: int,
                 commute: bool = True) -> list[tuple[int, str]]:
    """The fixed ladder as ascending ``(max_bytes, algorithm)`` rule rows
    whose first-match-wins evaluation reproduces :func:`default_algorithm`
    EXACTLY for every ``nbytes <= cap_bytes`` (sizes above the cap fall
    through the rule list back to the fixed ladder itself, which picks the
    same incumbent — so a rules file built from these rows is
    behavior-identical by construction).

    Thresholds are powers of two in total bytes (``<=`` or ``<`` style) or
    per-destination-block bytes (alltoall: pow2 times ``comm_size``), so
    probing each boundary's two sides at ``2^k`` and ``2^k * comm_size``
    finds every breakpoint."""
    probes: set = set()
    n = 1
    while n <= (1 << 40):
        probes.update((n, n + 1, n * max(1, comm_size),
                       n * max(1, comm_size) + 1))
        n <<= 1
    rows: list[tuple[int, str]] = []
    cur = default_algorithm(coll, comm_size, 0, commute)
    last_max = -1
    for probe in sorted(probes):
        if last_max >= cap_bytes:
            break
        alg = default_algorithm(coll, comm_size, probe, commute)
        if alg != cur:
            rows.append((probe - 1, cur))
            last_max = probe - 1
            cur = alg
    if last_max < cap_bytes:
        # close the table at the cap (0 = unbounded, which is exactly right
        # for a size-independent pick like barrier's)
        rows.append((int(cap_bytes), cur))
    return rows


class TunedModule:
    """Per-communicator module: ladder dispatch over the algorithm menu.

    The ladders themselves are cheap integer compares; the per-call cost a
    training loop replays is building the chosen algorithm's peer/segment
    schedule, which is memoized on ``coll/algorithms`` (``_sched_cache`` —
    SPC ``fastpath_sched_{hits,misses}``).  Force vars and a dynamic-rules
    file stay mutable at run time: every call re-reads them.
    """

    def __init__(self, component: "TunedCollComponent"):
        self._c = component
        self._basic = BasicCollModule()

    # -- decision machinery ---------------------------------------------
    def _pick(self, coll: str, comm_size: int, nbytes: int,
              default: str, commute: bool = True) -> tuple[str, int]:
        """(algorithm, rule segsize) — segsize 0 means 'use the MCA var'.
        ``nbytes`` is the TOTAL payload per rank for every collective
        (alltoall included), matching the rule file's max_bytes column.

        Dynamic rules apply to COMMUTATIVE reductions only: the rule grammar
        cannot express commutativity, and a schedule measured for
        commutative traffic would silently produce wrong answers on a
        non-commutative op — those always take the fixed ladder's
        order-safe picks.  A force var is the user's explicit override and
        still applies."""
        _pt = profile.now() if profile.enabled else 0
        try:
            forced = self._c.force_var(coll)
            if forced:
                return forced, 0
            if not commute:
                return default, 0
            for (rcoll, max_size, max_bytes, alg, seg) in self._c.rules:
                if rcoll != coll:
                    continue
                if max_size and comm_size > max_size:
                    continue
                if max_bytes and nbytes > max_bytes:
                    continue
                return alg, seg
            return default, 0
        finally:
            if profile.enabled:
                profile.stage_span("coll.decide", _pt)

    def _run(self, coll: str, alg: str, default: str, *args, **kw):
        menu = _MENUS[coll]
        fn = menu.get(alg)
        if fn is None:
            show_help("help-coll-tuned", "unknown-algorithm",
                      coll=coll, alg=alg, known=", ".join(sorted(menu)))
            # fall back to the ladder's own default: unlike an arbitrary
            # menu entry it is always safe for the op at hand
            fn = menu[default]
        _pt = profile.now() if profile.enabled else 0
        try:
            return fn(*args, **kw)
        finally:
            if profile.enabled:
                profile.stage_span("coll.alg", _pt)

    # -- fixed ladders (decision_fixed.c shape) ---------------------------
    @hot_path
    def allreduce(self, comm, sendbuf, op=op_mod.SUM):
        sendbuf = staged(sendbuf)
        nbytes = _nbytes(sendbuf)
        # SPC-counted small-message eager lane: below the threshold the
        # ladder ALWAYS lands on recursive doubling (for commutative and
        # non-commutative alike — rd keeps rank order), so skip the pick
        # machinery.  Force vars and rule files disable the lane so every
        # override still goes through the full decision path.
        if (nbytes <= self._c.eager_lane_max()
                and (op.commute or comm.size > 4)
                and not self._c.rules
                and not self._c.force_var("allreduce")):
            spc.record("fastpath_eager_lane")
            if not profile.enabled:
                return algs.allreduce_recursive_doubling(comm, sendbuf, op)
            _pt = profile.now()
            try:
                return algs.allreduce_recursive_doubling(comm, sendbuf, op)
            finally:
                profile.stage_span("coll.alg", _pt)
        # coll/quant arm of the ladder: the (dtype, size, accuracy budget)
        # rule key, armed only by an EXPLICIT per-comm budget info key and
        # never for non-commutative ops (pick re-checks) — a force var
        # stays the user's override and wins outright
        if op.commute and not self._c.force_var("allreduce"):
            qcodec = quant_mod.pick(comm, "allreduce",
                                    getattr(sendbuf, "dtype", None),
                                    nbytes, op)
            if qcodec is not None:
                _pt = profile.now() if profile.enabled else 0
                try:
                    return quant_mod.allreduce_blockq(comm, sendbuf, op,
                                                      qcodec)
                finally:
                    if profile.enabled:
                        profile.stage_span("coll.alg", _pt)
        default = default_algorithm("allreduce", comm.size, nbytes,
                                    op.commute)
        alg, seg = self._pick("allreduce", comm.size, nbytes, default,
                              commute=op.commute)
        if alg == "ring_segmented":
            return self._run(
                "allreduce", alg, default, comm, sendbuf, op,
                segsize=seg or self._c.segsize("allreduce"))
        return self._run("allreduce", alg, default, comm, sendbuf, op)

    def bcast(self, comm, buf, root=0):
        buf = staged(buf)
        nbytes = _nbytes(buf)
        default = default_algorithm("bcast", comm.size, nbytes)
        alg, seg = self._pick("bcast", comm.size, nbytes, default)
        if alg == "chain":
            return self._run("bcast", alg, default, comm, buf, root,
                             segsize=seg or self._c.segsize("bcast"))
        return self._run("bcast", alg, default, comm, buf, root)

    def reduce(self, comm, sendbuf, op=op_mod.SUM, root=0):
        sendbuf = staged(sendbuf)
        nbytes = _nbytes(sendbuf)
        default = default_algorithm("reduce", comm.size, nbytes,
                                    op.commute)
        alg, seg = self._pick("reduce", comm.size, nbytes, default,
                              commute=op.commute)
        if alg == "pipeline":
            return self._run("reduce", alg, default, comm, sendbuf, op,
                             root, segsize=seg or self._c.segsize("reduce"))
        return self._run("reduce", alg, default, comm, sendbuf, op, root)

    def allgather(self, comm, sendbuf):
        sendbuf = staged(sendbuf)
        nbytes = _nbytes(sendbuf)
        # coll/quant arm (see allreduce): explicit budget only
        if not self._c.force_var("allgather"):
            qcodec = quant_mod.pick(comm, "allgather",
                                    getattr(sendbuf, "dtype", None),
                                    nbytes)
            if qcodec is not None:
                _pt = profile.now() if profile.enabled else 0
                try:
                    return quant_mod.allgather_blockq(comm, sendbuf,
                                                      qcodec)
                finally:
                    if profile.enabled:
                        profile.stage_span("coll.alg", _pt)
        default = default_algorithm("allgather", comm.size, nbytes)
        alg, _ = self._pick("allgather", comm.size, nbytes, default)
        return self._run("allgather", alg, default, comm, sendbuf)

    def alltoall(self, comm, sendbuf):
        stack = np.asarray(staged(sendbuf))
        nbytes = stack.nbytes   # total, like every other collective
        per_block = nbytes // max(1, stack.shape[0] if stack.ndim else 1)
        default = default_algorithm("alltoall", comm.size, nbytes,
                                    per_block=per_block)
        alg, _ = self._pick("alltoall", comm.size, nbytes, default)
        return self._run("alltoall", alg, default, comm, stack)

    def barrier(self, comm):
        default = default_algorithm("barrier", comm.size, 0)
        alg, _ = self._pick("barrier", comm.size, 0, default)
        return self._run("barrier", alg, default, comm)

    def reduce_scatter(self, comm, sendbuf, recvcounts=None, op=op_mod.SUM):
        sendbuf = staged(sendbuf)
        nbytes = _nbytes(sendbuf)
        default = default_algorithm("reduce_scatter", comm.size, nbytes,
                                    op.commute)
        alg, _ = self._pick("reduce_scatter", comm.size, nbytes,
                            default, commute=op.commute)
        return self._run("reduce_scatter", alg, default,
                         comm, sendbuf, recvcounts, op)

    def gather(self, comm, sendbuf, root=0):
        sendbuf = staged(sendbuf)
        nbytes = _nbytes(sendbuf)
        default = default_algorithm("gather", comm.size, nbytes)
        alg, _ = self._pick("gather", comm.size, nbytes, default)
        return self._run("gather", alg, default, comm, sendbuf, root)

    def scatter(self, comm, sendbuf, root=0):
        sendbuf = staged(sendbuf)
        nbytes = _nbytes(sendbuf)
        default = default_algorithm("scatter", comm.size, nbytes)
        alg, _ = self._pick("scatter", comm.size, nbytes, default)
        return self._run("scatter", alg, default, comm, sendbuf, root)


class TunedCollComponent(Component):
    name = "tuned"
    priority = 30

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=30,
            help="Selection priority of coll/tuned")
        self._rules_file = self.register_var(
            "dynamic_rules_filename", vtype=VarType.STRING, default="",
            help="Path to a dynamic decision-rule file "
                 "(coll_tuned_component.c:232 equivalent)")
        self._force: dict[str, object] = {}
        self._seg: dict[str, object] = {}
        for coll, menu in _MENUS.items():
            self._force[coll] = self.register_var(
                f"{coll}_algorithm", vtype=VarType.STRING, default="",
                help=f"Force a {coll} algorithm: one of "
                     f"{', '.join(sorted(menu))} (empty = decision ladder)")
        for coll, default in (("allreduce", 1 << 20), ("bcast", 1 << 17),
                              ("reduce", 1 << 17)):
            self._seg[coll] = self.register_var(
                f"{coll}_segsize", vtype=VarType.INT, default=default,
                help=f"Segment size in bytes for segmented {coll} algorithms")
        self._fused = self.register_var(
            "fused_cells", vtype=VarType.STRING, default="",
            help="Device-tier fused ladder cells (ops/overlap) consulted via "
                 f"device_cell(): one of {', '.join(DEVICE_CELLS)} to force "
                 "that cell only, 'off' to disable the fused tier (callers "
                 "take their unfused einsum form), empty = ladder decides")
        self._eager_lane = self.register_var(
            "eager_lane_max", vtype=VarType.SIZE, default="4k",
            help="Allreduces below this take the SPC-counted small-message "
                 "eager lane (straight to the cached recursive-doubling "
                 "schedule, skipping the decision machinery); 0 disables "
                 "the lane.  Matches the fixed ladder's recursive-doubling "
                 "threshold")
        self.rules: list[tuple] = []

    def open(self) -> bool:
        self.rules = []
        path = (self._rules_file.value or "").strip()
        if path:
            try:
                self.rules = _load_rules(path)
            except OSError as exc:
                show_help("help-coll-tuned", "bad-rules-file",
                          path=path, error=str(exc))
        return True

    def force_var(self, coll: str) -> str:
        v = self._force.get(coll)
        return (v.value or "").strip() if v is not None else ""

    def segsize(self, coll: str) -> int:
        v = self._seg.get(coll)
        return int(v.value) if v is not None else 1 << 20

    def fused_cells_var(self) -> str:
        v = getattr(self, "_fused", None)
        return (v.value or "").strip() if v is not None else ""

    def eager_lane_max(self) -> int:
        v = getattr(self, "_eager_lane", None)
        return int(v.value) if v is not None else 4096

    def comm_query(self, comm):
        if comm.rte is not None and comm.rte.is_device_world:
            return None   # conductor and the device components own it
        if comm.size == 1 or comm.is_inter:
            return None   # intercomms take coll/inter's two-group protocol
        return self._prio.value, TunedModule(self)


def _load_rules(path: str) -> list[tuple]:
    rules = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) not in (4, 5):
                raise OSError(f"line {lineno}: expected "
                              "'coll max_size max_bytes alg [segsize]'")
            coll, max_size, max_bytes, alg = parts[:4]
            seg = int(parts[4]) if len(parts) == 5 else 0
            if coll not in _MENUS:
                raise OSError(f"line {lineno}: unknown collective {coll!r}")
            if alg not in _MENUS[coll]:
                raise OSError(f"line {lineno}: unknown {coll} algorithm "
                              f"{alg!r}")
            rules.append((coll, int(max_size), int(max_bytes), alg, seg))
    return rules


COMPONENT = TunedCollComponent()

register_help(
    "help-coll-tuned", "unknown-algorithm",
    "coll/tuned was asked for {coll} algorithm {alg!r} but only knows: "
    "{known}; using the first available instead.")
register_help(
    "help-coll-tuned", "bad-rules-file",
    "coll/tuned could not load the dynamic rules file {path!r}: {error}. "
    "Falling back to the fixed decision ladder.")
