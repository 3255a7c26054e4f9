"""coll/ftagree — the ULFM agreement collective.

Copy of ``ompi_tpu/mca/coll/ftagree.py`` (after the reference's
``ompi/mca/coll/ftagree/``): fills the ``agree``/``iagree`` slots of a
multi-process communicator at priority 30, above coll/basic's allreduce of
BAND, with a fault-tolerant consensus (``ft/agreement.py``: ERA by
default, ``tree`` or ``kv`` by ``otpu_coll_ftagree_algorithm``).

ULFM semantics (``ompi/mpiext/ftmpi/c/comm_agree.c``): the flag is
bitwise-ANDed over the live participants; the call is uniform; if a
member failed and is not acknowledged (``Comm.ack_failed``), every
survivor raises ``ProcFailedError`` carrying the agreed flag, after
agreeing.  The device world keeps coll/conductor's local AND (one process:
its failure knowledge is already uniform).
"""
from __future__ import annotations

from ompi_tpu_torch.api.request import CompletedRequest
from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType
from ompi_tpu_torch.ft import state as ft_state


class FtAgreeModule:
    def __init__(self, component: "FtAgreeComponent") -> None:
        self._c = component

    def agree(self, comm, flag: int) -> int:
        from ompi_tpu_torch.api.errors import ProcFailedError
        from ompi_tpu_torch.ft.agreement import agree_kv, agree_p2p, agree_tree

        members = list(comm.group.world_ranks)
        live = [r for r in members if not ft_state.is_failed(r)]
        seq = comm._agree_seq = getattr(comm, "_agree_seq", 0) + 1
        # each participant contributes (flag, its failure knowledge, whether
        # it has group failures it hasn't acknowledged): the AND/union/OR
        # over contributions makes the failed-set AND the error outcome part
        # of the uniform decision (comm_agree.c group-fault sync) — all
        # survivors raise ProcFailedError or none do, never a mix
        acked = getattr(comm, "_acked_failed", frozenset())
        known_failed = ft_state.failed_ranks()
        my_unacked = any(r in known_failed and r not in acked
                         for r in members)
        instance = ("agree", comm.cid, comm.epoch, seq)
        prev = (("agree", comm.cid, comm.epoch, seq - 2)
                if seq > 2 else None)
        combine = lambda a, b: (a[0] & b[0], a[1] | b[1], a[2] or b[2])
        contribution = (int(flag), known_failed, my_unacked)
        alg = (self._c.alg_var.value or "era").strip()
        if alg == "era":
            # coordination-free ERA: decisions never touch the coord
            # server (it stays restricted to wire-up)
            (agreed_flag, agreed_failed, any_unacked), _ = agree_p2p(
                comm, instance, contribution, live, combine,
                prev_instance=prev)
        elif alg == "tree":
            (agreed_flag, agreed_failed, any_unacked), _ = agree_tree(
                comm, instance, contribution, live, combine,
                prev_instance=prev)
        else:
            (agreed_flag, agreed_failed, any_unacked), _ = agree_kv(
                comm.rte, instance, contribution, live, combine,
                prev_instance=prev)
        if any_unacked:
            in_group_failed = [r for r in members if r in agreed_failed]
            err = ProcFailedError(
                f"agreement completed but ranks {in_group_failed} failed "
                f"without all survivors acknowledging",
                tuple(comm.group.rank_of(r) for r in in_group_failed))
            err.flag = agreed_flag
            comm._err(err)  # route through the communicator errhandler
        return agreed_flag

    def iagree(self, comm, flag: int):
        r = CompletedRequest()
        r.result = self.agree(comm, flag)
        return r


class FtAgreeComponent(Component):
    name = "ftagree"
    priority = 30

    def register_vars(self, fw) -> None:
        self._prio = self.register_var(
            "priority", vtype=VarType.INT, default=30,
            help="Selection priority of coll/ftagree")
        self.alg_var = self.register_var(
            "algorithm", vtype=VarType.STRING, default="era",
            help="Agreement algorithm: 'era' (coordination-free p2p "
                 "tree reduce + pledge-guarded takeover, the default), "
                 "'tree' (binomial p2p reduce with KV-anchored uniform "
                 "decision), or 'kv' (coordinator-decides over the "
                 "coordination service)")

    def comm_query(self, comm):
        # the consensus needs the out-of-band KV service: multi-process only
        if comm.rte is None or comm.rte.is_device_world:
            return None
        if getattr(comm.rte, "client", None) is None:
            return None
        if comm.size == 1:
            return None
        return self._prio.value, FtAgreeModule(self)


COMPONENT = FtAgreeComponent()
