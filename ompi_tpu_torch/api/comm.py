"""Communicators: group + CID + per-comm collective vtable.

Port of the device-world part of ``ompi_tpu/api/comm.py``: a communicator
owns its group, a context id and a per-comm collective vtable ``c_coll``
filled by the priority vote of the coll components
(``coll_base_comm_select.c``), and its info hints (an ``Info``; the
``otpu_quant_budget`` key arms coll/quant).  Every slot that no selected
module fills raises ``MpiError(ERR_UNSUPPORTED_OPERATION)``.

The collectives: the host entry points (numpy stacks with a leading rank
axis, or a device tensor, which coll/conductor forwards to the device
slot), their ``i*`` forms, the device-buffer ``*_array`` slots, ``agree``
and the persistent collectives (``allreduce_array_init``, ``coll_init``).
Construction, the device-world branch of each (one process acts for every
rank, so a CID is a local find-and-set): ``dup``, ``split``, ``create``,
``create_group``, ``compare``, ``free`` and ``as_rank``.  In the device
world ``split`` and ``create`` return the new comm that holds the
conductor's rank (world rank 0), or None where it holds none;
``as_rank(i)`` acts as rank i.  In the multi-process world (``tpurun``)
a CID is agreed over the comm (``_next_cid``, ``comm_cid.c:53``) and
``split`` exchanges the (color, key) table with an allgather.

Point-to-point (``ompi_tpu/api/comm.py:563-805``) dispatches to the
selected pml module as ``MPI_Send`` does (``ompi/mpi/c/send.c:93`` →
``MCA_PML_CALL``): the send modes, their persistent forms, ``sendrecv``,
the probe family and the object forms.  A tensor given as a buffer is
staged through ``torch_acc.to_host`` (the reference's ``np.asarray`` of a
``jax.Array``); as a receive buffer it is read-only there, as
``np.asarray`` of a ``jax.Array`` is, so the delivery raises ValueError.
Error handlers (``comm.py:195-203``): a comm starts with
ERRORS_ARE_FATAL, a comm made from it inherits its handler, and
``call_errhandler`` invokes it.  ``idup`` is the dup with a request born
complete (``comm.py:948``).

Process topologies (``comm.py:1022``, ``:1110-1430``): ``split_type``
(``Rte.locality_color``), ``topo_test``, ``cart_create`` (with ``reorder``:
node-major order, decided by a collective MIN in the multi-process world),
``cart_map``, ``graph_map``, the ``cart_*`` accessors, ``cart_sub``,
``graph_create``, ``dist_graph_create_adjacent`` and the neighbor
collectives with their ``i*`` forms.  In the device world the topology
constructors pass the whole colour table to ``split``, and the neighbor
collectives read a table whose leading axis indexes ranks: a numpy table
gives numpy rows, as the reference's ``np.asarray`` does, and a tensor table
gives clones of its rows on its own device, with no host copy (the
reference turns a ``jax.Array`` into numpy).  In the multi-process world a
tensor is staged through ``torch_acc.to_host``, as point-to-point does.

ULFM (``comm.py:1551-1608``): every comm carries an FT ``epoch`` (a shrink
bumps it), ``revoke``, ``shrink``, ``agree``, ``get_failed``,
``ack_failed``, ``ft_scope`` and ``is_revoked``.  ``_check_state`` probes
the global revocation set with a prebuilt ``(scope, cid, epoch)`` key
through a cached module reference, so a revocation flooded in from another
rank reaches every call (``allreduce_array``'s fast path inlines the same
probe), and a named point-to-point peer that has failed raises
``ProcFailedError`` before any staging.  Both errors go through the comm's
error handler.

Sessions and intercommunicators (``comm.py:104-170``, ``:837-980``,
``:1464-1545``): ``create_from_group`` builds a comm from a bare group
with no parent, on the active instance (a Session's or the world's); in the
device world and as a singleton its CID is local, between processes the
first member through publishes a bridge-range CID under the coordination
service's put-if-absent, keyed by (members, tag, invocation), and every
member adopts it.  ``create_intercomm_from_groups`` builds the local comm
first, then the intercomm on a CID agreed the same way over the union of
the groups.  An intercommunicator carries ``remote_group`` (``is_inter``,
``remote_size``) and ``local_comm``, its local collective channel; a
point-to-point peer rank indexes the remote group, and coll/inter serves
its collectives.  ``create_intercomm`` joins two disjoint comms through
leaders that share a bridge comm; ``spawn``, ``spawn_multiple``,
``accept``, ``connect`` and ``merge`` are dpm's (``ompi_tpu_torch.dpm``);
``compare`` compares the local and the remote groups of intercomms.

The partitioned forms (``comm.py:677-722``): ``psend_init`` and
``precv_init`` build ``mca/part/persist``'s requests over the pml, and
``pallreduce_init`` binds one handle a bucket through the
``partitioned_coll`` slot (coll/builtin's, as only coll/xla has it in the
reference), else runs the host allreduce at each ``pready``.  Every comm
joins the weak live-communicator registry at construction
(``comm.py:75-93``, ``live_comms``), which ``runtime/debugger`` walks.  Not
ported yet: attributes.
"""
from __future__ import annotations

import copy
import sys
import threading
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.api import op as op_mod
from ompi_tpu_torch.api.errhandler import ERRORS_ARE_FATAL, Errhandler
from ompi_tpu_torch.api.errors import ErrorClass, MpiError, RevokedError
from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.api.info import Info
from ompi_tpu_torch.api.request import CompletedRequest, Request
from ompi_tpu_torch.api.status import ANY_SOURCE, ANY_TAG, PROC_NULL, Status
from ompi_tpu_torch.datatype import Datatype, from_numpy_dtype

_ft_state_mod = None


def _ft_state():
    """Cached ``ft.state`` module reference (the import is lazy to avoid a
    cycle, and a ``sys.modules`` lookup per ``_check_state`` would cost the
    fast path)."""
    global _ft_state_mod
    if _ft_state_mod is None:
        from ompi_tpu_torch.ft import state

        _ft_state_mod = state
    return _ft_state_mod


#: collective function slots a coll module can fill (the entry points of
#: ``ompi_tpu/api/comm.py:COLL_FUNCTIONS`` ported so far)
COLL_FUNCTIONS = (
    "barrier", "bcast", "gather", "gatherv", "scatter", "scatterv",
    "allgather", "allgatherv", "alltoall", "alltoallv", "alltoallw",
    "reduce", "allreduce", "reduce_scatter", "reduce_scatter_block",
    "scan", "exscan",
    "ibarrier", "ibcast", "igather", "iscatter", "iallgather", "ialltoall",
    "ireduce", "iallreduce", "ireduce_scatter", "iscan", "iexscan",
    "allreduce_array", "bcast_array", "allgather_array",
    "reduce_scatter_array", "alltoall_array", "ppermute_array",
    "psum_scatter_array", "reduce_array", "gather_array", "scatter_array",
    "allgatherv_array", "alltoallv_array", "scan_array", "exscan_array",
    "persistent_coll", "partitioned_coll", "device_barrier", "agree",
    "iagree")

_torch_acc = None


def host_buffer(buf) -> np.ndarray:
    """A buffer as numpy: a tensor goes through ``torch_acc.to_host`` (on
    the card, a D2H copy) and comes back read-only, as ``np.asarray`` of a
    ``jax.Array`` does in the reference (point-to-point and coll/basic)."""
    if isinstance(buf, np.ndarray):
        return buf
    if is_tensor(buf):
        arr = _acc().to_host(buf)
        arr.flags.writeable = False
        return arr
    return np.asarray(buf)


def as_buffer(buf) -> tuple[np.ndarray, int, Datatype]:
    """Normalize a user buffer to (ndarray, count, datatype).

    Accepts an ndarray or a tensor (count/type inferred), or an explicit
    ``(buffer, count, Datatype)`` triple for derived layouts.
    """
    if isinstance(buf, tuple):
        arr, count, dt = buf
        return host_buffer(arr), count, dt
    arr = host_buffer(buf)
    return arr, arr.size, from_numpy_dtype(arr.dtype)


def is_tensor(buf) -> bool:
    """True for a torch tensor (``torch_acc.is_device_array``), without
    importing ``torch_acc``: a numpy job reaches the accelerator module (and
    its ``staging`` telemetry source) where the reference reaches
    ``jax_acc``, at the first staging-pool checkout."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(buf, torch.Tensor)


def _acc():
    """The cached ``torch_acc`` module (imported at first use)."""
    global _torch_acc
    if _torch_acc is None:
        from ompi_tpu_torch.mca.accelerator import torch_acc

        _torch_acc = torch_acc
    return _torch_acc


#: per-(members, tag) invocation counters for the sessions-model CID
#: bootstrap: create_from_group is collective over the group, so every
#: member's N-th call with the same (members, tag) pairs up; the count keys
#: successive agreements apart without any pre-existing channel
_group_cid_seq: dict = {}
_group_cid_lock = threading.Lock()


def _agree_group_cid(client, group, tag: str) -> int:
    """Coordination-assisted CID agreement for parent-less construction:
    the first member through publishes a bridge-range CID (globally unique,
    so no per-member freeness check is needed) by an atomic put-if-absent;
    every member adopts the winner."""
    base = (tuple(group.world_ranks), str(tag))
    with _group_cid_lock:
        seq = _group_cid_seq.get(base, 0)
        _group_cid_seq[base] = seq + 1
    from ompi_tpu_torch import dpm

    proposed = dpm._new_bridge_cid(client)
    key = f"__group_cid__:{base!r}:{seq}"
    return int(client.put_new(-1, key, proposed))


#: live-communicator registry for debugger introspection
#: (``runtime.debugger.comm_table`` — the handle-table walk of
#: ``ompi/debuggers/ompi_common_dll.c``).  Weak: registration must not
#: keep freed communicators alive.
_live_comms: "weakref.WeakSet" = None  # initialized lazily below


def _register_live(comm) -> None:
    global _live_comms
    import weakref

    if _live_comms is None:
        _live_comms = weakref.WeakSet()
    _live_comms.add(comm)


def live_comms() -> list:
    """Snapshot of live communicators (debugger support)."""
    return sorted(_live_comms or [], key=lambda c: (c.cid, c.epoch))


def forget_live_comms() -> None:
    """Empty the registry at the instance's teardown, which ends every
    communicator it carried (``ompi_mpi_finalize`` destroys the remaining
    comms): a comm of a torn-down instance that a reference cycle keeps
    uncollected is no handle a debugger walks.  The JAX package's registry
    keeps such a comm until the collector takes it."""
    if _live_comms is not None:
        _live_comms.clear()


def _row_copy(table, r: int):
    """Row ``r`` of a device-world table, copied: a tensor's row stays on
    its device (a clone, no host copy); anything else becomes a numpy copy,
    as the reference's ``np.asarray`` does."""
    if is_tensor(table):
        return table[r].clone()
    return np.array(np.asarray(table[r]), copy=True)


class Comm:
    # comm_compare results (``mpi.h`` MPI_IDENT family)
    IDENT = 0
    CONGRUENT = 1
    SIMILAR = 2
    UNEQUAL = 3

    def __init__(self, group: Group, cid: int, rte, name: str = "",
                 epoch: int = 0, parent: Optional["Comm"] = None,
                 remote_group: Optional[Group] = None) -> None:
        self.group = group
        self.cid = cid
        self.epoch = epoch  # FT epoch: revoked CIDs can't be confused on reuse
        self.rte = rte
        self.name = name or f"comm#{cid}"
        self.c_coll: dict[str, Any] = {}
        self.coll_modules: list = []
        self.info = Info()
        self.topo = None          # set by the topo constructors
        self.revoked = False
        self.freed = False
        self.remote_group = remote_group  # intercommunicator remote side
        self.pml = None           # selected pml module (set at creation)
        self.errhandler: Errhandler = ERRORS_ARE_FATAL
        self._rev_key = None      # lazy (ft_scope, cid, epoch) probe key
        self._rank = group.rank_of(rte.my_world_rank) if rte else 0
        if parent is not None:
            self.errhandler = parent.errhandler
        _register_live(self)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def is_inter(self) -> bool:
        return self.remote_group is not None

    @property
    def remote_size(self) -> int:
        return self.remote_group.size if self.remote_group else 0

    def world_rank(self, rank: int) -> int:
        return self.group.world_rank(rank)

    def as_rank(self, rank: int) -> "Comm":
        """Conductor-model facade: this communicator acting as ``rank``.

        In the device-world (single-controller) model the one process hosts
        every rank; ``as_rank(i).split(...)`` returns rank i's part of the
        split.  Shares all communicator state with self.
        """
        if not 0 <= rank < self.size:
            raise MpiError(ErrorClass.ERR_RANK, f"invalid rank {rank}")
        view = copy.copy(self)
        view._rank = rank
        return view

    def get_name(self) -> str:
        return self.name

    def set_name(self, name: str) -> None:
        self.name = name

    def set_errhandler(self, eh: Errhandler) -> None:
        self.errhandler = eh

    def get_errhandler(self) -> Errhandler:
        return self.errhandler

    def call_errhandler(self, errorcode) -> None:
        """``MPI_Comm_call_errhandler`` (the fatal default handler aborts,
        ERRORS_RETURN raises the MpiError to the caller)."""
        try:
            cls = ErrorClass(int(errorcode))
        except ValueError:
            cls = ErrorClass.ERR_OTHER
        self._err(MpiError(cls, f"user-raised code {int(errorcode)}"))

    def _err(self, error: MpiError) -> None:
        self.errhandler.invoke(self, error)
        raise error  # ERRORS_RETURN handler already raised; fatal aborts

    def _check_state(self, peer: Optional[int] = None) -> None:
        # NOTE: allreduce_array inlines the peer=None predicate (freed +
        # is_revoked) on its fast path: mirror any new comm-wide check
        # added here into that method too
        if self.freed:
            raise MpiError(ErrorClass.ERR_COMM, "communicator was freed")
        if self.is_revoked():
            self._err(RevokedError(f"{self.name} revoked"))
        if peer is not None and peer not in (ANY_SOURCE, PROC_NULL):
            if not 0 <= peer < (self.remote_size if self.is_inter
                                else self.size):
                raise MpiError(ErrorClass.ERR_RANK, f"invalid rank {peer}")
            # ULFM early liveness check (send.c:84): a point-to-point peer
            # only, never the collective fast path; an intercomm peer rank
            # indexes the remote group
            peer_world = (self.remote_group if self.is_inter
                          else self.group).world_rank(peer)
            if _ft_state().is_failed(peer_world):
                from ompi_tpu_torch.api.errors import ProcFailedError

                self._err(ProcFailedError(f"peer {peer} has failed",
                                          (peer,)))

    def _coll(self, name: str):
        fn = self.c_coll.get(name)
        if fn is None:
            raise MpiError(
                ErrorClass.ERR_UNSUPPORTED_OPERATION,
                f"no coll component provides '{name}' on {self.name}")
        return fn

    def set_info(self, info: Info) -> None:
        """``MPI_Comm_set_info``: replace the comm's info hints."""
        self.info = info.dup()

    def get_info(self) -> Info:
        """``MPI_Comm_get_info``."""
        return self.info.dup()

    def dup(self) -> "Comm":
        """``MPI_Comm_dup`` in the device world: the same group and rte, the
        next free context id, the info hints copied, and a coll selection
        of its own (``comm_dup`` + ``coll_base_comm_select``)."""
        self._check_state()
        newcomm = Comm(self.group, self._next_cid(), self.rte,
                       name=f"{self.name}~dup", epoch=self.epoch,
                       parent=self)
        newcomm.info = self.info.dup()
        self._finish_create(newcomm)
        return newcomm

    def idup(self) -> tuple["Comm", Request]:
        """``MPI_Comm_idup``: the dup itself is collective-synchronous
        here (CID agreement), so the request is born complete."""
        newcomm = self.dup()
        req = CompletedRequest()
        req.result = newcomm
        return newcomm, req

    def dup_with_info(self, info: Info) -> "Comm":
        """``MPI_Comm_dup_with_info``: dup, with the new comm's hints
        REPLACED by ``info`` instead of inherited."""
        newcomm = self.dup()
        newcomm.info = info.dup()
        return newcomm

    # -- sessions-model construction (MPI-4, ``ompi/communicator``
    # ``ompi_comm_create_from_group`` / ``ompi_intercomm_create_from_groups``)
    @classmethod
    def create_from_group(cls, group: Group, tag: str = "",
                          info: Optional[Info] = None,
                          errhandler=None, name: str = "") -> Optional["Comm"]:
        """``MPI_Comm_create_from_group``: a communicator from a bare group,
        with NO parent communicator and no ``init`` required; the active
        instance (opened by a Session or by world init) supplies the pml
        and the CID machinery.  Collective over the group's members; ``tag``
        tells apart concurrent creations from overlapping groups (MPI-4's
        string tag).  Returns None on a process outside the group (the
        device world's conductor hosts every rank)."""
        from ompi_tpu_torch import instance as inst_mod
        from ompi_tpu_torch.runtime import init as rt

        inst = inst_mod.current()
        if inst is None:
            raise MpiError(
                ErrorClass.ERR_SESSION,
                "no active instance: open a Session (Session.init) or "
                "call init() before create_from_group")
        rte = inst.rte
        if not rte.is_device_world and \
                group.rank_of(rte.my_world_rank) < 0:
            return None
        client = getattr(rte, "client", None)
        if client is None or rte.is_device_world:
            cid = rt.next_local_cid()
        else:
            cid = _agree_group_cid(client, group, tag)
            rt.reserve_cid(cid)
        newcomm = cls(group, cid, rte, name=name or f"from_group~{tag or cid}")
        if info is not None:
            newcomm.info = info.dup()
        if errhandler is not None:
            newcomm.errhandler = errhandler
        cls._wire_new_comm(newcomm, inst.pml)
        return newcomm

    @classmethod
    def create_intercomm_from_groups(cls, local_group: Group,
                                     local_leader: int,
                                     remote_group: Group,
                                     remote_leader: int, tag: str = "",
                                     info: Optional[Info] = None,
                                     errhandler=None) -> Optional["Comm"]:
        """``MPI_Intercomm_create_from_groups``: an intercommunicator from
        two disjoint groups with no parent and no bridge comm.  The local
        comm (the collective channel every intercomm carries) is built
        first by :meth:`create_from_group`; the bridge CID is agreed through
        the coordination service under a key both sides derive identically
        from the UNION of the groups and the tag."""
        from ompi_tpu_torch import instance as inst_mod
        from ompi_tpu_torch.runtime import init as rt

        inst = inst_mod.current()
        if inst is None:
            raise MpiError(
                ErrorClass.ERR_SESSION,
                "no active instance: open a Session (Session.init) or "
                "call init() before create_intercomm_from_groups")
        rte = inst.rte
        overlap = set(local_group.world_ranks) & \
            set(remote_group.world_ranks)
        if overlap:
            raise MpiError(ErrorClass.ERR_GROUP,
                           f"groups overlap on ranks {sorted(overlap)}")
        local = cls.create_from_group(local_group, tag=f"{tag}//local",
                                      info=info)
        if local is None:
            return None
        client = getattr(rte, "client", None)
        if client is None or rte.is_device_world:
            cid = rt.next_local_cid()
        else:
            union = Group(sorted(set(local_group.world_ranks)
                                 | set(remote_group.world_ranks)))
            cid = _agree_group_cid(client, union, f"{tag}//inter")
            rt.reserve_cid(cid)
        inter = cls(local_group, cid, rte, name=f"from_groups~{tag or cid}",
                    remote_group=remote_group)
        if errhandler is not None:
            inter.errhandler = errhandler
        inter.local_comm = local
        cls._wire_new_comm(inter, local.pml)
        return inter

    def compare(self, other: "Comm") -> int:
        """``MPI_Comm_compare``: IDENT (same object), CONGRUENT (same
        group(s) and order, another context), SIMILAR (same members, another
        order), UNEQUAL.  Intercomms compare the local AND the remote
        groups; an intercomm never matches an intracomm."""
        if self is other:
            return Comm.IDENT
        if self.is_inter != other.is_inter:
            return Comm.UNEQUAL
        mine = list(self.group.world_ranks)
        theirs = list(other.group.world_ranks)
        if self.is_inter:
            rm = list(self.remote_group.world_ranks)
            rt = list(other.remote_group.world_ranks)
            if mine == theirs and rm == rt:
                return Comm.CONGRUENT
            if sorted(mine) == sorted(theirs) and sorted(rm) == sorted(rt):
                return Comm.SIMILAR
            return Comm.UNEQUAL
        if mine == theirs:
            return Comm.CONGRUENT
        if sorted(mine) == sorted(theirs):
            return Comm.SIMILAR
        return Comm.UNEQUAL

    def split(self, color, key=0) -> Optional["Comm"]:
        """``MPI_Comm_split``.  Device world: ``color`` and ``key`` are
        scalars or ``(size,)`` arrays of per-rank values.  Multi-process
        world: each rank passes its own, and the table is exchanged with an
        allgather over the parent.  One CID per distinct non-negative color,
        allocated in sorted color order; the members of a color ordered by
        (key, rank).  Returns the new comm of this (facade) rank's color,
        or None for a color < 0 (``MPI_UNDEFINED``)."""
        self._check_state()
        if self.rte is not None and self.rte.is_device_world:
            colors = np.broadcast_to(np.asarray(color, np.int64),
                                     (self.size,))
            keys = np.broadcast_to(np.asarray(key, np.int64), (self.size,))
            table = np.stack([colors, keys,
                              np.arange(self.size, dtype=np.int64)], 1)
        else:
            mine = np.array([color, key, self.rank], dtype=np.int64)
            table = np.asarray(self.allgather(mine)).reshape(self.size, 3)
        distinct = sorted({int(c) for c, _, _ in table if c >= 0})
        cids = {c: self._next_cid() for c in distinct}
        my_color = int(table[self.rank, 0])
        if my_color < 0:  # MPI_UNDEFINED
            return None
        members = sorted((int(k), int(r)) for c, k, r in table
                         if c == my_color)
        ranks = [self.group.world_rank(r) for _, r in members]
        newcomm = Comm(Group(ranks), cids[my_color], self.rte,
                       name=f"{self.name}~split", epoch=self.epoch,
                       parent=self)
        self._finish_create(newcomm)
        return newcomm

    def split_type(self, split_type: str = "shared", key=0) -> "Comm":
        """``MPI_Comm_split_type``: 'shared' = the same node (the device
        world is one card: one colour for every rank)."""
        color = self.rte.locality_color(split_type)
        return self.split(color, key)

    def create(self, group: Group) -> Optional["Comm"]:
        """``MPI_Comm_create``: a CID is taken whether or not the
        conductor's rank is a member; None where it is not."""
        self._check_state()
        cid = self._next_cid()
        if group.rank_of(self.rte.my_world_rank) < 0:
            return None
        newcomm = Comm(group, cid, self.rte, name=f"{self.name}~create",
                       epoch=self.epoch, parent=self)
        self._finish_create(newcomm)
        return newcomm

    def create_group(self, group: Group, tag: int = 0) -> Optional["Comm"]:
        """``MPI_Comm_create_group``: non-collective over the parent; only
        group members take part.  In the device world the CID is the local
        next one; otherwise the members agree on it over parent p2p on a
        reserved tag."""
        if group.rank_of(self.rte.my_world_rank) < 0:
            return None
        if self.rte is not None and self.rte.is_device_world:
            from ompi_tpu_torch.runtime import init as rt

            cid = rt.next_local_cid()
        else:
            cid = self._agree_cid_group(group, tag)
        newcomm = Comm(group, cid, self.rte,
                       name=f"{self.name}~create_group", epoch=self.epoch,
                       parent=self)
        self._finish_create(newcomm)
        return newcomm

    def _next_cid(self) -> int:
        """Agree on the next free CID across members (``comm_cid.c:53``).

        One process backs every rank of the device world, so a local
        find-and-set is the agreement there.  Otherwise multi-round, as the
        reference: each member proposes its first locally-free id
        (unreserved), the group takes the MAX, then a second allreduce
        confirms the winner is free on every member; on a conflict,
        re-propose above it."""
        from ompi_tpu_torch.runtime import init as rt

        if self.rte is not None and self.rte.is_device_world:
            return rt.next_local_cid()
        floor = 0
        while True:
            local = rt.candidate_cid(floor)
            agreed = int(np.asarray(self.allreduce(
                np.array([local], dtype=np.int64), op_mod.MAX)).ravel()[0])
            ok = 1 if rt.is_cid_free(agreed) else 0
            all_ok = int(np.asarray(self.allreduce(
                np.array([ok], dtype=np.int64), op_mod.MIN)).ravel()[0])
            if all_ok:
                rt.reserve_cid(agreed)
                return agreed
            floor = agreed + 1

    def _agree_cid_group(self, group: Group, tag: int) -> int:
        """Multi-round CID agreement among group members via parent p2p
        (``ompi_tpu/api/comm.py:_agree_cid_group``)."""
        from ompi_tpu_torch.runtime import init as rt

        members = [self.group.rank_of(w) for w in group.world_ranks]
        leader = members[0]
        t = -(1 << 20) - tag  # reserved internal tag space

        def xchg(value: int, combine) -> int:
            if self.rank == leader:
                acc = value
                got = np.zeros(1, dtype=np.int64)
                for m in members[1:]:
                    self.recv(got, m, t)
                    acc = combine(acc, int(got[0]))
                out = np.array([acc], dtype=np.int64)
                for m in members[1:]:
                    self.send(out, m, t)
                return acc
            self.send(np.array([value], dtype=np.int64), leader, t)
            got = np.zeros(1, dtype=np.int64)
            self.recv(got, leader, t)
            return int(got[0])

        floor = 0
        while True:
            agreed = xchg(rt.candidate_cid(floor), max)
            all_ok = xchg(1 if rt.is_cid_free(agreed) else 0, min)
            if all_ok:
                rt.reserve_cid(agreed)
                return agreed
            floor = agreed + 1

    @staticmethod
    def _wire_new_comm(newcomm: "Comm", pml) -> None:
        """The one wiring sequence every new comm gets, parented or
        sessions-model alike (``comm.py:1095``): registered for the
        teardown, the pml attached, then coll selection."""
        from ompi_tpu_torch.mca.coll.base import comm_select
        from ompi_tpu_torch.runtime import init as rt

        rt.register_comm(newcomm)
        newcomm.pml = pml
        if pml is not None:
            pml.add_comm(newcomm)
        comm_select(newcomm)

    def _finish_create(self, newcomm: "Comm") -> None:
        """A comm made from this one: its error handler and pml."""
        newcomm.errhandler = self.errhandler
        Comm._wire_new_comm(newcomm, self.pml)

    def free(self) -> None:
        """``MPI_Comm_free``: release the coll modules, drop the pml's
        matching state and retire the CID (never reused).  A second free is
        a no-op."""
        if self.freed:
            return
        self.release_coll_modules()
        if self.pml is not None:
            self.pml.del_comm(self)
        if self.cid > 1:
            from ompi_tpu_torch.runtime import init as rt

            rt.retire_cid(self.cid)
        self.freed = True

    def agree(self, flag: int) -> int:
        # NOT _check_state: ULFM's agreement is the recovery primitive and
        # must keep working on a revoked communicator
        if self.freed:
            raise MpiError(ErrorClass.ERR_COMM, "communicator was freed")
        return self._coll("agree")(self, flag)

    # blocking host collectives (numpy stacks with a leading rank axis) -----
    def barrier(self) -> None:
        self._check_state()
        self._coll("barrier")(self)

    def bcast(self, buf, root: int = 0):
        self._check_state()
        return self._coll("bcast")(self, buf, root)

    def reduce(self, sendbuf, op: op_mod.Op = op_mod.SUM, root: int = 0):
        self._check_state()
        return self._coll("reduce")(self, sendbuf, op, root)

    def allreduce(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("allreduce")(self, sendbuf, op)

    def gather(self, sendbuf, root: int = 0):
        self._check_state()
        return self._coll("gather")(self, sendbuf, root)

    def gatherv(self, sendbuf, root: int = 0):
        self._check_state()
        return self._coll("gatherv")(self, sendbuf, root)

    def scatter(self, sendbuf, root: int = 0):
        self._check_state()
        return self._coll("scatter")(self, sendbuf, root)

    def scatterv(self, sendbufs, root: int = 0):
        self._check_state()
        return self._coll("scatterv")(self, sendbufs, root)

    def allgather(self, sendbuf):
        self._check_state()
        return self._coll("allgather")(self, sendbuf)

    def allgatherv(self, sendbuf):
        self._check_state()
        return self._coll("allgatherv")(self, sendbuf)

    def alltoall(self, sendbuf):
        self._check_state()
        return self._coll("alltoall")(self, sendbuf)

    def alltoallv(self, sendbufs):
        """``MPI_Alltoallv``: ``sendbufs[r]`` goes to rank r."""
        self._check_state()
        return self._coll("alltoallv")(self, sendbufs)

    def alltoallw(self, sendbufs, recvtypes=None):
        """``MPI_Alltoallw``: per-peer buffers and per-peer datatypes
        (recvtypes: numpy dtype per source rank)."""
        self._check_state()
        return self._coll("alltoallw")(self, sendbufs, recvtypes)

    def reduce_scatter(self, sendbuf, recvcounts=None,
                       op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("reduce_scatter")(self, sendbuf, recvcounts, op)

    def reduce_scatter_block(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        """``MPI_Reduce_scatter_block``: equal-sized blocks — sendbuf has
        size*blockcount elements, each rank receives its reduced block; in
        the device world the whole table."""
        self._check_state()
        shape = np.shape(sendbuf)
        lead = shape[-1] if shape else 1
        n = self.size
        if lead % n:
            raise MpiError(
                ErrorClass.ERR_BUFFER,
                f"reduce_scatter_block needs length divisible by {n}, "
                f"got {lead}")
        out = self._coll("reduce_scatter")(self, sendbuf,
                                           [lead // n] * n, op)
        if isinstance(out, list) and len(out) == n:
            return np.stack(out)   # single-controller: the whole table
        return out

    def scan(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("scan")(self, sendbuf, op)

    def exscan(self, sendbuf, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("exscan")(self, sendbuf, op)

    # nonblocking variants ----------------------------------------------
    def ibarrier(self) -> Request:
        self._check_state()
        return self._coll("ibarrier")(self)

    def ibcast(self, buf, root: int = 0) -> Request:
        self._check_state()
        return self._coll("ibcast")(self, buf, root)

    def iallreduce(self, sendbuf, op: op_mod.Op = op_mod.SUM) -> Request:
        self._check_state()
        return self._coll("iallreduce")(self, sendbuf, op)

    def iallgather(self, sendbuf) -> Request:
        self._check_state()
        return self._coll("iallgather")(self, sendbuf)

    def ialltoall(self, sendbuf) -> Request:
        self._check_state()
        return self._coll("ialltoall")(self, sendbuf)

    def ireduce(self, sendbuf, op: op_mod.Op = op_mod.SUM,
                root: int = 0) -> Request:
        self._check_state()
        return self._coll("ireduce")(self, sendbuf, op, root)

    def _icompleted(self, fn, *args) -> Request:
        """Eager "nonblocking" form for slots without an overlapped
        schedule: runs the collective now and returns a born-complete
        request."""
        self._check_state()
        r = CompletedRequest()
        r.result = fn(*args)
        return r

    def _icoll(self, name: str, blocking, *args) -> Request:
        """Route to a module-provided nonblocking slot when one filled it;
        the eager completed-request form otherwise."""
        fn = self.c_coll.get(name)
        if fn is not None:
            self._check_state()
            return fn(self, *args)
        return self._icompleted(blocking, *args)

    def iscan(self, sendbuf, op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icoll("iscan", self.scan, sendbuf, op)

    def iexscan(self, sendbuf, op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icoll("iexscan", self.exscan, sendbuf, op)

    def igather(self, sendbuf, root: int = 0) -> Request:
        return self._icoll("igather", self.gather, sendbuf, root)

    def igatherv(self, sendbuf, root: int = 0) -> Request:
        return self._icompleted(self.gatherv, sendbuf, root)

    def iscatter(self, sendbuf, root: int = 0) -> Request:
        return self._icoll("iscatter", self.scatter, sendbuf, root)

    def iscatterv(self, sendbufs, root: int = 0) -> Request:
        return self._icompleted(self.scatterv, sendbufs, root)

    def iallgatherv(self, sendbuf) -> Request:
        return self._icompleted(self.allgatherv, sendbuf)

    def ialltoallv(self, sendbufs) -> Request:
        return self._icompleted(self.alltoallv, sendbufs)

    def ialltoallw(self, sendbufs, recvtypes=None) -> Request:
        return self._icompleted(self.alltoallw, sendbufs, recvtypes)

    def ireduce_scatter(self, sendbuf, recvcounts=None,
                        op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icoll("ireduce_scatter", self.reduce_scatter,
                           sendbuf, recvcounts, op)

    def ireduce_scatter_block(self, sendbuf,
                              op: op_mod.Op = op_mod.SUM) -> Request:
        return self._icompleted(self.reduce_scatter_block, sendbuf, op)

    def ineighbor_allgather(self, sendbuf) -> Request:
        return self._icompleted(self.neighbor_allgather, sendbuf)

    def ineighbor_allgatherv(self, sendbuf) -> Request:
        return self._icompleted(self.neighbor_allgatherv, sendbuf)

    def ineighbor_alltoall(self, sendbufs) -> Request:
        return self._icompleted(self.neighbor_alltoall, sendbufs)

    def ineighbor_alltoallv(self, sendbufs) -> Request:
        return self._icompleted(self.neighbor_alltoallv, sendbufs)

    def ineighbor_alltoallw(self, sendbufs, recvtypes=None) -> Request:
        return self._icompleted(self.neighbor_alltoallw, sendbufs,
                                recvtypes)

    # device-array collectives (tensors with a leading rank axis) ----------
    def allreduce_array(self, x, op: op_mod.Op = op_mod.SUM):
        # THE hot call of the framework (DP gradient sync): inline the state
        # check and skip the _coll indirection — one dict probe on the
        # per-comm vtable, then straight into the module fast path
        if self.freed or self.is_revoked():
            self._check_state()
        fn = self.c_coll.get("allreduce_array")
        if fn is None:
            return self._coll("allreduce_array")(self, x, op)  # raise path
        return fn(self, x, op)

    def bcast_array(self, x, root: int = 0):
        self._check_state()
        return self._coll("bcast_array")(self, x, root)

    def allgather_array(self, x):
        self._check_state()
        return self._coll("allgather_array")(self, x)

    def reduce_scatter_array(self, x, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("reduce_scatter_array")(self, x, op)

    def allgatherv_array(self, x, counts):
        self._check_state()
        return self._coll("allgatherv_array")(self, x, counts)

    def alltoallv_array(self, x, counts):
        self._check_state()
        return self._coll("alltoallv_array")(self, x, counts)

    def alltoall_array(self, x):
        self._check_state()
        return self._coll("alltoall_array")(self, x)

    def ppermute_array(self, x, perm):
        self._check_state()
        return self._coll("ppermute_array")(self, x, perm)

    def reduce_array(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        self._check_state()
        return self._coll("reduce_array")(self, x, op, root)

    def gather_array(self, x, root: int = 0):
        self._check_state()
        return self._coll("gather_array")(self, x, root)

    def scatter_array(self, x, root: int = 0):
        self._check_state()
        return self._coll("scatter_array")(self, x, root)

    def scan_array(self, x, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("scan_array")(self, x, op)

    def exscan_array(self, x, op: op_mod.Op = op_mod.SUM):
        self._check_state()
        return self._coll("exscan_array")(self, x, op)

    # persistent collectives (MPI_Allreduce_init & friends) ----------------
    #: blocking collectives coll_init may bind (MPI_*_init set)
    _PCOLL_NAMES = frozenset({
        "barrier", "bcast", "reduce", "allreduce", "gather", "gatherv",
        "scatter", "scatterv", "allgather", "allgatherv", "alltoall",
        "alltoallv", "alltoallw", "reduce_scatter",
        "reduce_scatter_block", "scan", "exscan"})

    def coll_init(self, coll: str, template=None, *args):
        """Persistent collective (``ompi_tpu/api/comm.py:498-539``): a
        restartable request (``start()``/``wait()``/``.result``).  With a
        template and a device provider each start re-runs the device
        collective bound at init on ``template``; otherwise (``template=None``
        binds zero-argument collectives, barrier) each start re-runs the
        blocking collective ``coll`` of ``_PCOLL_NAMES`` with the init's
        arguments."""
        self._check_state()
        from ompi_tpu_torch.api.request import PersistentP2P

        fn = self.c_coll.get("persistent_coll")
        if fn is not None and template is not None:
            handle = fn(self, coll, template, *args)
            return PersistentP2P(lambda: handle.start(template))
        if coll not in self._PCOLL_NAMES:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           f"no persistent binding for '{coll}'")
        blocking = getattr(self, coll)
        call_args = () if template is None and not args \
            else (template, *args)

        def start():
            r = CompletedRequest()
            r.result = blocking(*call_args)
            return r

        return PersistentP2P(start)

    def allreduce_array_init(self, template, op: op_mod.Op = op_mod.SUM):
        """The persistent device allreduce as a bare callable handle
        (``h(x)``, ``h.start(x)``); ``coll_init`` wraps the same binding in
        the request interface."""
        fn = self.c_coll.get("persistent_coll")
        if fn is None:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                           "no device persistent-collective provider on "
                           f"{self.name}")
        return fn(self, "allreduce", template, op)

    # -- p2p dispatch (→ selected pml, like MCA_PML_CALL) ---------------
    def send(self, buf, dest: int, tag: int = 0) -> None:
        self._check_state(dest)
        if dest == PROC_NULL:
            return
        self.pml.send(self, buf, dest, tag)

    def recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
        self._check_state(source)
        if source == PROC_NULL:
            return Status(source=PROC_NULL, tag=ANY_TAG)
        return self.pml.recv(self, buf, source, tag)

    def isend(self, buf, dest: int, tag: int = 0) -> Request:
        self._check_state(dest)
        if dest == PROC_NULL:
            return CompletedRequest()
        return self.pml.isend(self, buf, dest, tag)

    def irecv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Request:
        self._check_state(source)
        if source == PROC_NULL:
            return CompletedRequest(Status(source=PROC_NULL, tag=ANY_TAG))
        return self.pml.irecv(self, buf, source, tag)

    def ssend(self, buf, dest: int, tag: int = 0) -> None:
        """``MPI_Ssend``: returns only after the receiver matched."""
        self.issend(buf, dest, tag).wait()

    def issend(self, buf, dest: int, tag: int = 0) -> Request:
        self._check_state(dest)
        if dest == PROC_NULL:
            return CompletedRequest()
        return self.pml.isend(self, buf, dest, tag, sync=True)

    def rsend(self, buf, dest: int, tag: int = 0) -> None:
        """``MPI_Rsend``: with a posted recv it behaves exactly like send
        (MPI guarantees nothing extra), so it shares the standard path, as
        pml/ob1 does."""
        self.send(buf, dest, tag)

    def irsend(self, buf, dest: int, tag: int = 0) -> Request:
        return self.isend(buf, dest, tag)

    def bsend(self, buf, dest: int, tag: int = 0) -> None:
        """``MPI_Bsend``: copies into the attached buffer space and
        returns; the user's buffer is reusable on return."""
        self.ibsend(buf, dest, tag)   # ibsend is already locally complete

    def ibsend(self, buf, dest: int, tag: int = 0) -> Request:
        from ompi_tpu_torch.api import buffer as _bsend

        self._check_state(dest)
        if dest == PROC_NULL:
            return CompletedRequest()
        arr = np.ascontiguousarray(host_buffer(buf))
        _bsend.claim(arr.nbytes)
        try:
            inner = self.pml.isend(self, arr.copy(), dest, tag)
        except Exception:
            _bsend.release(arr.nbytes)   # claim must not leak
            raise
        _bsend.track(inner, arr.nbytes)
        # buffered semantics: the returned request is LOCALLY complete;
        # only Buffer_detach waits for the real delivery (a
        # rendezvous-size inner request must not leak to the caller, or a
        # bsend-then-wait-then-recv pair would deadlock)
        return CompletedRequest()

    # -- persistent point-to-point (``MPI_Send_init``/``Recv_init``) ----
    def send_init(self, buf, dest: int, tag: int = 0) -> Request:
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(dest)
        if dest == PROC_NULL:
            return PersistentP2P(CompletedRequest)
        return PersistentP2P(lambda: self.pml.isend(self, buf, dest, tag))

    def ssend_init(self, buf, dest: int, tag: int = 0) -> Request:
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(dest)
        if dest == PROC_NULL:
            return PersistentP2P(CompletedRequest)
        return PersistentP2P(
            lambda: self.pml.isend(self, buf, dest, tag, sync=True))

    def bsend_init(self, buf, dest: int, tag: int = 0) -> Request:
        """``MPI_Bsend_init``: every start() claims attach-buffer space and
        completes locally."""
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(dest)
        return PersistentP2P(lambda: self.ibsend(buf, dest, tag))

    def rsend_init(self, buf, dest: int, tag: int = 0) -> Request:
        """``MPI_Rsend_init``: ready mode shares the standard path."""
        return self.send_init(buf, dest, tag)

    def recv_init(self, buf, source: int = ANY_SOURCE,
                  tag: int = ANY_TAG) -> Request:
        from ompi_tpu_torch.api.request import PersistentP2P

        self._check_state(source)
        if source == PROC_NULL:
            return PersistentP2P(
                lambda: CompletedRequest(Status(source=PROC_NULL, tag=ANY_TAG)))
        return PersistentP2P(lambda: self.pml.irecv(self, buf, source, tag))

    # -- partitioned point-to-point (MPI-4 ``MPI_Psend_init`` family) ----
    def psend_init(self, buf, partitions: int, dest: int,
                   tag: int = 0) -> Request:
        """``MPI_Psend_init``: a partitioned persistent send.  After
        ``start()``, each of the ``partitions`` equal slices of ``buf`` (a
        C-contiguous ndarray) is released for transfer by ``req.pready(p)``
        (or ``pready_range``/``pready_list``); the request completes once
        every partition was readied and sent.  Ready runs are aggregated
        onto fewer wire messages under the
        ``otpu_part_persist_min_partitions`` var (``mca/part/persist``)."""
        from ompi_tpu_torch.mca.part import part_module

        self._check_state(dest)
        return part_module().psend_init(self, buf, partitions, dest, tag)

    def precv_init(self, buf, partitions: int, source: int,
                   tag: int = 0) -> Request:
        """``MPI_Precv_init``: the receive side of a partitioned pairing.
        ``req.parrived(p)`` reports per-partition arrival — exact even when
        the sender used a different partition count (byte-framed wire
        protocol).  Wildcards are not supported (MPI-4)."""
        from ompi_tpu_torch.mca.part import part_module

        self._check_state(source)
        return part_module().precv_init(self, buf, partitions, source, tag)

    def pallreduce_init(self, buckets, op: op_mod.Op = op_mod.SUM) -> Request:
        """Partitioned persistent allreduce (the ``MPI_Pallreduce_init``
        analog): each entry of ``buckets`` is bound once as its own
        persistent allreduce (the ``partitioned_coll`` slot);
        ``req.pready(i)`` releases bucket i, on the device path one launch
        that does not wait for the card, so bucket i's reduction overlaps
        the computation still producing bucket i+1.  ``req.parrived(i)``
        tests bucket completion without synchronizing; after all preadys
        the request is complete and ``req.result[i]`` holds bucket i's
        reduction.  On host comms without a device binding each pready runs
        the blocking allreduce (every rank must pready in the same order)."""
        self._check_state()
        from ompi_tpu_torch.mca.part.pcoll import PartitionedCollRequest

        fn = self.c_coll.get("partitioned_coll")
        handles = fn(self, "allreduce", buckets, op) \
            if fn is not None else None
        return PartitionedCollRequest(self, "allreduce", buckets, (op,),
                                      handles)

    def sendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                         sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
        """``MPI_Sendrecv_replace``: the received message overwrites the
        sent buffer (staged through a copy, like the reference).  ``buf``
        must be a writable ndarray."""
        if not isinstance(buf, np.ndarray) or not buf.flags.writeable:
            raise MpiError(ErrorClass.ERR_BUFFER,
                           "sendrecv_replace needs a writable ndarray")
        arr = np.ascontiguousarray(buf)
        st = self.sendrecv(arr.copy(), dest, arr, source, sendtag, recvtag)
        if buf is not arr:
            np.copyto(buf, arr)
        return st

    def sendrecv(self, sendbuf, dest: int, recvbuf, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
        self._check_state(dest)
        sreq = self.isend(sendbuf, dest, sendtag) if dest != PROC_NULL else None
        st = self.recv(recvbuf, source, recvtag)
        if sreq is not None:
            sreq.wait()
        return st

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
        self._check_state(source)
        return self.pml.probe(self, source, tag, blocking=True)

    def iprobe(self, source: int = ANY_SOURCE,
               tag: int = ANY_TAG) -> tuple[bool, Optional[Status]]:
        self._check_state(source)
        return self.pml.probe(self, source, tag, blocking=False)

    def mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check_state(source)
        return self.pml.mprobe(self, source, tag, blocking=True)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check_state(source)
        return self.pml.mprobe(self, source, tag, blocking=False)

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        from ompi_tpu_torch.api.request import waitall

        waitall(self.isend_obj(obj, dest, tag))

    def isend_obj(self, obj: Any, dest: int, tag: int = 0) -> list:
        """Nonblocking ``send_obj``: returns the requests to waitall (they
        keep the payload buffer alive)."""
        import pickle

        payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        hdr = np.array([payload.size], dtype=np.int64)
        return [self.isend(hdr, dest, tag), self.isend(payload, dest, tag)]

    def bcast_obj(self, obj: Any = None, root: int = 0) -> Any:
        """Broadcast an arbitrary picklable object (size agreed first)."""
        import pickle

        if self.rank == root:
            payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
            self.bcast(np.array([payload.size], np.int64), root=root)
            self.bcast(payload, root=root)
            return obj
        hdr = np.asarray(self.bcast(np.zeros(1, np.int64), root=root))
        payload = np.asarray(self.bcast(
            np.zeros(int(hdr[0]), np.uint8), root=root))
        return pickle.loads(payload.tobytes())

    def recv_obj(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Any:
        import pickle

        hdr = np.zeros(1, dtype=np.int64)
        st = self.recv(hdr, source, tag)
        payload = np.zeros(int(hdr[0]), dtype=np.uint8)
        self.recv(payload, st.source, tag)
        return pickle.loads(payload.tobytes())

    # -- process topologies (``ompi/mca/topo``) -------------------------
    def topo_test(self) -> str:
        """``MPI_Topo_test``: "cart" | "graph" | "dist_graph" |
        "undefined"."""
        if self.topo is None:
            return "undefined"
        return self.topo.kind

    def _device_world(self) -> bool:
        return self.rte is not None and self.rte.is_device_world

    def cart_create(self, dims, periods=None,
                    reorder: bool = False) -> Optional["Comm"]:
        """``MPI_Cart_create``: ranks past the grid get None
        (``MPI_COMM_NULL``).  ``reorder=True`` in the multi-process world
        orders ranks by node (the treematch mapping) when every rank knows
        its peers' nodes, decided by a collective MIN; the device world's
        rows are already in order."""
        from ompi_tpu_torch.mca.topo import CartTopo

        dims = list(dims)
        if periods is None:
            periods = [False] * len(dims)
        grid = int(np.prod(dims)) if dims else 1
        if grid > self.size:
            raise MpiError(ErrorClass.ERR_DIMS,
                           f"grid {dims} larger than comm size {self.size}")
        if self._device_world():
            color = np.array([0 if r < grid else -1
                              for r in range(self.size)])
            key = np.arange(self.size)
        else:
            color = 0 if self.rank < grid else -1
            key = self.rank
            if reorder:
                # the decision is collective: a rank with unresolved
                # locality must not fall back alone while its peers
                # reorder (grid membership would diverge)
                order = self._node_major_order()
                ok = 1 if order is not None else 0
                all_ok = int(np.asarray(self.allreduce(
                    np.array([ok], np.int64), op_mod.MIN)).ravel()[0])
                if all_ok and order is not None:
                    key = order.index(self.rank)
                    color = 0 if key < grid else -1
        sub = self.split(color, key)
        if sub is None:
            return None
        sub.topo = CartTopo(dims, periods)
        sub.name = f"{self.name}~cart"
        return sub

    def cart_map(self, dims, periods=None) -> int:
        """``MPI_Cart_map``: the rank this process would get in a reordered
        cart over ``dims``; UNDEFINED when it would be left out."""
        from ompi_tpu_torch.api.status import UNDEFINED

        dims = list(dims)
        grid = int(np.prod(dims)) if dims else 1
        if grid > self.size:
            raise MpiError(ErrorClass.ERR_DIMS,
                           f"grid {dims} larger than comm size {self.size}")
        order = self._node_major_order()
        newrank = order.index(self.rank) if order is not None else self.rank
        return newrank if newrank < grid else UNDEFINED

    def graph_map(self, index, edges) -> int:
        """``MPI_Graph_map``: the base component's identity mapping."""
        from ompi_tpu_torch.api.status import UNDEFINED

        return self.rank if self.rank < len(index) else UNDEFINED

    def _node_major_order(self) -> Optional[list]:
        """Comm ranks sorted by (node, rank); None if a node is unknown."""
        rte = self.rte
        if rte is None:
            return None
        nodes = [rte.node_of(w) for w in self.group.world_ranks]
        if any(n is None for n in nodes):
            return None
        return sorted(range(self.size), key=lambda r: (str(nodes[r]), r))

    def cart_coords(self, rank: Optional[int] = None) -> list:
        self._require_topo("cart")
        return self.topo.coords_of(self.rank if rank is None else rank)

    def cart_rank(self, coords) -> int:
        self._require_topo("cart")
        return self.topo.rank_of(coords)

    def cart_shift(self, direction: int, disp: int = 1) -> tuple:
        self._require_topo("cart")
        return self.topo.shift(self.rank, direction, disp)

    def cart_get(self) -> tuple:
        self._require_topo("cart")
        return (list(self.topo.dims), list(self.topo.periods),
                self.cart_coords())

    def cart_sub(self, remain_dims) -> Optional["Comm"]:
        """``MPI_Cart_sub``: keep the axes where ``remain_dims`` is true;
        one colour a combination of the dropped coordinates."""
        self._require_topo("cart")
        from ompi_tpu_torch.mca.topo import CartTopo

        coords = self.cart_coords()
        dropped = tuple(c for c, keep in zip(coords, remain_dims)
                        if not keep)

        def color_of(rank: int) -> int:
            c0 = 0
            for c, dim, keep in zip(self.topo.coords_of(rank),
                                    self.topo.dims, remain_dims):
                if not keep:
                    c0 = c0 * dim + c
            return c0

        if self._device_world():
            color = np.array([color_of(r) for r in range(self.size)])
            key = np.arange(self.size)
        else:
            color, key = color_of(self.rank), self.rank
        sub = self.split(color, key)
        if sub is None:
            return None
        sub.topo = CartTopo(
            [d for d, keep in zip(self.topo.dims, remain_dims) if keep],
            [p for p, keep in zip(self.topo.periods, remain_dims) if keep])
        sub.name = f"{self.name}~sub{dropped}"
        return sub

    def graph_create(self, index, edges,
                     reorder: bool = False) -> Optional["Comm"]:
        from ompi_tpu_torch.mca.topo import GraphTopo

        nnodes = len(index)
        if self._device_world():
            color = np.array([0 if r < nnodes else -1
                              for r in range(self.size)])
            key = np.arange(self.size)
        else:
            color, key = (0 if self.rank < nnodes else -1), self.rank
        sub = self.split(color, key)
        if sub is None:
            return None
        sub.topo = GraphTopo(index, edges)
        sub.name = f"{self.name}~graph"
        return sub

    def dist_graph_create_adjacent(self, sources, destinations,
                                   sourceweights=None, destweights=None,
                                   reorder: bool = False) -> "Comm":
        from ompi_tpu_torch.mca.topo import DistGraphTopo

        sub = self.dup()
        sub.topo = DistGraphTopo(sources, destinations, sourceweights,
                                 destweights)
        sub.name = f"{self.name}~distgraph"
        return sub

    def _require_topo(self, kind: str) -> None:
        if self.topo is None or self.topo.kind != kind:
            raise MpiError(ErrorClass.ERR_TOPOLOGY,
                           f"{self.name} has no {kind} topology")

    def _require_any_topo(self) -> None:
        if self.topo is None:
            raise MpiError(ErrorClass.ERR_TOPOLOGY,
                           f"{self.name} has no topology")

    # neighbor collectives (``coll_base_neighbor_*``): point-to-point over
    # the topology's (sources, destinations); reserved tags -3, -4, -6
    def neighbor_allgather(self, sendbuf) -> list:
        self._require_any_topo()
        srcs, dsts = self.topo.neighbors(self.rank)
        if self._device_world():
            # the table's leading axis indexes ranks
            return [None if s == PROC_NULL else _row_copy(sendbuf, s)
                    for s in srcs]
        arr = np.ascontiguousarray(host_buffer(sendbuf))
        reqs = [self.isend(arr, d, tag=-3) for d in dsts if d != PROC_NULL]
        out = []
        for s in srcs:
            if s == PROC_NULL:
                out.append(None)
            else:
                buf = np.empty_like(arr)
                self.recv(buf, s, tag=-3)
                out.append(buf)
        from ompi_tpu_torch.api.request import waitall

        waitall(reqs)
        return out

    def _device_channels(self) -> dict:
        """The device world's (src, dst) channels: ``sendbufs[r][k]`` is
        rank r's block for its k-th destination, and each channel queues
        its blocks' k, paired with inbound slots FIFO (the per-source order
        message passing gives, right even where a neighbor appears
        twice)."""
        from collections import defaultdict, deque

        chan: dict = defaultdict(deque)
        for r in range(self.size):
            _, r_dsts = self.topo.neighbors(r)
            for k, d in enumerate(r_dsts):
                if d != PROC_NULL:
                    chan[(r, d)].append(k)
        return chan

    def neighbor_alltoall(self, sendbufs) -> list:
        self._require_any_topo()
        srcs, dsts = self.topo.neighbors(self.rank)
        if self._device_world():
            chan = self._device_channels()
            return [None if s == PROC_NULL else _row_copy(
                        sendbufs[s], chan[(s, self.rank)].popleft())
                    for s in srcs]
        if len(sendbufs) != len(dsts):
            raise MpiError(ErrorClass.ERR_ARG,
                           f"need {len(dsts)} send buffers, got "
                           f"{len(sendbufs)}")
        reqs = []
        template = None  # every block has one size (MPI neighbor semantics)
        for d, buf in zip(dsts, sendbufs):
            if d != PROC_NULL:
                arr = np.ascontiguousarray(host_buffer(buf))
                template = arr
                reqs.append(self.isend(arr, d, tag=-4))
        out = []
        for s in srcs:
            if s == PROC_NULL:
                out.append(None)
            elif template is None:
                raise MpiError(ErrorClass.ERR_ARG,
                               "cannot size receive blocks: no real "
                               "destination buffer to mirror")
            else:
                buf = np.empty_like(template)
                self.recv(buf, s, tag=-4)
                out.append(buf)
        from ompi_tpu_torch.api.request import waitall

        waitall(reqs)
        return out

    # the v/w forms: per-neighbor sizes (and dtypes for w) ride the object
    # channel, FIFO per (src, dst) pair like the fixed-size forms
    def neighbor_allgatherv(self, sendbuf) -> list:
        self._require_any_topo()
        srcs, dsts = self.topo.neighbors(self.rank)
        if self._device_world():
            # table[r] is rank r's buffer, of any size
            return [None if s == PROC_NULL else _row_copy(sendbuf, s)
                    for s in srcs]
        from ompi_tpu_torch.api.request import waitall

        arr = np.ascontiguousarray(host_buffer(sendbuf))
        reqs = [r for d in dsts if d != PROC_NULL
                for r in self.isend_obj(arr, d, tag=-6)]
        out = [None if s == PROC_NULL else self.recv_obj(s, tag=-6)
               for s in srcs]
        waitall(reqs)
        return out

    def neighbor_alltoallv(self, sendbufs) -> list:
        self._require_any_topo()
        srcs, dsts = self.topo.neighbors(self.rank)
        if self._device_world():
            chan = self._device_channels()
            return [None if s == PROC_NULL else _row_copy(
                        sendbufs[s], chan[(s, self.rank)].popleft())
                    for s in srcs]
        if len(sendbufs) != len(dsts):
            raise MpiError(ErrorClass.ERR_ARG,
                           f"need {len(dsts)} send buffers, got "
                           f"{len(sendbufs)}")
        from ompi_tpu_torch.api.request import waitall

        reqs = [r for b, d in zip(sendbufs, dsts) if d != PROC_NULL
                for r in self.isend_obj(
                    np.ascontiguousarray(host_buffer(b)), d, tag=-6)]
        out = [None if s == PROC_NULL else self.recv_obj(s, tag=-6)
               for s in srcs]
        waitall(reqs)
        return out

    def neighbor_alltoallw(self, sendbufs, recvtypes=None) -> list:
        """Per-neighbor buffers AND per-neighbor receive dtypes (numpy
        blocks only)."""
        out = self.neighbor_alltoallv(sendbufs)
        if recvtypes is None:
            return out
        typed = []
        for j, b in enumerate(out):
            if b is None:
                typed.append(None)
                continue
            rt_ = recvtypes[j] if isinstance(recvtypes, (list, tuple)) \
                else recvtypes
            typed.append(np.ascontiguousarray(b).reshape(-1)
                         .view(np.uint8).view(np.dtype(rt_)))
        return typed

    # -- dynamic process management (``ompi/dpm``) -----------------------
    def spawn(self, command, maxprocs: int, root: int = 0) -> "Comm":
        from ompi_tpu_torch import dpm

        return dpm.spawn(self, command, maxprocs, root)

    def spawn_multiple(self, commands, maxprocs, root: int = 0) -> "Comm":
        from ompi_tpu_torch import dpm

        return dpm.spawn_multiple(self, commands, maxprocs, root)

    def create_intercomm(self, local_leader: int, bridge_comm: "Comm",
                         remote_leader: int, tag: int = 0) -> "Comm":
        """``MPI_Intercomm_create``: join two disjoint comms into an
        intercommunicator through leaders that share ``bridge_comm``
        (``ompi/communicator/comm.c`` ``ompi_intercomm_create``).

        The leaders exchange membership and a proposed CID over the bridge
        (MAX wins), then EVERY member of both groups confirms the winner is
        locally free (per-process CID bitmaps diverge); on a conflict both
        sides re-propose above it."""
        from ompi_tpu_torch.runtime import init as rt

        self._check_state()
        btag = -(1 << 22) - (int(tag) % (1 << 20))
        remote = None
        floor = 0
        while True:
            if self.rank == local_leader:
                proposed = rt.candidate_cid(floor)
                bridge_comm.send_obj(
                    {"cid": proposed,
                     "ranks": list(self.group.world_ranks)},
                    remote_leader, tag=btag)
                theirs = bridge_comm.recv_obj(remote_leader, tag=btag)
                payload = {"cid": max(int(proposed), int(theirs["cid"])),
                           "remote": theirs["ranks"]}
            else:
                payload = None
            payload = self.bcast_obj(payload, root=local_leader)
            cid = int(payload["cid"])
            remote = payload["remote"]
            ok = 1 if rt.is_cid_free(cid) else 0
            grp_ok = int(np.asarray(self.allreduce(
                np.array([ok], np.int64), op_mod.MIN)).ravel()[0])
            if self.rank == local_leader:
                bridge_comm.send_obj(grp_ok, remote_leader, tag=btag)
                their_ok = int(bridge_comm.recv_obj(remote_leader,
                                                    tag=btag))
                both = min(grp_ok, their_ok)
            else:
                both = None
            both = int(self.bcast_obj(both, root=local_leader))
            if both:
                break
            floor = cid + 1
        rt.reserve_cid(cid)
        inter = Comm(self.group, cid, self.rte, name=f"{self.name}~inter",
                     epoch=self.epoch, parent=self,
                     remote_group=Group([int(r) for r in remote]))
        inter.local_comm = self
        self._finish_create(inter)
        return inter

    def accept(self, port: str, root: int = 0) -> "Comm":
        from ompi_tpu_torch import dpm

        return dpm.accept(self, port, root)

    def connect(self, port: str, root: int = 0) -> "Comm":
        from ompi_tpu_torch import dpm

        return dpm.connect(self, port, root)

    def merge(self, high: bool = False) -> "Comm":
        from ompi_tpu_torch import dpm

        return dpm.merge(self, high)

    # -- ULFM (``ompi/mpiext/ftmpi``) ------------------------------------
    def revoke(self) -> None:
        from ompi_tpu_torch.ft import revoke as ft_revoke

        ft_revoke.revoke(self)

    def shrink(self) -> "Comm":
        from ompi_tpu_torch.ft import shrink as ft_shrink

        return ft_shrink.shrink(self)

    def get_failed(self) -> Group:
        failed = [r for r in self.group.world_ranks
                  if _ft_state().is_failed(r)]
        return Group(failed)

    def ack_failed(self, num_to_ack: Optional[int] = None) -> int:
        """``MPIX_Comm_ack_failed``: acknowledged ranks stop tripping
        ``agree`` into ProcFailedError.  Returns the number acknowledged."""
        failed = [r for r in self.group.world_ranks
                  if _ft_state().is_failed(r)]
        if num_to_ack is not None:
            failed = failed[:num_to_ack]
        self._acked_failed = frozenset(failed) | getattr(
            self, "_acked_failed", frozenset())
        return len(self._acked_failed)

    @property
    def ft_scope(self) -> str:
        """Revocation scope: job-local CIDs are scoped to the job; bridge
        CIDs (>= 2^20) share one scope."""
        if self.cid >= (1 << 20):
            return "#bridge"
        return str(getattr(self.rte, "job", "0"))

    def is_revoked(self) -> bool:
        if not self.revoked:
            # the hot path (every _check_state): a prebuilt key and the
            # cached module reference, one set-membership probe
            key = self._rev_key
            if key is None:
                key = self._rev_key = (self.ft_scope, self.cid, self.epoch)
            if _ft_state().is_revoked_key(key):
                self.revoked = True
        return self.revoked

    def release_coll_modules(self) -> None:
        """Tear down per-comm coll module state (``free``, and runtime
        finalize for the comms the user never frees): each module's
        ``comm_unquery`` runs (coll/han frees its sub-communicators), as
        the reference's ``release_coll_modules`` does."""
        for mod in self.coll_modules:
            close = getattr(mod, "comm_unquery", None)
            if close is not None:
                try:
                    close(self)
                except Exception:
                    pass
        self.coll_modules = []
        self.c_coll = {}

    def __repr__(self) -> str:
        return (f"Comm({self.name}, cid={self.cid}, rank={self.rank}/"
                f"{self.size})")
