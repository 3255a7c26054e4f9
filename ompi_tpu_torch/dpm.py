"""dpm — dynamic process management (spawn / connect / accept / merge).

Copy of ``ompi_tpu/dpm.py`` (after the reference's ``ompi/dpm/dpm.c``,
which spawns through ``PMIx_Spawn``: the launcher execs the children, the
children PMIx_Init back, and both sides build an intercommunicator over
agreed CIDs).  Here the coordination service plays PMIx: ``spawn``
allocates fresh *global* world ranks and the launcher (``tpurun``) execs
the children as a job of their own with their own COMM_WORLD; parent and
children meet through the coordination KV, and an intercommunicator is
built from the published groups.

Cross-job CIDs come from the coordination service's atomic counter in a
reserved high range (``comm_cid.c``'s agreement cannot run before the
bridge exists; the reference's next_cid exchange over the bridge is the
same decision made central).  The root's spawn waits for every child's
``__spawn_join__`` key (``otpu_dpm_spawn_timeout``) and gives the bridge
CID back on a short allocation, a join timeout or a child that dies in its
join (ERR_SPAWN on every rank).

With ULFM's shrink this closes the recovery loop: shrink (degrade), spawn
(replace), merge (a full-size world again).  The port's entry points that
boot a world (``get_parent``, ``join``, ``open_port`` and the name service
without a comm) run on the card unless the caller's world is already up
(``init(device="cpu")`` first on the CPU lane).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ompi_tpu_torch.api.comm import Comm
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.group import Group
from ompi_tpu_torch.base.var import VarType, registry

# cross-job CIDs live far above any locally-agreed CID
_DPM_CID_BASE = 1 << 20

_spawn_timeout_var = registry.register(
    "dpm", None, "spawn_timeout", vtype=VarType.FLOAT, default=60.0,
    help="Seconds MPI_Comm_spawn waits for every child rank to join the "
         "runtime (the __spawn_join__ handshake) before releasing the "
         "allocated CID and raising ERR_SPAWN — a child that dies during "
         "boot must produce a loud error, not a half-built "
         "intercommunicator")


def _client(comm) -> object:
    client = getattr(comm.rte, "client", None)
    if client is None:
        raise MpiError(ErrorClass.ERR_UNSUPPORTED_OPERATION,
                       "dynamic process management needs the coordination "
                       "service (run under tpurun)")
    return client


def _new_bridge_cid(client) -> int:
    return _DPM_CID_BASE + client.fetch_add(-1, "__dpm_cid__", 1)


def _make_intercomm(comm, cid: int, remote_ranks: Sequence[int],
                    name: str) -> Comm:
    from ompi_tpu_torch.runtime import init as rt

    # bridge comms pin epoch 0: the two sides' local epochs can differ
    # (e.g. spawn from a shrunk comm), and the revocation key
    # (scope, cid, epoch) must match across jobs — bridge CIDs are
    # globally unique so the epoch carries no extra information
    inter = Comm(comm.group, cid, comm.rte, name=name, epoch=0,
                 parent=comm, remote_group=Group(list(remote_ranks)))
    inter.local_comm = comm       # local-side collective channel (merge)
    rt.reserve_cid(cid)
    comm._finish_create(inter)
    return inter


def _await_spawn_join(client, ranks: Sequence[int], job: str,
                      timeout: float) -> None:
    """Block until every spawned rank published its ``__spawn_join__``
    marker (done by ``ProcRte.__init__`` as soon as the child's coord
    connection is up).  A child that died during boot (the launcher's
    proc_failed report lands in the local ft state) or never joined
    within ``timeout`` raises a loud ERR_SPAWN — the half-built-
    intercommunicator hang this replaces."""
    import time as _time

    from ompi_tpu_torch.ft import state as ft_state

    deadline = _time.monotonic() + timeout
    for r in ranks:
        while True:
            if ft_state.is_failed(r):
                raise MpiError(
                    ErrorClass.ERR_SPAWN,
                    f"spawned rank {r} (job {job}) died during join — "
                    "the child process exited before reaching the "
                    "runtime")
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise MpiError(
                    ErrorClass.ERR_SPAWN,
                    f"spawned rank {r} (job {job}) did not join within "
                    f"{timeout:g}s (otpu_dpm_spawn_timeout); aborting "
                    "the spawn instead of leaving a half-built "
                    "intercommunicator")
            # short sub-waits keep the died-during-join check live while
            # a slow child is still booting
            got = client.get(r, f"__spawn_join__:{job}", wait=True,
                             timeout=min(1.0, remaining))
            if got is not None:
                break


def _spawn_at_root(comm, cmd, total: int):
    """Root-side spawn: allocate the bridge CID, launch, and run the
    join handshake.  On ANY failure the reserved-but-never-used CID is
    released again (the children can only adopt it after completing the
    join, so no peer can hold a communicator on it)."""
    from ompi_tpu_torch.runtime import init as rt

    client = _client(comm)
    cid = _new_bridge_cid(client)
    # hold the cid locally from allocation on: a concurrent local
    # create must not collide with it while the children are joining
    rt.reserve_cid(cid)
    try:
        parent_ranks = ",".join(str(w) for w in comm.group.world_ranks)
        ranks, job = client.spawn(
            cmd, total,
            env={"OTPU_PARENT_RANKS": parent_ranks,
                 "OTPU_PARENT_CID": str(cid)})
        if len(ranks) != total:
            raise MpiError(
                ErrorClass.ERR_SPAWN,
                f"launcher allocated {len(ranks)} of {total} requested "
                "ranks — aborting the spawn instead of building a "
                "short-sized intercommunicator")
        _await_spawn_join(client, ranks, job,
                          float(_spawn_timeout_var.value or 60.0))
        return cid, ranks, job
    except BaseException:
        rt.release_cid(cid)
        raise


def _job_seq(job: str) -> int:
    """Numeric tail of a coord job id ('job3' -> 3; -1 if unparsable)."""
    tail = str(job).removeprefix("job")
    return int(tail) if tail.isdigit() else -1


def _spawn_common(comm, cmd, total: int, root: int, name: str) -> Comm:
    """Shared body of spawn / spawn_multiple: root launches + joins,
    the sentinel bcast tells non-roots success or failure, and the
    intercommunicator carries ``spawn_job`` (the coord job id, whose
    ``mpi://job/<id>`` pset names the children)."""
    comm._check_state()
    info = np.zeros(3 + total, np.int64)
    err = None
    if comm.rank == root:
        try:
            cid, ranks, job = _spawn_at_root(comm, cmd, total)
            info[0] = cid
            info[1] = total
            info[2] = _job_seq(job)
            info[3:3 + total] = ranks
        except Exception as exc:
            # error sentinel: non-roots are already blocked in the bcast
            # and must learn the spawn failed rather than hang
            err = exc
            info[0] = -1
    info = np.asarray(comm.bcast(info, root=root))
    if int(info[0]) < 0:
        if err is not None:
            raise err
        raise MpiError(ErrorClass.ERR_SPAWN, f"{name} failed at root")
    children = [int(r) for r in info[3:3 + int(info[1])]]
    inter = _make_intercomm(comm, int(info[0]), children,
                            name=f"{comm.name}~{name}")
    seq = int(info[2])
    inter.spawn_job = f"job{seq}" if seq >= 0 else None
    return inter


def spawn(comm, command: Sequence[str], maxprocs: int,
          root: int = 0) -> Comm:
    """``MPI_Comm_spawn``: launch ``maxprocs`` new ranks running
    ``command``; returns the parent↔children intercommunicator.

    Collective over ``comm``.  Children find their side via
    ``get_parent()``.  The root waits for every child's join handshake
    before the intercomm exists anywhere; a child dying during boot (or
    a short rank allocation) releases the bridge CID and raises
    ERR_SPAWN on all ranks.
    """
    return _spawn_common(comm, list(command), int(maxprocs), root, "spawn")


def spawn_multiple(comm, commands: Sequence[Sequence[str]],
                   maxprocs: Sequence[int], root: int = 0) -> Comm:
    """``MPI_Comm_spawn_multiple``: one child WORLD running several
    executables — child ranks [0, maxprocs[0]) run commands[0], the next
    maxprocs[1] run commands[1], ... (``ompi/mpi/c/comm_spawn_multiple.c``
    semantics).  Returns the parent↔children intercommunicator."""
    if len(commands) != len(maxprocs):
        raise MpiError(ErrorClass.ERR_ARG,
                       f"{len(commands)} commands vs {len(maxprocs)} counts")
    per_rank: list = []
    for cmd, cnt in zip(commands, maxprocs):
        per_rank.extend([list(cmd)] * int(cnt))
    return _spawn_common(comm, per_rank, len(per_rank), root, "spawnm")


def join(fd) -> Comm:
    """``MPI_Comm_join``: build the 1x1 intercommunicator with whatever
    process sits at the other end of the connected socket ``fd``
    (``ompi/dpm/dpm.c`` ``ompi_dpm_dyn_init`` join path).

    The socket carries only the rendezvous (a port name, like the
    reference exchanges port strings over it); the intercomm itself is
    wired through the coordination service, so both processes must
    belong to the same coordination domain (same ``OTPU_COORD``).
    """
    import socket as _socket

    from ompi_tpu_torch.runtime import init as rt

    self_comm = rt.comm_self()
    sock = (fd if isinstance(fd, _socket.socket)
            else _socket.socket(fileno=fd))
    try:
        # deterministic role election: both send their world rank
        me = self_comm.rte.my_world_rank
        sock.sendall(int(me).to_bytes(8, "big"))
        other = int.from_bytes(_recv_exact(sock, 8), "big")
        if me == other:
            raise MpiError(ErrorClass.ERR_INTERN,
                           "join requires two distinct processes")
        if me < other:
            port = open_port(self_comm)
            blob = port.encode()
            sock.sendall(len(blob).to_bytes(4, "big") + blob)
            return accept(self_comm, port)
        n = int.from_bytes(_recv_exact(sock, 4), "big")
        port = _recv_exact(sock, n).decode()
        return connect(self_comm, port)
    finally:
        if not isinstance(fd, _socket.socket):
            sock.detach()   # the caller still owns the raw fd


def _recv_exact(sock, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise MpiError(ErrorClass.ERR_INTERN,
                           "join peer closed the socket")
        out += chunk
    return out


_parent_intercomm: Optional[Comm] = None


def get_parent(device=None) -> Optional[Comm]:
    """``MPI_Comm_get_parent``: the spawned side of the bridge (None in a
    job that was not spawned).  Initializes the world if it is not up
    (on ``device``: the card unless the caller names another)."""
    global _parent_intercomm
    if _parent_intercomm is not None:
        return _parent_intercomm
    from ompi_tpu_torch.runtime import init as rt

    world = rt.init(device=device)
    rte = world.rte
    parent_ranks = getattr(rte, "parent_ranks", None)
    if not parent_ranks:
        return None
    cid = int(getattr(rte, "parent_cid", -1))
    if cid < 0:
        return None
    _parent_intercomm = _make_intercomm(
        world, cid, parent_ranks, name="parent~spawn")
    return _parent_intercomm


# -- connect / accept (MPI_Open_port / MPI_Comm_accept / MPI_Comm_connect)

def open_port(comm=None) -> str:
    """Generate a unique port name for accept/connect."""
    from ompi_tpu_torch.runtime import init as rt

    comm = comm or rt.comm_world()
    client = _client(comm)
    seq = client.fetch_add(-1, "__dpm_port_seq__", 1)
    return f"otpu-port-{seq}"


def publish_name(service: str, port: str, comm=None) -> None:
    """``MPI_Publish_name``: bind a service name to a port so an unrelated
    job can find it (``ompi/mpi/c/publish_name.c`` — PMIx publish)."""
    from ompi_tpu_torch.runtime import init as rt

    client = _client(comm or rt.comm_world())
    existing = client.put_new(-1, f"__dpm_svc_{service}__", port)
    if existing is not None and existing != port:
        raise MpiError(ErrorClass.ERR_NAME,
                       f"service {service!r} already published")


def lookup_name(service: str, comm=None, wait: bool = False) -> str:
    """``MPI_Lookup_name``: resolve a published service name to a port."""
    from ompi_tpu_torch.runtime import init as rt

    client = _client(comm or rt.comm_world())
    port = client.get(-1, f"__dpm_svc_{service}__", wait=wait)
    if port is None:
        raise MpiError(ErrorClass.ERR_NAME,
                       f"service {service!r} not published")
    return port


def unpublish_name(service: str, comm=None) -> None:
    """``MPI_Unpublish_name``."""
    from ompi_tpu_torch.runtime import init as rt

    client = _client(comm or rt.comm_world())
    client.delete(-1, f"__dpm_svc_{service}__")


def accept(comm, port: str, root: int = 0) -> Comm:
    """Collective: publish our group under ``port`` and wait for a
    connector; returns the intercommunicator."""
    comm._check_state()
    info = np.zeros(1, np.int64)
    if comm.rank == root:
        client = _client(comm)
        cid = _new_bridge_cid(client)
        client.put(-1, f"__dpm_accept__:{port}",
                   {"cid": cid, "ranks": list(comm.group.world_ranks)})
        other = None
        while other is None:   # block past the KV's 60 s get timeout
            other = client.get(-1, f"__dpm_connect__:{port}", wait=True)
        # consume the pairing: a later accept on this port must wait for
        # a NEW connector, not pair with this stale one
        client.delete(-1, f"__dpm_accept__:{port}")
        client.delete(-1, f"__dpm_connect__:{port}")
        info[0] = cid
        remote = other["ranks"]
    else:
        remote = None
    info = np.asarray(comm.bcast(info, root=root))
    remote = _bcast_obj(comm, remote, root)
    return _make_intercomm(comm, int(info[0]), remote,
                           name=f"{comm.name}~accept")


def connect(comm, port: str, root: int = 0) -> Comm:
    """Collective: join the acceptor publishing ``port``."""
    comm._check_state()
    info = np.zeros(1, np.int64)
    if comm.rank == root:
        client = _client(comm)
        token = client.fetch_add(-1, "__dpm_conn_seq__", 1)
        while True:
            other = None
            while other is None:   # block past the KV's 60 s get timeout
                other = client.get(-1, f"__dpm_accept__:{port}", wait=True)
            # first connector wins the pairing (put_new is atomic); a
            # loser waits for the acceptor to consume the pair and
            # retries against the NEXT accept on this port
            mine = {"ranks": list(comm.group.world_ranks), "token": token}
            got = client.put_new(-1, f"__dpm_connect__:{port}", mine)
            if got.get("token") == token:
                break
            import time as _time

            while client.get(-1, f"__dpm_connect__:{port}",
                             wait=False) is not None:
                _time.sleep(0.01)
        info[0] = other["cid"]
        remote = other["ranks"]
    else:
        remote = None
    info = np.asarray(comm.bcast(info, root=root))
    remote = _bcast_obj(comm, remote, root)
    return _make_intercomm(comm, int(info[0]), remote,
                           name=f"{comm.name}~connect")


def _bcast_obj(comm, obj, root: int):
    """Broadcast a small picklable object over the comm."""
    import pickle

    if comm.size == 1:
        return obj
    if comm.rank == root:
        payload = np.frombuffer(pickle.dumps(obj), np.uint8)
        comm.bcast(np.array([payload.size], np.int64), root=root)
        comm.bcast(payload, root=root)
        return obj
    n = int(np.asarray(comm.bcast(np.zeros(1, np.int64), root=root))[0])
    payload = np.asarray(comm.bcast(np.zeros(n, np.uint8), root=root))
    return pickle.loads(payload.tobytes())


def merge(intercomm, high: bool = False) -> Comm:
    """``MPI_Intercomm_merge``: one intracommunicator over both groups.

    The ``high=False`` group's ranks come first.  Collective over the
    intercommunicator; the low side's root allocates the merged CID and
    bridges it to the high side's root over intercomm p2p.
    """
    if not intercomm.is_inter:
        raise MpiError(ErrorClass.ERR_COMM, "merge needs an intercomm")
    local = getattr(intercomm, "local_comm", None)
    if local is None:
        raise MpiError(ErrorClass.ERR_COMM,
                       "intercomm carries no local collective channel")
    from ompi_tpu_torch.runtime import init as rt

    client = _client(intercomm)
    # deterministic CID allocator: the group containing the smaller world
    # rank allocates and bridges it over (`high` only orders ranks, below)
    my_min = min(intercomm.group.world_ranks)
    other_min = min(intercomm.remote_group.world_ranks)
    i_am_low = my_min < other_min
    buf = np.zeros(1, np.int64)
    if i_am_low:
        if local.rank == 0:
            buf[0] = _new_bridge_cid(client)
            intercomm.send(buf, 0, tag=-7)
    else:
        if local.rank == 0:
            intercomm.recv(buf, 0, tag=-7)
    cid = int(np.asarray(local.bcast(buf, root=0))[0])
    # merged rank order: the group that passed high=False first; both
    # sides must agree, so order by (my `high` flag exchanged via minimum
    # world rank convention): low-world-rank group first unless IT set
    # high=True — exchange the flags over the bridge
    flag = np.array([1 if high else 0], np.int64)
    oflag = np.zeros(1, np.int64)
    if local.rank == 0:
        if i_am_low:
            intercomm.send(flag, 0, tag=-8)
            intercomm.recv(oflag, 0, tag=-8)
        else:
            intercomm.recv(oflag, 0, tag=-8)
            intercomm.send(flag, 0, tag=-8)
    oflag = np.asarray(local.bcast(oflag, root=0))
    mine = list(intercomm.group.world_ranks)
    theirs = list(intercomm.remote_group.world_ranks)
    if int(flag[0]) == int(oflag[0]):
        # same flag: low-world-rank group first (MPI leaves it undefined;
        # this is the reference's deterministic tie-break)
        first = mine if my_min < other_min else theirs
    else:
        first = theirs if high else mine
    second = theirs if first is mine else mine
    merged = Comm(Group(first + second), cid, intercomm.rte,
                  name=f"{intercomm.name}~merge", epoch=0,
                  parent=local)
    rt.reserve_cid(cid)
    local._finish_create(merged)
    return merged
