"""tpurun — the mpirun-equivalent launcher.

Copy of the local launch of ``ompi_tpu/tools/tpurun.py`` (the reference's
``mpirun`` is PRRTE's ``prte``: it launches processes and gives them a PMIx
server).  tpurun starts the coordination service
(``ompi_tpu_torch.rte.coord.CoordServer``) in this process, spawns N ranks
with their identity in the environment (``OTPU_RANK``, ``OTPU_NPROCS``,
``OTPU_COORD``; ``--mca NAME VALUE`` becomes ``OTPU_MCA_<name>``), streams
their output with rank prefixes, and tears the job down on the first
failure with that rank's exit code (mpirun's kill-job-on-abort).  The
launcher imports neither torch nor CUDA: each rank binds its own device.

Run: ``python -m ompi_tpu_torch.tools.tpurun -n 4 python -m
ompi_tpu_torch.examples.ring`` (add ``--device cpu`` to the ring's
arguments on a machine without a card).

``--fake-nodes K`` partitions the ranks into K emulated nodes
(``OTPU_NODE_ID=node<rank*K//n>`` for each rank) so that coll/han's
hierarchy runs on one host, as ``mpirun --oversubscribe`` tests han:
btl/sm carries the traffic within a node and btl/tcp between nodes.

At the job's end the launcher merges what the ranks published into the
coordination service at their finalize (``tpurun.py:177-253``): the trace
payloads into one clock-aligned timeline, ``<trace_dir>/trace_merged.json``
(``otpu-trace/`` by default), with a skew report, ``trace_skew.txt``,
beside it, the monitoring matrices into one job-wide table on stderr, and
the flight recorder's dumps (``tpurun.py:253-305``): every dump a rank
published under the ``otpu_flight`` key (a chaos-killed rank's, an
aborting rank's, a survivor's post-mortem) with the coordination service's
own ``flight_view``, clock-aligned into ``<otpu_flight_dir>/bundle.json``
(``otpu-crash/`` by default).

``--enable-recovery`` is ULFM's mode (``tpurun.py:128-175``, ``:725-737``,
mpirun's ``--enable-recovery``): a rank that dies is reported once, as a
``proc_failed`` event the coordination service publishes (its fences then
count the rank as arrived), and the job runs on; it fails only if no rank
ran to a clean exit.  The ranks' ``ft_*`` vars (``--mca ft_detector 1``,
``ft_detector_period``, ``ft_detector_timeout``) arm the heartbeat ring.

Process sets (``tpurun.py:83-108``, ``:540-560``): the launcher publishes
``mpi://WORLD``, one ``mpi://host/<node>`` set a node (the ``--fake-nodes``
partition, else the host name) and each ``--pset NAME:RANKS`` (a comma list
with ranges, ``workers:0,2-3``) into the coordination service, where a
Session lists them before any communicator exists.  Spawn
(``tpurun.py:637-661``): the launcher registers the coordination service's
spawn handler, which starts the new global ranks as a job of their own
(``OTPU_JOB``, ``OTPU_JOB_RANKS``, ``OTPU_NPROCS`` its size, the parent's
ranks and bridge CID) with the job's environment, one argv for every rank
or one a rank (``spawn_multiple``), and the fake-node id ``rank % K``.

Multi-host launch (``tpurun.py:34-83``, ``:322-411``, ``:540-720``),
composed the way mpirun's ssh plm is: ``--hostfile H`` (``host
[slots=N]`` lines, ``#`` comments) assigns the ranks to the hosts byslot
(``--oversubscribe`` wraps around once the slots are full), binds the
coordination service to every interface when a host is remote (advertising
``--coord-host`` or this host's address) and drives one *child launcher*
per host through the launch agent (``--launch-agent``, default ``ssh -o
BatchMode=yes``): ``<agent> <host> "cd <wdir> && <python> -m
ompi_tpu_torch.tools.tpurun --child-of HEAD:PORT --ranks 4,5,... -n N
--node-id <host> -- cmd"``.  The child's identity rides flags, not the
environment (ssh forwards none).  ``--launch-agent local`` runs the child
launchers as plain subprocesses here: the same head/child protocol without
sshd, one emulated node a hostfile entry.  A child launcher
(``_child_main``) spawns its ranks with ``OTPU_COORD`` pointing at the
head, prefixes their output, and mirrors the head's failure policy: the
first failure ends its group (the head then sees its exit code), or under
``--enable-recovery`` it publishes each death as a ``proc_failed`` event
and runs on.

``--bind-to core`` binds each rank to a contiguous block of the host's
allowed cores (``OTPU_BIND_POLICY``, ``OTPU_LOCAL_NRANKS``: the ranks on
that host; the instance's boot applies ``base/hwloc.py``'s partition).

``--device-world`` boots the multi-process device world in every rank
(``OTPU_DEVICE_WORLD=1``): the launcher picks a free port on the host
where rank 0 runs, with a plain socket as the reference's ``_free_port``
does, and publishes ``host:port`` under the coordination service's
``DIST_COORD_KEY``; each rank's instance joins ``torch.distributed``'s
gloo group there.  ``--local-devices K`` sets ``OTPU_MCA_rte_virtual_ranks=K``
in every rank, the port's counterpart of the reference's virtual device
count.  The launcher itself stays free of torch.

``--router-ranks`` and ``--worker-ranks`` publish the serving role psets
``mpi://serving/router`` and ``mpi://serving/workers``
(``ompi_tpu_torch.serving.roles`` resolves placement from them), and each
``--pool MODEL:RANKS`` publishes one fleet pool pset
``mpi://serving/pool/<MODEL>``
(``ompi_tpu_torch.serving.fleet.pool_specs_from_psets`` resolves the pool
tables from them).

Not copied: ``--with-tpu``, which keeps a TPU attach hook in the ranks'
environment (the port's ranks see the card already, and there is no such
hook to strip).
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import threading
import time

def _parse_hostfile(path: str) -> list:
    """mpirun hostfile lines: ``host [slots=N]``; # comments."""
    hosts = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for tok in parts[1:]:
                if tok.startswith("slots="):
                    slots = int(tok.split("=", 1)[1])
            hosts.append((parts[0], slots))
    if not hosts:
        raise SystemExit(f"tpurun: hostfile {path!r} lists no hosts")
    return hosts


def _assign_ranks(hosts: list, nprocs: int, oversubscribe: bool) -> list:
    """Byslot assignment (mpirun's default mapping policy): fill each
    host's slots in hostfile order; ``--oversubscribe`` wraps around."""
    total = sum(s for _, s in hosts)
    if total == 0:
        raise SystemExit("tpurun: hostfile has zero total slots")
    if nprocs > total and not oversubscribe:
        raise SystemExit(
            f"tpurun: {nprocs} ranks exceed {total} hostfile slots "
            "(use --oversubscribe, like mpirun)")
    out = [[] for _ in hosts]
    r = 0
    while r < nprocs:
        for i, (_, slots) in enumerate(hosts):
            take = min(slots, nprocs - r)
            out[i].extend(range(r, r + take))
            r += take
            if r >= nprocs:
                break
    return out


_LOCAL_NAMES = ("localhost", "127.0.0.1", "::1")


def _is_local_host(host: str) -> bool:
    return (host in _LOCAL_NAMES or host == socket.gethostname()
            or host == socket.getfqdn())


def _free_port(host: str = "127.0.0.1") -> int:
    """A currently free TCP port for the device world's rendezvous
    (bind and release: the window until rank 0 binds it is short, and a
    collision fails loudly at the group's boot).  For a rank 0 on another
    host the probe can only sample this host's ports, as in the
    reference."""
    s = socket.socket()
    try:
        try:
            s.bind((host if host != "0.0.0.0" else "", 0))
        except OSError:
            s.bind(("", 0))    # a remote rank-0 host: probe locally
        return s.getsockname()[1]
    finally:
        s.close()


def _pkg_root() -> str:
    import ompi_tpu_torch as _pkg

    return os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))


def _rank_env(env_base: dict, args) -> dict:
    """The job-wide environment of the ranks from the flags that a child
    launcher receives too: PYTHONPATH (appended: the user's own entries
    keep shadowing rights), the device world, the --mca values."""
    env = dict(env_base)
    root = _pkg_root()
    env["PYTHONPATH"] = (env["PYTHONPATH"] + os.pathsep + root
                         if env.get("PYTHONPATH") else root)
    env["OTPU_NPROCS"] = str(args.nprocs)
    if args.device_world:
        env["OTPU_DEVICE_WORLD"] = "1"
        if args.local_devices > 0:
            env["OTPU_MCA_rte_virtual_ranks"] = str(args.local_devices)
    for name, value in args.mca:
        env["OTPU_MCA_" + name.removeprefix("otpu_")] = value
    return env


def _parse_pset(spec: str, nprocs: int) -> tuple:
    """``--pset NAME:RANKS`` → (name, [ranks]); RANKS is a comma list
    with ranges, e.g. ``workers:0,2-3``."""
    name, sep, ranks_s = spec.partition(":")
    if not sep or not name or not ranks_s:
        raise SystemExit(f"tpurun: bad --pset {spec!r} "
                         "(expected NAME:RANKS, e.g. workers:0,2-3)")
    ranks: list = []
    for tok in ranks_s.split(","):
        a, dash, b = tok.partition("-")
        try:
            lo = int(a)
            hi = int(b) if dash else lo
        except ValueError:
            raise SystemExit(f"tpurun: bad rank token {tok!r} in "
                             f"--pset {spec!r}")
        if hi < lo:
            raise SystemExit(f"tpurun: reversed range {tok!r} in "
                             f"--pset {spec!r}")
        ranks.extend(range(lo, hi + 1))
    bad = [r for r in ranks if not 0 <= r < nprocs]
    if bad or len(set(ranks)) != len(ranks):
        raise SystemExit(f"tpurun: --pset {spec!r} ranks invalid for a "
                         f"{nprocs}-rank job")
    return name, ranks


def _monitor(procs_list, rank_of, *, enable_recovery: bool = False,
             label: str = "tpurun", on_fail=None, abort_check=None) -> int:
    """Poll the ranks (``ompi_tpu/tools/tpurun.py:_monitor``): without
    recovery the first nonzero exit ends the job with that code; with
    recovery each death is reported once via ``on_fail(rank, rc)`` and the
    job keeps running (it fails only if no rank succeeded).
    ``abort_check()`` may return an exit code for an out-of-band abort
    (the coordination service's MPI_Abort)."""
    exit_code = 0
    reported: set = set()
    try:
        while True:
            snapshot = list(procs_list)
            alive = [p for p in snapshot if p.poll() is None]
            failed = [p for p in snapshot
                      if p.poll() is not None and p.returncode != 0]
            if abort_check is not None:
                code = abort_check()
                if code is not None:
                    exit_code = code
                    break
            if failed:
                if enable_recovery:
                    for p in failed:
                        rank = rank_of(p)
                        if rank not in reported:
                            reported.add(rank)
                            print(f"{label}: rank {rank} failed (exit "
                                  f"{p.returncode}); continuing "
                                  "(recovery)", file=sys.stderr)
                            if on_fail is not None:
                                on_fail(rank, p.returncode)
                else:
                    exit_code = failed[0].returncode
                    break
            if not alive:
                if enable_recovery and snapshot and not any(
                        p.returncode == 0 for p in snapshot):
                    # recovery mode, but nothing survived to completion
                    exit_code = next(p.returncode for p in snapshot
                                     if p.returncode != 0)
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        exit_code = 130
    return exit_code


def _teardown(procs_list, pumps, exit_code: int) -> None:
    """Shared job teardown: kill survivors on failure (mpirun's
    kill-job-on-abort), drain cleanly on success, join the pumps."""
    for p in procs_list:
        if p.poll() is None:
            if exit_code:
                p.kill()
            else:
                p.wait()
    for p in procs_list:
        p.wait()
    for t in pumps:
        t.join(timeout=2)


def _child_main(args, cmd) -> int:
    """Child-launcher mode (``--child-of``, ``tpurun.py:322-411``): the
    per-host daemon of the multi-host launch.  It spawns this host's ranks
    with ``OTPU_COORD`` pointing at the head's coordination service,
    streams their prefixed output (the head passes it through), and
    mirrors the head's failure policy: the first failure ends the local
    group (the head sees this launcher's exit code), or under
    ``--enable-recovery`` each death is published as a ``proc_failed``
    event and the group runs on."""
    ranks = [int(r) for r in args.ranks.split(",") if r != ""]
    env_base = _rank_env(os.environ, args)
    env_base["OTPU_COORD"] = args.child_of
    if args.node_id:
        env_base["OTPU_NODE_ID"] = args.node_id

    procs: dict = {}
    pumps = []

    def _pump(rank: int, stream) -> None:
        for line in iter(stream.readline, b""):
            sys.stdout.write(f"[{rank}] {line.decode(errors='replace')}")
            sys.stdout.flush()

    for rank in ranks:
        env = dict(env_base)
        env["OTPU_RANK"] = str(rank)
        if args.bind_to != "none":
            env["OTPU_BIND_POLICY"] = args.bind_to
            env["OTPU_LOCAL_NRANKS"] = str(len(ranks))
        try:
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
        except OSError as exc:
            print(f"tpurun[child]: cannot launch {cmd[0]!r}: {exc}",
                  file=sys.stderr)
            for q in procs:
                q.kill()
            return 127
        procs[p] = rank
        t = threading.Thread(target=_pump, args=(rank, p.stdout),
                             daemon=True)
        t.start()
        pumps.append(t)

    def publish_failed(rank: int, rc: int) -> None:
        try:
            from ompi_tpu_torch.rte.coord import CoordClient

            # the head's address: OTPU_COORD lives only in the ranks' env
            h, _, prt = args.child_of.rpartition(":")
            c = CoordClient(addr=(h, int(prt)))
            c.event_publish("proc_failed",
                            {"rank": rank, "origin": "launcher"})
            c.close()
        except Exception as exc:
            print(f"tpurun[child]: failure publish failed: {exc}",
                  file=sys.stderr)

    exit_code = _monitor(
        procs, procs.__getitem__, enable_recovery=args.enable_recovery,
        label="tpurun[child]", on_fail=publish_failed)
    _teardown(list(procs), pumps, exit_code)
    return exit_code


def _merge_traces(server) -> None:
    """The trace gather: ranks publish their Chrome trace payloads into the
    coordination service's KV space at finalize; the launcher aligns their
    clocks (each payload carries the rank's measured offset to the
    coordination clock, the mpisync min-RTT estimate) and writes one merged
    timeline plus a text skew report next to the per-rank files."""
    import json

    from ompi_tpu_torch.runtime import trace

    raw = server.collect(trace._KV_KEY)
    if not raw:
        return

    payloads = []
    for rank in sorted(raw):
        try:
            payloads.append(json.loads(raw[rank]))
        except (TypeError, ValueError):
            print(f"tpurun: rank {rank} published an unreadable trace",
                  file=sys.stderr)
    if not payloads:
        return
    tdir = payloads[0].get("metadata", {}).get("trace_dir", "otpu-trace")
    try:
        os.makedirs(tdir, exist_ok=True)
        merged_path = os.path.join(tdir, "trace_merged.json")
        # each rank's ring-wrap count rides into the merged file's
        # metadata: a silently truncated timeline makes critical paths lie
        overwritten = {
            str(p["metadata"]["rank"]):
                int(p["metadata"].get("events_overwritten", 0) or 0)
            for p in payloads if p.get("metadata", {}).get("rank")
            is not None}
        with open(merged_path, "w") as f:
            json.dump({"traceEvents": trace.merge_timelines(payloads),
                       "metadata": {"ranks": sorted(raw),
                                    "clock": "coord-server",
                                    "events_overwritten": {
                                        r: n for r, n in
                                        overwritten.items() if n}}}, f)
        report_path = os.path.join(tdir, "trace_skew.txt")
        report = trace.skew_report(payloads)
        with open(report_path, "w") as f:
            f.write(report)
    except OSError as exc:
        print(f"tpurun: cannot write merged trace: {exc}", file=sys.stderr)
        return
    print(f"tpurun: merged timeline of {len(payloads)} ranks -> "
          f"{merged_path}; skew report -> {report_path}", file=sys.stderr)


def _merge_monitoring(server) -> None:
    """The job-wide communication matrix: ranks publish their monitoring
    matrices into the coordination KV at finalize; the launcher sums them
    and prints ONE table (superseding the per-rank exit dumps)."""
    import json

    from ompi_tpu_torch.runtime import monitoring

    raw = server.collect(monitoring._KV_KEY)
    if not raw:
        return

    payloads = []
    for rank in sorted(raw):
        try:
            payloads.append(json.loads(raw[rank]))
        except (TypeError, ValueError):
            pass
    if payloads:
        print("tpurun: " + monitoring.merged_summary(
            payloads, server.nprocs), file=sys.stderr)


def _gather_flight(server) -> None:
    """Flight-recorder gather: crashing and surviving ranks publish their
    post-mortem dumps into the coordination KV; the launcher merges them
    with the coordination service's own timestamped event view into one
    clock-aligned bundle (the victim's last trace events ordered against
    the survivors' recovery spans on the coordination clock)."""
    import json

    from ompi_tpu_torch.runtime import flight as flight_mod

    raw = server.collect(flight_mod._KV_KEY)
    if not raw:
        return
    dumps = {}
    for rank in sorted(raw):
        try:
            dumps[rank] = json.loads(raw[rank])
        except (TypeError, ValueError):
            print(f"tpurun: rank {rank} published an unreadable flight "
                  "dump", file=sys.stderr)
    if not dumps:
        return
    # clock-aligned merged event tail: each dump's trace tail wrapped as a
    # per-rank payload and run through THE timeline merger (one alignment
    # implementation, shared with _merge_traces)
    from ompi_tpu_torch.runtime import trace

    merged = trace.merge_timelines([
        {"traceEvents": d.get("trace_tail", []),
         "metadata": {"rank": rank,
                      "clock_offset_us": d.get("clock_offset_us", 0.0)}}
        for rank, d in dumps.items()])
    bundle = {
        "dumps": {str(r): d for r, d in dumps.items()},
        "coord": server.flight_view(),
        "merged_tail": merged,
        "clock": "coord-server",
    }
    fdir = next(iter(dumps.values())).get("flight_dir", "otpu-crash")
    try:
        os.makedirs(fdir, exist_ok=True)
        path = os.path.join(fdir, "bundle.json")
        with open(path, "w") as f:
            json.dump(bundle, f)
    except OSError as exc:
        print(f"tpurun: cannot write flight bundle: {exc}",
              file=sys.stderr)
        return
    reasons = ", ".join(f"rank {r}: {d.get('reason')}"
                        for r, d in sorted(dumps.items()))
    print(f"tpurun: flight-recorder bundle of {len(dumps)} dump(s) "
          f"({reasons}) -> {path}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurun",
        description="Launch an ompi_tpu_torch multi-process job")
    ap.add_argument("-n", "-np", type=int, default=1, dest="nprocs")
    ap.add_argument("--hostfile", default=None,
                    help="Multi-host launch: 'host [slots=N]' per line "
                         "(mpirun hostfile format); each host gets a child "
                         "launcher via --launch-agent")
    ap.add_argument("--launch-agent", default="ssh -o BatchMode=yes",
                    dest="launch_agent",
                    help="Command that runs the child launcher on a remote "
                         "host ('<agent> <host> <command>'); 'local' runs "
                         "the child launchers as plain subprocesses "
                         "(emulated multi-node)")
    ap.add_argument("--coord-host", default=None,
                    help="Address remote ranks use to reach the "
                         "coordination service (default: this host's "
                         "address when a hostfile names remote hosts)")
    ap.add_argument("--remote-python", default=None,
                    help="Python interpreter of the child launchers "
                         "(default: this interpreter for a local one, "
                         "python3 over the agent)")
    ap.add_argument("--wdir", default=None,
                    help="Working directory the child launchers cd into "
                         "(default over the agent: the current directory)")
    ap.add_argument("--oversubscribe", action="store_true",
                    help="Allow more ranks than hostfile slots")
    # internal: child-launcher mode (one a host)
    ap.add_argument("--child-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ranks", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--node-id", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mca", action="append", nargs=2, default=[],
                    metavar=("NAME", "VALUE"),
                    help="Set an MCA variable for all ranks")
    ap.add_argument("--tag-output", action="store_true", default=True,
                    help="Prefix each output line with its rank (always "
                         "on)")
    ap.add_argument("--coord-port", type=int, default=0)
    ap.add_argument("--fake-nodes", type=int, default=0, metavar="K",
                    help="Partition ranks into K emulated nodes (sets "
                         "OTPU_NODE_ID=rank*K//nprocs per rank) so the "
                         "hierarchical coll/han path can be exercised on "
                         "one host, like mpirun --oversubscribe for han")
    ap.add_argument("--bind-to", choices=("none", "core"), default="none",
                    help="CPU binding policy: 'core' gives each rank a "
                         "contiguous block of its host's allowed cores "
                         "(ompi_tpu_torch.base.hwloc); 'none' (default) "
                         "leaves ranks unbound")
    ap.add_argument("--enable-recovery", action="store_true",
                    help="ULFM mode: a dying rank is reported as a "
                         "proc_failed event instead of tearing down the job "
                         "(mpirun --enable-recovery)")
    ap.add_argument("--pset", action="append", default=[],
                    metavar="NAME:RANKS",
                    help="Publish a user process set (MPI-4 pset) under "
                         "NAME with the given ranks (comma list with "
                         "ranges: 'workers:0,2-3'); sessions resolve it "
                         "via Session.group_from_pset")
    ap.add_argument("--router-ranks", default=None, metavar="RANKS",
                    dest="router_ranks",
                    help="Serving role flag: publish the given ranks "
                         "(comma list with ranges) as the "
                         "'mpi://serving/router' pset — "
                         "ompi_tpu_torch.serving.roles() resolves placement "
                         "from it")
    ap.add_argument("--worker-ranks", default=None, metavar="RANKS",
                    dest="worker_ranks",
                    help="Serving role flag: publish the given ranks as "
                         "the 'mpi://serving/workers' pset (the serving "
                         "router's model-shard worker table)")
    ap.add_argument("--pool", action="append", default=[],
                    metavar="MODEL:RANKS", dest="pool",
                    help="Fleet pool flag (repeatable): publish the "
                         "given ranks as the "
                         "'mpi://serving/pool/<MODEL>' pset — one "
                         "per-model worker pool of the serving fleet "
                         "(ompi_tpu_torch.serving.fleet resolves pool "
                         "placement from these, the way roles() "
                         "resolves the router).  Same RANKS syntax as "
                         "--pset: comma list with ranges, "
                         "'llama:1,3-4'")
    ap.add_argument("--device-world", action="store_true",
                    dest="device_world",
                    help="Boot a multi-process device world: every rank "
                         "joins one torch.distributed (gloo) process group, "
                         "its rendezvous published through the "
                         "coordination service, so coll/builtin's device "
                         "collectives and the training step span processes")
    ap.add_argument("--local-devices", type=int, default=0,
                    dest="local_devices", metavar="K",
                    help="With --device-world: give each rank K virtual "
                         "ranks (otpu_rte_virtual_ranks)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]

    if args.child_of:
        return _child_main(args, cmd)

    from ompi_tpu_torch.rte.coord import DIST_COORD_KEY, CoordServer

    hosts = rank_groups = None
    if args.hostfile:
        hosts = _parse_hostfile(args.hostfile)
        rank_groups = _assign_ranks(hosts, args.nprocs, args.oversubscribe)
        any_remote = (args.launch_agent != "local"
                      and any(not _is_local_host(h) for h, _ in hosts))
        # remote ranks must reach the coordination service: bind every
        # interface and advertise a routable address instead of loopback
        bind = "0.0.0.0" if any_remote else "127.0.0.1"
        server = CoordServer(args.nprocs, host=bind, port=args.coord_port)
        port = server.addr[1]
        host = args.coord_host or (
            socket.gethostbyname(socket.gethostname()) if any_remote
            else "127.0.0.1")
    else:
        server = CoordServer(args.nprocs, port=args.coord_port)
        host, port = server.addr
    # process-set registry (MPI-4 psets, served to sessions by the
    # coordination service): the builtin world set, one set per node the
    # rank map names, and the user sets.  mpi://SELF stays client-resolved
    # (its membership is per-process).
    server.publish_pset("mpi://WORLD", range(args.nprocs), source="builtin")
    node_ranks: dict = {}
    for rank in range(args.nprocs):
        if rank_groups is not None:
            node = next(h for (h, _), rr in zip(hosts, rank_groups)
                        if rank in rr)
        elif args.fake_nodes > 0:
            node = f"node{rank * args.fake_nodes // args.nprocs}"
        else:
            node = socket.gethostname()
        node_ranks.setdefault(node, []).append(rank)
    for node, ranks_on in node_ranks.items():
        server.publish_pset(f"mpi://host/{node}", ranks_on, source="host")
    for spec_s in args.pset:
        pname, pranks = _parse_pset(spec_s, args.nprocs)
        server.publish_pset(pname, pranks, source="user")
    # serving role psets (ompi_tpu_torch.serving.roles), same RANKS syntax
    for flag, pset_name in ((args.router_ranks, "mpi://serving/router"),
                            (args.worker_ranks, "mpi://serving/workers")):
        if flag:
            _, pranks = _parse_pset(f"serving:{flag}", args.nprocs)
            server.publish_pset(pset_name, pranks, source="user")
    # fleet pool psets (ompi_tpu_torch.serving.fleet.pool_specs_from_psets):
    # one mpi://serving/pool/<model> set per --pool flag
    for spec_s in args.pool:
        model, pranks = _parse_pset(spec_s, args.nprocs)
        server.publish_pset(f"mpi://serving/pool/{model}", pranks,
                            source="user")

    if args.device_world:
        # rank 0's process hosts the rendezvous: advertise the address
        # where rank 0 runs (loopback would not reach a remote host)
        dist_host = host
        if rank_groups is not None and args.launch_agent != "local":
            r0_host = next(h for (h, _), rr in zip(hosts, rank_groups)
                           if 0 in rr)
            if not _is_local_host(r0_host):
                dist_host = r0_host
        server.kv_put(-1, DIST_COORD_KEY,
                      f"{dist_host}:{_free_port(dist_host)}")

    env_base = _rank_env(os.environ, args)
    env_base["OTPU_COORD"] = f"{host}:{port}"

    procs: list[subprocess.Popen] = []
    proc_rank: dict = {}            # Popen -> global rank | node label
    pumps: list[threading.Thread] = []

    def _pump(rank, stream) -> None:
        # child launchers (rank None) prefix their ranks already: raw
        prefix = "" if rank is None else f"[{rank}] "
        for line in iter(stream.readline, b""):
            sys.stdout.write(prefix + line.decode(errors="replace"))
            sys.stdout.flush()

    def _launch(rank, env: dict, argv) -> subprocess.Popen:
        p = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        proc_rank[p] = rank       # before append: the monitor loop reads
        procs.append(p)           # proc_rank for any proc it can see
        t = threading.Thread(
            target=_pump,
            args=(rank if isinstance(rank, int) else None, p.stdout),
            daemon=True)
        t.start()
        pumps.append(t)
        return p

    def _spawn_handler(spawn_cmd, ranks, job, extra_env) -> None:
        """MPI_Comm_spawn's execution: the new global ranks start as a job
        of their own (their own COMM_WORLD) on the same coordination
        service.  ``spawn_cmd`` is one argv (every rank runs it) or one
        argv a rank (MPI_Comm_spawn_multiple: one child world, several
        executables)."""
        per_rank = (list(spawn_cmd)
                    if spawn_cmd and isinstance(spawn_cmd[0], (list, tuple))
                    else [list(spawn_cmd)] * len(ranks))
        if len(per_rank) != len(ranks):
            raise ValueError(
                f"spawn got {len(per_rank)} argvs for {len(ranks)} ranks")
        for i, rank in enumerate(ranks):
            env = dict(env_base)
            env.update({k: str(v) for k, v in extra_env.items()})
            env["OTPU_RANK"] = str(rank)
            env["OTPU_JOB"] = job
            env["OTPU_JOB_RANKS"] = ",".join(str(r) for r in ranks)
            env["OTPU_NPROCS"] = str(len(ranks))
            if args.fake_nodes > 0:
                env["OTPU_NODE_ID"] = f"node{rank % args.fake_nodes}"
            _launch(rank, env, list(per_rank[i]))

    server.set_spawn_handler(_spawn_handler)

    def _abort_launch(what: str, exc) -> int:
        print(f"tpurun: cannot launch {what!r}: {exc}", file=sys.stderr)
        for q in procs:
            q.kill()
        server.close()
        return 127

    if args.hostfile:
        # one child launcher a hostfile entry (the ssh plm's remote
        # daemon); each spawns its ranks against our coordination service
        for (host_name, _), ranks in zip(hosts, rank_groups):
            if not ranks:
                continue
            run_local = (args.launch_agent == "local"
                         or _is_local_host(host_name))
            # a local child keeps THIS interpreter; only a remote host
            # falls back to PATH's python3
            rpy = args.remote_python or (
                sys.executable if run_local else "python3")
            child = [rpy, "-m", "ompi_tpu_torch.tools.tpurun",
                     "--child-of", f"{host}:{port}",
                     "--ranks", ",".join(str(r) for r in ranks),
                     "-n", str(args.nprocs), "--node-id", host_name]
            if args.enable_recovery:
                child.append("--enable-recovery")
            if args.device_world:
                child.append("--device-world")
                if args.local_devices > 0:
                    child += ["--local-devices", str(args.local_devices)]
            if args.bind_to != "none":
                child += ["--bind-to", args.bind_to]
            for name, value in args.mca:
                child += ["--mca", name, value]
            child += ["--"] + cmd
            if run_local:
                argv_full = child
            else:
                wdir = args.wdir or os.getcwd()
                argv_full = args.launch_agent.split() + [
                    host_name,
                    f"cd {shlex.quote(wdir)} && {shlex.join(child)}"]
            try:
                _launch(f"node:{host_name}", env_base, argv_full)
            except OSError as exc:
                return _abort_launch(argv_full[0], exc)
    else:
        for rank in range(args.nprocs):
            env = dict(env_base)
            env["OTPU_RANK"] = str(rank)
            if args.bind_to != "none":
                env["OTPU_BIND_POLICY"] = args.bind_to
                env["OTPU_LOCAL_NRANKS"] = str(args.nprocs)
            if args.fake_nodes > 0:
                env["OTPU_NODE_ID"] = \
                    f"node{rank * args.fake_nodes // args.nprocs}"
            try:
                _launch(rank, env, cmd)
            except OSError as exc:
                return _abort_launch(cmd[0], exc)

    def publish_failed(rank, rc) -> None:
        # ULFM: report the death and keep the job running (the
        # PRRTE-daemon-detects-child-death path of the reference).  Child
        # launchers publish their own ranks' failures; a dead child
        # launcher (a node label) is only reported.
        if isinstance(rank, int):
            server.publish("proc_failed",
                           {"rank": rank, "origin": "launcher"})

    exit_code = _monitor(procs, proc_rank.__getitem__,
                         enable_recovery=args.enable_recovery,
                         label="tpurun", on_fail=publish_failed,
                         abort_check=lambda: server.aborted)
    _teardown(procs, pumps, exit_code)
    _merge_traces(server)
    _merge_monitoring(server)
    _gather_flight(server)
    server.close()
    if exit_code:
        print(f"tpurun: job terminated with exit code {exit_code}",
              file=sys.stderr)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
