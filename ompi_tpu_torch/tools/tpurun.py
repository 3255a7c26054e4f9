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

Not copied yet: hostfiles, launch agents and their ``_child_main``
(``tpurun.py:34-83``, ``:322``; ROADMAP A 4.5), the serving flags
(``--router-ranks``, ``--worker-ranks``, ``--pool``; A 7), and the
device-world and binding flags.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time


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
    ap.add_argument("--mca", action="append", nargs=2, default=[],
                    metavar=("NAME", "VALUE"),
                    help="Set an MCA variable for all ranks")
    ap.add_argument("--coord-port", type=int, default=0)
    ap.add_argument("--fake-nodes", type=int, default=0, metavar="K",
                    help="Partition ranks into K emulated nodes (sets "
                         "OTPU_NODE_ID=rank*K//nprocs per rank) so the "
                         "hierarchical coll/han path can be exercised on "
                         "one host, like mpirun --oversubscribe for han")
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
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]

    from ompi_tpu_torch.rte.coord import CoordServer

    server = CoordServer(args.nprocs, port=args.coord_port)
    host, port = server.addr
    # process-set registry (MPI-4 psets, served to sessions by the
    # coordination service): the builtin world set, one set per node, and
    # the user sets.  mpi://SELF stays client-resolved (its membership is
    # per-process).
    server.publish_pset("mpi://WORLD", range(args.nprocs), source="builtin")
    node_ranks: dict = {}
    for rank in range(args.nprocs):
        node = (f"node{rank * args.fake_nodes // args.nprocs}"
                if args.fake_nodes > 0 else socket.gethostname())
        node_ranks.setdefault(node, []).append(rank)
    for node, ranks_on in node_ranks.items():
        server.publish_pset(f"mpi://host/{node}", ranks_on, source="host")
    for spec_s in args.pset:
        pname, pranks = _parse_pset(spec_s, args.nprocs)
        server.publish_pset(pname, pranks, source="user")

    env_base = dict(os.environ)
    # Ranks must be able to import ompi_tpu_torch however tpurun itself was
    # found.  Appended, not prepended: the user's own PYTHONPATH entries
    # keep shadowing rights.
    import ompi_tpu_torch as _pkg
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
    env_base["PYTHONPATH"] = (
        env_base["PYTHONPATH"] + os.pathsep + pkg_root
        if env_base.get("PYTHONPATH") else pkg_root)
    env_base["OTPU_NPROCS"] = str(args.nprocs)
    env_base["OTPU_COORD"] = f"{host}:{port}"
    for name, value in args.mca:
        env_base["OTPU_MCA_" + name.removeprefix("otpu_")] = value

    procs: list[subprocess.Popen] = []
    proc_rank: dict = {}            # Popen -> global rank
    pumps: list[threading.Thread] = []

    def _pump(rank: int, stream) -> None:
        for line in iter(stream.readline, b""):
            sys.stdout.write(f"[{rank}] " + line.decode(errors="replace"))
            sys.stdout.flush()

    def _launch(rank: int, env: dict, argv) -> subprocess.Popen:
        p = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        proc_rank[p] = rank       # before append: the monitor loop reads
        procs.append(p)           # proc_rank for any proc it can see
        t = threading.Thread(target=_pump, args=(rank, p.stdout),
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

    for rank in range(args.nprocs):
        env = dict(env_base)
        env["OTPU_RANK"] = str(rank)
        if args.fake_nodes > 0:
            env["OTPU_NODE_ID"] = f"node{rank * args.fake_nodes // args.nprocs}"
        try:
            _launch(rank, env, cmd)
        except OSError as exc:
            print(f"tpurun: cannot launch {cmd[0]!r}: {exc}",
                  file=sys.stderr)
            for q in procs:
                q.kill()
            server.close()
            return 127

    def publish_failed(rank, rc) -> None:
        # ULFM: report the death and keep the job running (the
        # PRRTE-daemon-detects-child-death path of the reference)
        server.publish("proc_failed", {"rank": rank, "origin": "launcher"})

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
