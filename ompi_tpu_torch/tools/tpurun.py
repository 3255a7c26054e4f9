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
beside it, and the monitoring matrices into one job-wide table on stderr.

Not copied yet: hostfiles and launch agents (``tpurun.py:34-83``),
``--enable-recovery``, process sets (the per-node sets ``--fake-nodes``
names there too), spawn, the device-world and binding flags, and the
flight bundle merge (``:255-305``, with the flight recorder, ROADMAP A 4.4).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time


def _monitor(procs_list, abort_check=None) -> int:
    """Poll the ranks: the first nonzero exit ends the job with that code
    (``ompi_tpu/tools/tpurun.py:_monitor``, without recovery).
    ``abort_check()`` may return an exit code for an out-of-band abort
    (the coordination service's MPI_Abort)."""
    exit_code = 0
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
                exit_code = failed[0].returncode
                break
            if not alive:
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
    pumps: list[threading.Thread] = []

    def _pump(rank: int, stream) -> None:
        for line in iter(stream.readline, b""):
            sys.stdout.write(f"[{rank}] " + line.decode(errors="replace"))
            sys.stdout.flush()

    for rank in range(args.nprocs):
        env = dict(env_base)
        env["OTPU_RANK"] = str(rank)
        if args.fake_nodes > 0:
            env["OTPU_NODE_ID"] = f"node{rank * args.fake_nodes // args.nprocs}"
        try:
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
        except OSError as exc:
            print(f"tpurun: cannot launch {cmd[0]!r}: {exc}",
                  file=sys.stderr)
            for q in procs:
                q.kill()
            server.close()
            return 127
        procs.append(p)
        t = threading.Thread(target=_pump, args=(rank, p.stdout),
                             daemon=True)
        t.start()
        pumps.append(t)

    exit_code = _monitor(procs, abort_check=lambda: server.aborted)
    _teardown(procs, pumps, exit_code)
    _merge_traces(server)
    _merge_monitoring(server)
    server.close()
    if exit_code:
        print(f"tpurun: job terminated with exit code {exit_code}",
              file=sys.stderr)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
