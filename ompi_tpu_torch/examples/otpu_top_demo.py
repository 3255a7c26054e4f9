"""otpu-top demo — watch a live job from outside it, then find its
straggler.

The counterpart of the JAX package's ``examples/otpu_top_demo.py``.
Self-launching: run it directly (no tpurun needed) and it

1. starts a 3-rank ``tpurun`` job on a fixed coord port with the telemetry
   sampler on (``--mca otpu_telemetry_interval_ms 150``), tracing on and a
   rank-scoped chaos delay (``delay:ms=8,p=1,rank=2,site=step``), so rank 2
   is a designed straggler;
2. attaches ``otpu_top`` to the running job and prints a few live per-rank
   tables (msg/s, bytes/s, allreduce p50/p99, queue depths, chaos fault
   totals, stale flags);
3. after the job ends, runs ``otpu_analyze --critical-path`` over the merged
   timeline and prints the straggler report, which names rank 2.

    python -m ompi_tpu_torch.examples.otpu_top_demo [--device cpu]

Each rank runs this module with ``--worker``: step-spanned rounds, each one
chaos-paced, that fold the rank's 8 local gradient shards (an ``(8, S)``
tensor on its device) with the ring all-reduce (K3; K4 once, at a shard
above the fused regime's 8 MB), then allreduce 4 KB of the fold across the
processes and swap it with the ring neighbours (``sendrecv``), so the
merged timeline carries collective round keys and message flows.  Rank 0
owns the ``--secs`` deadline, and a MIN allreduce outside the step keeps
every rank doing the same rounds.  Inside a job you can attach by hand::

    python -m ompi_tpu_torch.tools.otpu_top --coord 127.0.0.1:PORT --watch
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

#: the designed straggler: every step of rank 2 starts 8 ms late
CHAOS_SPEC = "delay:ms=8,p=1,rank=2,site=step"
SLOW_RANK = 2
#: floats of a gradient shard: 1 MB on the card (K3, fused), 16 MB once
#: (K4, segmented above vmem_max_bytes' 8 MB); small on the CPU lane
SHARD = {"cuda": (1 << 18, 1 << 22), "cpu": (1 << 10, 1 << 12)}
RANKS_ON_A_STACK = 8
SEG_ELEMS = 131072          # coll/ring's default seg_bytes (512k) of float32


def job_argv(port: int, trace_dir: str, device: str, secs: float,
             nprocs: int = 3) -> list:
    """The ``tpurun`` command line of the demo's job."""
    return [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
            "-n", str(nprocs), "--coord-port", str(port),
            "--mca", "otpu_telemetry_interval_ms", "150",
            "--mca", "otpu_chaos_spec", CHAOS_SPEC,
            "--mca", "otpu_trace_enable", "1",
            "--mca", "otpu_trace_dir", trace_dir,
            # collectives through the pml datapath, so sends are spanned
            "--mca", "otpu_coll_sm_coll_priority", "0",
            sys.executable, "-m", "ompi_tpu_torch.examples.otpu_top_demo",
            "--worker", "--device", device, "--secs", str(secs)]


def worker(device: str, secs: float) -> int:
    import numpy as np
    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.api import op
    from ompi_tpu_torch.ft import chaos
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.runtime import trace

    w = ompi_tpu_torch.init(device=device)
    kind = "cuda" if device.startswith("cuda") else "cpu"
    small, big = SHARD[kind]
    gen = torch.Generator(device=device).manual_seed(1234 + w.rank)
    shards = torch.randint(-4, 5, (RANKS_ON_A_STACK, small), generator=gen,
                           device=device).float()
    wide = torch.randint(-4, 5, (RANKS_ON_A_STACK, big), generator=gen,
                         device=device).float()
    before = dict(rc.launches)
    inbuf = np.empty(1024, np.float32)
    right, left = (w.rank + 1) % w.size, (w.rank - 1) % w.size
    deadline = time.monotonic() + secs
    cont = np.ones(1, np.float32)
    i = 0
    exact = True
    while True:
        # the exit decision is collective: rank 0 owns the deadline
        if w.rank == 0 and time.monotonic() >= deadline:
            cont = np.zeros(1, np.float32)
        if float(np.asarray(w.allreduce(cont, op.MIN))[0]) < 0.5:
            break
        t0 = trace.now() if trace.enabled else 0
        if chaos.enabled:
            chaos.pace("step")
        fold = rc.all_reduce(shards, RANKS_ON_A_STACK, "sum")
        if i == 0:
            seg = rc.all_reduce(wide, RANKS_ON_A_STACK, "sum", variant="seg",
                                seg_elems=SEG_ELEMS)
            exact &= bool(torch.equal(seg, wide.sum(0)))
        exact &= bool(torch.equal(fold, shards.sum(0)))
        head = np.asarray(w.allreduce(fold[:1024], op.SUM), np.float32)
        w.sendrecv(head, right, inbuf, source=left, sendtag=5, recvtag=5)
        if trace.enabled:
            trace.span("step", "step", t0, args={"step": i})
        i += 1
    launched = {k: v - before.get(k, 0) for k, v in rc.launches.items()
                if v != before.get(k, 0)}
    print("OTPU TOP DEMO WORKER " + json.dumps(
        {"rank": w.rank, "steps": i, "device": str(shards.device),
         "exact": exact, "launches": launched}), flush=True)
    ompi_tpu_torch.finalize()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of each rank's tensors (default: the card)")
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank of the job (tpurun starts these)")
    ap.add_argument("--secs", type=float, default=5.0,
                    help="how long the job runs (rank 0 decides)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.device, args.secs)

    from ompi_tpu_torch.tools import otpu_analyze, otpu_top
    from ompi_tpu_torch.tools.tpurun import _free_port

    port = _free_port()
    tdir = tempfile.mkdtemp(prefix="otpu-top-demo-")
    env = dict(os.environ)
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    job = subprocess.Popen(job_argv(port, tdir, args.device, args.secs),
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    print(f"job launched (coord 127.0.0.1:{port}); attaching otpu_top…")
    time.sleep(2.0)                       # let the samplers warm up
    for _ in range(3):
        otpu_top.main(["--coord", f"127.0.0.1:{port}"])
        print()
        time.sleep(0.8)
    job.wait(timeout=180)
    merged = os.path.join(tdir, "trace_merged.json")
    if os.path.exists(merged):
        print("job ended; otpu_analyze over the merged timeline:")
        otpu_analyze.main([merged, "--critical-path"])
    return job.returncode


if __name__ == "__main__":
    sys.exit(main())
