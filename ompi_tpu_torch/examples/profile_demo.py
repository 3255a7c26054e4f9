"""otpu-prof demo — where does a message's latency actually go?

The counterpart of the JAX package's ``examples/profile_demo.py``.
Self-launching: run it directly (no tpurun needed) and it

1. runs a 3-rank loopback allreduce job with the per-message stage clocks
   and the sampling profiler armed (``--mca otpu_profile_stages 1 --mca
   otpu_profile_interval_ms 10``), collectives routed over the pml/btl
   datapath the clocks instrument,
2. runs ``otpu_analyze`` over the trace directory and prints the per-rank
   host-overhead table: the per-message pack/queue/wire/parse/deliver
   breakdown, the exposed-host fraction, and the profiler's phase/GIL
   estimates,
3. demonstrates the perf-history plane: two bench-style runs into a
   history file in the demo's own temporary directory, with an injected
   slowdown on the second, then ``otpu_perf --diff`` flagging the
   regression (nonzero exit).

    python -m ompi_tpu_torch.examples.profile_demo [--device cpu]

Each rank runs this module with ``--worker``: ``ITERS`` rounds of a 4 KB
allreduce, each at the ``step`` chaos pacing point.  ``--device`` names the
device each rank's ``init`` binds (default: the card).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: allreduce rounds of each rank (the reference's ``TW_ITERS``)
ITERS = 30


def worker(device: str) -> int:
    import ompi_tpu_torch
    from ompi_tpu_torch.api import op
    from ompi_tpu_torch.ft import chaos

    w = ompi_tpu_torch.init(device=device)
    x = np.ones(1024, np.float32)          # 4 KB payload
    for _ in range(ITERS):
        if chaos.enabled:
            chaos.pace("step")
        w.allreduce(x, op.SUM)
    print(f"PROFILE DEMO WORKER DONE {w.rank}", flush=True)
    ompi_tpu_torch.finalize()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device each rank binds to (default: the card)")
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank of the job (tpurun starts these)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.device)

    from ompi_tpu_torch.tools import otpu_analyze, otpu_perf

    tdir = tempfile.mkdtemp(prefix="otpu-prof-demo-")
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    device = ["--device", args.device] if args.device else []

    print("== 1. 3-rank loopback allreduce job, stage clocks armed ==")
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", "3",
         "--mca", "otpu_trace_enable", "1",
         "--mca", "otpu_trace_dir", tdir,
         "--mca", "otpu_profile_stages", "1",
         "--mca", "otpu_profile_interval_ms", "10",
         "--mca", "otpu_coll_sm_coll_priority", "0",
         sys.executable, "-m", "ompi_tpu_torch.examples.profile_demo",
         "--worker", *device],
        env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        print(r.stdout + r.stderr)
        return 1

    print("== 2. per-message breakdown (otpu_analyze) ==")
    otpu_analyze.main([tdir])

    print()
    print("== 3. perf-history plane (otpu_perf --diff) ==")
    hist = os.path.join(tdir, "BENCH_CUDA_HISTORY.jsonl")
    with open(hist, "w") as f:
        t = time.time()
        for run, lat in (("clean", 910.0), ("slow", 5410.0)):
            for key, v in (("allreduce_4096b_n2", lat),
                           ("pingpong_4096b_n2", lat * 1.3)):
                f.write(json.dumps(
                    {"v": 1, "kind": "bench", "run": run, "t": t,
                     "topology": "host_sm_n2", "key": key,
                     "lat_us": v, "k": 6}) + "\n")
            t += 1.0
    rc = otpu_perf.main([hist, "--diff"])
    print(f"otpu_perf --diff exit code: {rc} (nonzero = regression "
          "gate trips; over a benchmark history run `python -m "
          "ompi_tpu_torch.tools.otpu_perf --diff`)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
