"""otpu-trace demo — run under tpurun with tracing enabled:

    python -m ompi_tpu_torch.tools.tpurun -n 4 \\
        --mca trace_enable 1 --mca trace_dir /tmp/otpu-trace \\
        python -m ompi_tpu_torch.examples.trace_demo

The counterpart of the JAX package's ``examples/trace_demo.py``.  Each rank
records pml/coll/osc spans into its ring buffer and writes
``trace_rank<r>.json`` (Chrome trace format — load in chrome://tracing or
Perfetto) at finalize; tpurun then gathers every rank's payload through the
CoordServer, aligns clocks against the coord server's (mpisync min-RTT
estimator), and writes ``trace_merged.json`` plus the ``trace_skew.txt``
straggler report into the trace directory.

Rank 0 also demonstrates the live MPI_T surface: the log2-size-binned
latency histogram pvars visible through ``otpu_info --pvars``.
``--device`` names the device ``init`` binds (default: the card); the
payloads are host numpy, as in the reference.
"""
import argparse
import contextlib
import io
import sys
import time

import numpy as np

import ompi_tpu_torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    me, n = world.rank, world.size

    # collectives across a few log2 size bins (histogram fodder)
    for nbytes in (1 << 10, 1 << 14, 1 << 18):
        x = np.ones(nbytes // 4, np.float32) * (me + 1)
        for _ in range(3):
            world.allreduce(x)
    world.barrier()

    # a p2p ring (pml send/recv spans)
    buf = np.zeros(128, np.float32)
    if n > 1:
        right, left = (me + 1) % n, (me - 1) % n
        req = world.isend(np.full(128, me, np.float32), right, tag=7)
        world.recv(buf, left, tag=7)
        req.wait()

    # make rank n-1 a deliberate straggler so the skew report has a
    # clear "slowest rank" to name
    if me == n - 1:
        time.sleep(0.02)
    world.barrier()

    if me == 0:
        # the live MPI_T view: otpu_info --pvars in THIS process shows
        # the nonzero log2-binned latency histograms
        from ompi_tpu_torch.tools import otpu_info

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            otpu_info.main(["--pvars", "--parsable"])
        hist_lines = [ln for ln in out.getvalue().splitlines()
                      if "trace_hist" in ln]
        print("live pvar histograms (otpu_info --pvars):")
        for ln in hist_lines:
            print(" ", ln)

    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
