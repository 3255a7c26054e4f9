"""mpisync — clock-offset measurement across ranks.

Copy of ``ompi_tpu/tools/mpisync.py`` (after the reference's
``ompi/tools/mpisync/``, the ``mpigclock`` tool): rank 0 exchanges
ping-pong timestamps with every other rank, estimates each peer's clock
offset as ``theirs - (t_send + rtt/2)`` at the round with the smallest
round trip, and prints one line per rank: the data needed to merge
per-rank trace timelines.  The trace exporter reads the same estimator
(:func:`estimate_offset`) against the coordination server's clock.

Run:  python -m ompi_tpu_torch.tools.tpurun -n 4 python -m
ompi_tpu_torch.tools.mpisync --device cpu
"""
from __future__ import annotations

import sys
import time

import numpy as np


def estimate_offset(exchange, iters: int = 10) -> tuple:
    """Generic min-RTT clock-offset estimator (the mpigclock filter).

    ``exchange()`` performs one round-trip and returns the peer's wall
    timestamp; the peer's offset is ``theirs - (t_send + rtt/2)`` taken
    at the round with the smallest RTT.  Returns ``(offset_s, rtt_s)``.
    Shared with the trace exporter, which aligns every rank to the coord
    server's clock through ``CoordClient.server_time``.
    """
    best_rtt, best_off = float("inf"), 0.0
    for _ in range(iters):
        t0 = time.time()
        theirs = exchange()
        t1 = time.time()
        rtt = t1 - t0
        if rtt < best_rtt:     # min-RTT filter, like the tool
            best_rtt = rtt
            best_off = float(theirs) - (t0 + rtt / 2)
    return best_off, best_rtt


def measure(comm, iters: int = 10) -> list:
    """Rank 0 returns [(rank, offset_s, rtt_s)] for every peer."""
    results = []
    if comm.rank == 0:
        for peer in range(1, comm.size):
            def exchange(peer=peer):
                comm.send(np.array([time.time()]), peer, tag=91)
                buf = np.zeros(1)
                comm.recv(buf, peer, tag=92)
                return float(buf[0])

            best_off, best_rtt = estimate_offset(exchange, iters)
            results.append((peer, best_off, best_rtt))
    else:
        for _ in range(iters):
            buf = np.zeros(1)
            comm.recv(buf, 0, tag=91)
            comm.send(np.array([time.time()]), 0, tag=92)
    comm.barrier()
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="mpisync",
        description="Clock-offset measurement across ranks (run under "
                    "tpurun; rank 0 prints one offset/rtt line per peer)")
    ap.add_argument("--iters", type=int, default=10,
                    help="ping-pong rounds per peer (min-RTT filter)")
    ap.add_argument("--device", default=None,
                    help="device of the world (default: the card; 'cpu' "
                         "for a machine without one)")
    args = ap.parse_args(argv)

    import ompi_tpu_torch

    world = ompi_tpu_torch.init(device=args.device)
    results = measure(world, iters=args.iters)
    if world.rank == 0:
        print("rank offset_us rtt_us")
        print("0 0.0 0.0   # reference clock")
        for rank, off, rtt in results:
            print(f"{rank} {off * 1e6:.1f} {rtt * 1e6:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
