"""MPI-4 partitioned communication demo — run under tpurun:

    python -m ompi_tpu_torch.tools.tpurun -n 2 python -m \\
        ompi_tpu_torch.examples.partitioned_pingpong

The counterpart of the JAX package's ``examples/partitioned_pingpong.py``.
Rank 0 "produces" a large buffer one partition at a time (simulated compute
per partition) and releases each slice with ``Pready`` the moment it is
final — transfer of finished partitions overlaps the computation of the
rest, which is the contract behind bucketed gradient overlap
(``parallel_bucket_overlap``).  Rank 1 polls ``Parrived`` and consumes
partitions as they land instead of waiting for the whole message.  Try
``--mca part_persist_min_partitions 4`` to watch N app partitions travel as
fewer wire messages (``otpu_info --pvars`` shows the ``part_*`` SPC
counters).  ``--device`` names the device ``init`` binds (default: the
card); the buffers are host numpy, as in the reference.
"""
import argparse
import time

import numpy as np

import ompi_tpu_torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    if world.size < 2:
        print("needs 2 ranks")
        return 1
    me = world.rank
    parts, per = 8, 1 << 12                   # 8 x 4K-element partitions
    buf = np.zeros(parts * per, np.float64)

    if me == 0:
        req = world.psend_init(buf, parts, dest=1, tag=1)
        req.start()
        for p in range(parts):
            # "compute" partition p, then release it immediately
            buf[p * per:(p + 1) * per] = p + 1
            time.sleep(0.002)
            req.pready(p)
            print(f"[rank 0] partition {p} ready", flush=True)
        req.wait()
        print("[rank 0] all partitions sent", flush=True)
    elif me == 1:
        req = world.precv_init(buf, parts, source=0, tag=1)
        req.start()
        done = set()
        while len(done) < parts:
            for p in range(parts):
                if p not in done and req.parrived(p):
                    s = buf[p * per:(p + 1) * per].sum()
                    print(f"[rank 1] partition {p} arrived "
                          f"(sum {s:.0f})", flush=True)
                    done.add(p)
        req.wait()
        assert all(buf[p * per] == p + 1 for p in range(parts))
        print("[rank 1] complete", flush=True)

    from ompi_tpu_torch.runtime import spc

    world.barrier()
    print(f"[rank {me}] part_msgs={spc.read('part_msgs'):.0f} "
          f"part_bytes={spc.read('part_bytes'):.0f}", flush=True)
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
