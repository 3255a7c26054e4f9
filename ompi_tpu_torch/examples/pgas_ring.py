"""PGAS ring over the OpenSHMEM-style layer: each PE writes a token into
its right neighbor's symmetric slot, then the reduction closes the loop.

The counterpart of the JAX package's ``examples/pgas_ring.py``::

    python -m ompi_tpu_torch.tools.tpurun -n 4 \\
        python -m ompi_tpu_torch.examples.pgas_ring [--device cpu]

``--device`` names the device each PE's world binds to (default: the card).
The symmetric heap is a host window: the ring launches no kernel.
"""
import argparse

import numpy as np

import ompi_tpu_torch
import ompi_tpu_torch.shmem as shmem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    ompi_tpu_torch.init(device=args.device)
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()

    slot = shmem.array(1, np.int64)
    slot.local[0] = -1
    shmem.barrier_all()

    # put my id into my right neighbor's slot
    shmem.p(slot, me, (me + 1) % n)
    shmem.barrier_all()

    left = (me - 1) % n
    assert slot.local[0] == left, (me, slot.local)

    # atomic ring accounting on PE 0
    counter = shmem.array(1, np.int64)
    counter.local[0] = 0
    shmem.barrier_all()
    shmem.atomic_add(counter, me + 1, 0)
    shmem.barrier_all()
    if me == 0:
        total = counter.local[0]
        assert total == n * (n + 1) // 2, total
        print(f"pgas ring OK: {n} PEs, counter {total}")
    shmem.barrier_all()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
