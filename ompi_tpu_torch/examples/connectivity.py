"""All-pairs connectivity check — the ``examples/connectivity_c.c``
equivalent: every rank exchanges a message with every other rank.

The counterpart of the JAX package's ``examples/connectivity.py``.  Runs in
both process models:

- device world (default): one process drives every rank through
  ``world.as_rank``, ``python -m ompi_tpu_torch.examples.connectivity``;
- multi-process: ``python -m ompi_tpu_torch.tools.tpurun -n 4 python -m
  ompi_tpu_torch.examples.connectivity``.

``--device`` names the device the world binds to (default: the card;
``--device cpu`` where there is none).
"""
import argparse

import numpy as np

import ompi_tpu_torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    n = world.size
    if world.rte.is_device_world:
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                world.as_rank(i).send(np.array([i * n + j]), dest=j, tag=300)
        for j in range(n):
            for i in range(n):
                if i == j:
                    continue
                buf = np.zeros(1, np.int64)
                world.as_rank(j).recv(buf, source=i, tag=300)
                assert buf[0] == i * n + j
        print(f"connectivity OK: {n} ranks fully connected "
              f"({n * (n - 1)} messages)")
    else:
        from ompi_tpu_torch.api.request import waitall

        rank = world.rank
        reqs = [world.isend(np.array([rank * n + j]), dest=j, tag=300)
                for j in range(n) if j != rank]
        for i in range(n):
            if i == rank:
                continue
            buf = np.zeros(1, np.int64)
            world.recv(buf, source=i, tag=300)
            assert buf[0] == i * n + rank
        waitall(reqs)
        world.barrier()
        if rank == 0:
            print(f"connectivity OK: {n} ranks")
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
