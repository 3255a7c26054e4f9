"""Ring smoke test — the ``examples/ring_c.c`` equivalent.

The counterpart of the JAX package's ``examples/ring.py``: a token
circulates the ring 10 times, decremented each pass through rank 0.  Runs
in both process models:

- device world (default): one process drives all ranks,
  ``python -m ompi_tpu_torch.examples.ring``;
- multi-process: ``python -m ompi_tpu_torch.tools.tpurun -n 4 python -m
  ompi_tpu_torch.examples.ring``.

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
    size = world.size
    tag = 201

    if world.rte.is_device_world:
        # conductor model: drive each rank explicitly
        token = np.array([10], dtype=np.int32)
        world.as_rank(0).send(token, dest=1 % size, tag=tag)
        passes = 0
        done = False
        while not done:
            for r in list(range(1, size)) + [0]:
                buf = np.zeros(1, np.int32)
                world.as_rank(r).recv(buf, source=(r - 1) % size, tag=tag)
                passes += 1
                if r == 0:
                    buf[0] -= 1
                    print(f"rank 0: token now {buf[0]}")
                    if buf[0] == 0:
                        done = True
                        break
                world.as_rank(r).send(buf, dest=(r + 1) % size, tag=tag)
        print(f"ring done: {passes} hops on {size} ranks")
    else:
        rank = world.rank
        token = np.array([10], dtype=np.int32)
        if rank == 0:
            world.send(token, dest=(rank + 1) % size, tag=tag)
        while True:
            world.recv(token, source=(rank - 1) % size, tag=tag)
            if rank == 0:
                token[0] -= 1
                print(f"rank 0: token now {token[0]}")
            if token[0] == 0 and rank == 0:
                # let the token die at rank 0 after telling the ring once more
                world.send(token, dest=(rank + 1) % size, tag=tag)
                break
            world.send(token, dest=(rank + 1) % size, tag=tag)
            if token[0] == 0:
                break
        print(f"rank {rank} exiting")
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
