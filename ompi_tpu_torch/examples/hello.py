"""Hello world — the ``examples/hello_c.c`` equivalent.

The counterpart of the JAX package's ``examples/hello.py``: prints rank and
size plus the facts a user checks first.  Runs in both process models:

- device world (default): one process drives all ranks,
  ``python -m ompi_tpu_torch.examples.hello``;
- multi-process: ``python -m ompi_tpu_torch.tools.tpurun -n 4 python -m
  ompi_tpu_torch.examples.hello``.

``--device`` names the device the world binds to (default: the card;
``--device cpu`` where there is none).
"""
import argparse

import ompi_tpu_torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    print(f"Hello, world, I am {world.rank} of {world.size} "
          f"(ompi_tpu_torch {ompi_tpu_torch.__version__}, comm {world.name})",
          flush=True)
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
