"""Flagship demo: explicit-SPMD transformer training on a virtual-rank mesh.

The counterpart of the JAX package's ``examples/train_sharded.py``.  The
parallel layer end to end — dp/pp/sp/tp mesh, ring attention over sp (its
block update K21 on the card), Megatron-style tp matmuls, GPipe
microbatching over pp — with every cross-rank exchange an explicit
collective over the mesh's axes: ``parallel/dryrun.run_training_step``,
two descending steps on the default mesh and two on a pp = 2 mesh.

    python -m ompi_tpu_torch.examples.train_sharded [--device cpu] [--lr LR]

The ranks are the ``otpu_rte_virtual_ranks`` virtual ranks (default 8) on
``--device`` (default: the card).  ``--lr`` defaults to the reference's
1e-4; at ``OTPU_MODEL_SCALE=64`` that overshoots, and 1e-5 descends.
"""
import argparse

from ompi_tpu_torch.base import cudaenv


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the ranks' tensors (default: the card)")
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="SGD learning rate (default: the reference's 1e-4)")
    args = ap.parse_args(argv)
    from ompi_tpu_torch.parallel.dryrun import run_training_step

    device = cudaenv.resolve_device(args.device)
    print(f"training on {cudaenv.virtual_ranks()} virtual ranks of {device}")
    loss = run_training_step(device, lr=args.lr)
    print(f"done; initial loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
