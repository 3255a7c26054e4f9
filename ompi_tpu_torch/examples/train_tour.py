"""Flagship training-step tour: every parallel-layer knob, one run each.

The counterpart of the JAX package's ``examples/train_tour.py``.  Runs the
composed dp/pp/sp/tp training step (``dp=2,pp=2,sp=2,tp=1``) on the 8
virtual ranks under each configuration the framework exposes, printing the
one-step loss so the effect of each knob is visible:

  baseline   f32, dense attention, store-all activations, allreduce dp
  causal     autoregressive masking at global sequence positions
  remat      per-block rematerialization (torch.utils.checkpoint)
  bf16       bfloat16 compute precision (f32 master storage + loss)
  zero1      ZeRO-1: reduce-scattered grads + dp-sharded momentum
  the works  all of the above composed

Each configuration runs two steps and fails unless the loss descends; the
vars are restored afterwards.

    python -m ompi_tpu_torch.examples.train_tour [--device cpu] [--lr LR]

``--device`` names the device of the ranks' tensors (default: the card,
where ring attention's block update is K21: its float32 body, and its
bfloat16 body under bf16 and the works).  ``--lr`` defaults to the
reference's 1e-4; at ``OTPU_MODEL_SCALE=64`` that overshoots, and 1e-5
descends.
"""
import argparse

from ompi_tpu_torch.base import cudaenv

SPEC = "dp=2,pp=2,sp=2,tp=1"
KNOBS = {
    "otpu_parallel_causal": False,
    "otpu_parallel_remat": False,
    "otpu_parallel_compute_dtype": "float32",
    "otpu_parallel_zero1": False,
    "otpu_parallel_momentum": 0.0,
}
#: the tour's configurations: tag -> the knobs it changes
CONFIGS = {
    "baseline": {},
    "causal": {"otpu_parallel_causal": True},
    "remat": {"otpu_parallel_remat": True},
    "bf16": {"otpu_parallel_compute_dtype": "bfloat16"},
    "zero1": {"otpu_parallel_zero1": True, "otpu_parallel_momentum": 0.9},
    "the works": {"otpu_parallel_causal": True, "otpu_parallel_remat": True,
                  "otpu_parallel_compute_dtype": "bfloat16",
                  "otpu_parallel_zero1": True,
                  "otpu_parallel_momentum": 0.9},
}


def main(argv=None) -> dict:
    """Returns ``{tag: {"loss": first-step loss, "launches": K21 launches,
    "bodies": K21 launches by body}}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the ranks' tensors (default: the card)")
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="SGD learning rate (default: the reference's 1e-4)")
    args = ap.parse_args(argv)
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.ops import flash_attention
    from ompi_tpu_torch.parallel import train  # noqa: F401  (registers the knobs)
    from ompi_tpu_torch.parallel.dryrun import parse_spec, run_training_step

    device = cudaenv.resolve_device(args.device)
    spec = parse_spec(SPEC)
    saved = {k: registry.lookup(k).value for k in KNOBS}
    results = {}

    def run(tag, **over):
        for k, dv in KNOBS.items():
            registry.lookup(k).set(over.get(k, dv))
        launched = flash_attention.launches["flash_block"]
        bodies = dict(flash_attention.bodies)
        loss = run_training_step(device, spec, lr=args.lr)
        print(f"{tag:10s} loss {float(loss):10.4f}")
        results[tag] = {
            "loss": float(loss),
            "launches": flash_attention.launches["flash_block"] - launched,
            "bodies": {k: v - bodies[k]
                       for k, v in flash_attention.bodies.items()}}

    try:
        for tag, over in CONFIGS.items():
            run(tag, **over)
    finally:
        for k, v in saved.items():
            registry.lookup(k).set(v)
    print("TRAIN TOUR OK")
    return results


if __name__ == "__main__":
    main()
