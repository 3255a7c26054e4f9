"""The flagship training step on per-rank tensors: ``mesh`` (axis set),
``axes`` (the collectives of a shard_map body as tensor ops), ``model``
(transformer blocks, ring/Ulysses attention on K21), ``pipeline`` (GPipe
over pp), ``train`` (the step, its vars, ZeRO-1, bucketed sync) and
``dryrun`` (``make_step_and_args``, ``run_training_step``)."""
