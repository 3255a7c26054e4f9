"""Hand-written kernels for the card, each with its plain PyTorch version:
``reduce`` (Triton folds) and ``ring_collectives`` (CUDA C++ ring
all-reduce, sources in ``ompi_tpu_torch/csrc``, built by ``_build``)."""
