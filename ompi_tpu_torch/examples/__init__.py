"""Runnable examples of the port (``python -m ompi_tpu_torch.examples.<name>``)."""
