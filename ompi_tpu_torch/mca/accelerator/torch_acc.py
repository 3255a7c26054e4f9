"""accelerator/torch — device residency and staging for the port.

Port of the device half of ``ompi_tpu/mca/accelerator/jax_acc.py``:
``is_device_array`` tells the coll decision path (coll/conductor) whether a
buffer is a device buffer, which goes to the device collective slots
(``*_array``), or a host buffer, which the conductor folds with numpy;
``to_host``/``from_host`` stage across.  As in the reference, where any
``jax.Array`` counts, CPU-backed ones included, any ``torch.Tensor`` counts,
whatever its device: the CPU lane takes the same route as the card.

Not ported yet: the host staging pool (``_StagingPool``), the RMA
registration cache (``register``/``deregister``/``lookup``) and the
framework's component (``JaxAcceleratorComponent``), whose users are
host-tier modules.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv


def is_device_array(x: Any) -> bool:
    """True if ``x`` is a torch tensor (on any device)."""
    return isinstance(x, torch.Tensor)


def to_host(x) -> np.ndarray:
    """Stage a device buffer to host memory (D2H); bfloat16 comes back as
    ml_dtypes.bfloat16, as the JAX package returns it."""
    if isinstance(x, torch.Tensor):
        return cudaenv.to_numpy(x)
    return np.asarray(x)


def from_host(arr, device=None) -> torch.Tensor:
    """Stage host memory to ``device`` (H2D; default: the card)."""
    return cudaenv.make_world_array(arr, cudaenv.resolve_device(device))
