"""accelerator/torch — device residency and staging for the port.

Port of the device half of ``ompi_tpu/mca/accelerator/jax_acc.py``:
``is_device_array`` tells the coll decision path (coll/conductor) whether a
buffer is a device buffer, which goes to the device collective slots
(``*_array``), or a host buffer, which the conductor folds with numpy;
``to_host``/``from_host`` stage across.  As in the reference, where any
``jax.Array`` counts, CPU-backed ones included, any ``torch.Tensor`` counts,
whatever its device: the CPU lane takes the same route as the card.

The host tier meets a tensor in two places: point-to-point's
``as_buffer`` and coll/basic's send buffers, both of which stage it through
``to_host`` (a D2H copy on the card into pageable host memory, the copy
``Tensor.cpu()`` makes), as the reference's ``np.asarray`` stages a
``jax.Array``.

Not ported yet: the host staging pool (``_StagingPool``, whose one caller
in the reference is coll/algorithms), the RMA registration cache
(``register``/``deregister``/``lookup``, for the one-sided btl segments)
and the framework's component (``JaxAcceleratorComponent``); ROADMAP A 4.
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
