"""Device resolution for the port: the world's device, its size, and lanes.

Takes the place of ``ompi_tpu/base/jaxenv.py``.  Three questions live here:

* Which device holds the world?  ``resolve_device``: the card (``cuda:0``)
  unless the caller names another device.  With no card and no explicit
  ``device="cpu"`` it raises — it never falls back to the CPU.
* How many virtual ranks does the world have?  ``virtual_ranks``: the
  ``otpu_rte_virtual_ranks`` var (``OTPU_MCA_rte_virtual_ranks``), default
  8 — the counterpart of ``--xla_force_host_platform_device_count=8`` that
  gives the JAX package its 8-rank CPU mesh.
* Kernel or plain version?  ``on_card``: decided by the tensor's device
  alone.  A CUDA tensor goes to the hand-written kernel; a CPU tensor to
  the kernel's plain PyTorch version (the analog of Pallas interpret mode,
  ``jaxenv.pallas_interpret_default``).

``make_world_array``/``to_numpy`` carry data across from and to the numpy
``(n, ...)`` stacks that the JAX package's ``make_world_array`` takes and
``np.asarray(jax_array)`` returns.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.base.var import VarType, registry

_ranks_var = registry.register(
    "rte", "", "virtual_ranks", vtype=VarType.INT, default=8,
    help="Number of virtual ranks of the device world: rank i is row i of "
         "one world tensor on the world's device")


def virtual_ranks() -> int:
    n = int(_ranks_var.value)
    if n < 1:
        raise ValueError(f"otpu_rte_virtual_ranks must be >= 1, got {n}")
    return n


def resolve_device(device=None) -> torch.device:
    """The world's device: ``device`` if given, else the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "world on the CPU lane (plain versions of the kernels)")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` goes to a hand-written kernel, False for the plain
    version: the tensor's device alone decides."""
    return t.is_cuda


def make_world_array(host_stack, device) -> torch.Tensor:
    """A numpy stack (or anything ``np.asarray`` takes) as a tensor on
    ``device``.  bfloat16 arrays (ml_dtypes, as JAX returns them) cross
    as their 16-bit patterns."""
    arr = np.ascontiguousarray(np.asarray(host_stack))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor back as a numpy array (bfloat16 as ml_dtypes.bfloat16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
