"""ompi_tpu_torch — the PyTorch/CUDA port of ``ompi_tpu``.

A second package beside the JAX one, which stays the reference.  Same
Open MPI shaped design — MCA components with priority selection and a typed
var registry, communicators with a per-comm collective vtable — with the
device tier rebuilt on PyTorch: the device world is N virtual ranks held as
the rows of one tensor on one NVIDIA card, device collectives are torch
reductions (coll/builtin) or hand-written ring kernels (coll/ring, CUDA
C++), and the op framework's folds are hand-written Triton kernels
(op/cuda_vpu).  Point-to-point runs through pml/ob1 over btl/self in the
device world and over btl/sm between the processes that
``python -m ompi_tpu_torch.tools.tpurun`` launches (one rank a process,
the multi-process world, whose host collectives are coll/basic's); a
tensor handed to either is staged to the host.
One-sided communication (``Win`` over mca/osc: osc/device's window on
the card in the device world, osc/rdma's mapped segments or osc/pt2pt's
agent between processes) and the MPI environment (``init_thread``,
``wtime``, error handlers, user error classes) come as in the reference.
``ompi_tpu_torch.parallel`` runs the reference's flagship
training step (dp × pp × sp × tp) on the same virtual ranks, its ring
attention's block update a hand-written CUDA C++ kernel.  Each kernel has a
plain PyTorch version that serves CPU tensors, so the whole port runs on
the CPU for its tests.

The package imports torch and never jax, nor anything of ``ompi_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

# Lazy public API: importing the package stays cheap (no torch import).
_API = {
    "init": "ompi_tpu_torch.runtime.init",
    "finalize": "ompi_tpu_torch.runtime.init",
    "initialized": "ompi_tpu_torch.runtime.init",
    "finalized": "ompi_tpu_torch.runtime.init",
    "init_thread": "ompi_tpu_torch.runtime.init",
    "query_thread": "ompi_tpu_torch.runtime.interlib",
    "is_thread_main": "ompi_tpu_torch.runtime.interlib",
    "THREAD_SINGLE": "ompi_tpu_torch.runtime.interlib",
    "THREAD_FUNNELED": "ompi_tpu_torch.runtime.interlib",
    "THREAD_SERIALIZED": "ompi_tpu_torch.runtime.interlib",
    "THREAD_MULTIPLE": "ompi_tpu_torch.runtime.interlib",
    "wtime": "ompi_tpu_torch.api.env",
    "wtick": "ompi_tpu_torch.api.env",
    "get_processor_name": "ompi_tpu_torch.api.env",
    "get_version": "ompi_tpu_torch.api.env",
    "get_library_version": "ompi_tpu_torch.api.env",
    "alloc_mem": "ompi_tpu_torch.api.env",
    "free_mem": "ompi_tpu_torch.api.env",
    "COMM_WORLD": "ompi_tpu_torch.runtime.init",
    "COMM_SELF": "ompi_tpu_torch.runtime.init",
    "Comm": "ompi_tpu_torch.api.comm",
    "Group": "ompi_tpu_torch.api.group",
    "Request": "ompi_tpu_torch.api.request",
    "Datatype": "ompi_tpu_torch.datatype",
    "Op": "ompi_tpu_torch.api.op",
    "Info": "ompi_tpu_torch.api.info",
    "Win": "ompi_tpu_torch.api.win",
    "Status": "ompi_tpu_torch.api.status",
    "reduce_local": "ompi_tpu_torch.api.op",
    # built-in reduction operators (MPI_SUM & friends)
    "SUM": "ompi_tpu_torch.api.op",
    "PROD": "ompi_tpu_torch.api.op",
    "MAX": "ompi_tpu_torch.api.op",
    "MIN": "ompi_tpu_torch.api.op",
    "LAND": "ompi_tpu_torch.api.op",
    "LOR": "ompi_tpu_torch.api.op",
    "LXOR": "ompi_tpu_torch.api.op",
    "BAND": "ompi_tpu_torch.api.op",
    "BOR": "ompi_tpu_torch.api.op",
    "BXOR": "ompi_tpu_torch.api.op",
    "MAXLOC": "ompi_tpu_torch.api.op",
    "MINLOC": "ompi_tpu_torch.api.op",
    "REPLACE": "ompi_tpu_torch.api.op",
    "NO_OP": "ompi_tpu_torch.api.op",
}


def __getattr__(name: str):
    mod_name = _API.get(name)
    if mod_name is None:
        raise AttributeError(f"module 'ompi_tpu_torch' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(mod_name)
    if name == "COMM_WORLD":
        return mod.comm_world()
    if name == "COMM_SELF":
        return mod.comm_self()
    val = getattr(mod, name)
    globals()[name] = val
    return val
