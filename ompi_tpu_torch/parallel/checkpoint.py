"""Checkpoint and restore of a tree of tensors.

Copy of ``ompi_tpu/parallel/checkpoint.py`` (the reference's checkpoint
story, BLCR, was removed before v5; ULFM leaves forward recovery to the
application): save a tree (dicts, lists, tuples) of tensors or numpy arrays
so that a restarted, possibly re-shaped, job can restore it.

Two paths, matching the two process models:

- **Single controller (device world)**: one process owns every row, so
  each leaf, a leading rank axis included, is written dense and row-major
  as one file, beside a JSON manifest of the tree's structure, shapes and
  dtypes (``checkpoint.py:84-116``).
- **Multi-process**: each rank writes only ITS OWN blocks (a :class:`Shard`
  states where its block sits in the global shape) through a subarray file
  view with ``File.write_at_all``, the two-phase collective path
  (``checkpoint.py:127-180``), producing the same dense file.

Format: ``<dir>/manifest.json`` plus one ``<dir>/<name>.bin`` a leaf, the
dtype named as numpy names it — the JAX package's format byte for byte, so
a checkpoint written by either package loads in the other.

``load(directory, device=...)`` puts every leaf on the card by default, or
on the device named (``device="cpu"``); it takes the place of the
reference's ``sharding`` argument, since the port's device world is the
rows of one tensor, resharded by indexing.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np


def op_max():
    from ompi_tpu_torch.api import op as op_mod

    return op_mod.MAX


def _flatten(tree, prefix="") -> list:
    """(path, leaf) pairs in deterministic order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}{i}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(skeleton, values: dict, prefix=""):
    if isinstance(skeleton, dict):
        return {k: _unflatten(skeleton[k], values, f"{prefix}{k}/")
                for k in skeleton}
    if isinstance(skeleton, (list, tuple)):
        seq = [_unflatten(v, values, f"{prefix}{i}/")
               for i, v in enumerate(skeleton)]
        return type(skeleton)(seq)
    return values[prefix.rstrip("/")]


def _host(leaf) -> np.ndarray:
    """A leaf as a contiguous host array (a tensor is staged D2H)."""
    from ompi_tpu_torch.api.comm import host_buffer

    return np.ascontiguousarray(host_buffer(leaf))


def _dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (the manifest's ``dtype``)."""
    from ompi_tpu_torch.api.comm import is_tensor

    if isinstance(leaf, Shard):
        return str(leaf.dtype)
    if is_tensor(leaf):
        import torch

        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


class Shard:
    """A rank's block of a globally sharded array (multi-process model):
    the caller states where its block sits in the global shape.  A tensor
    block is staged to the host here."""

    def __init__(self, block, starts, global_shape) -> None:
        self.block = _host(block)
        self.starts = [int(s) for s in starts]
        self.global_shape = list(global_shape)
        self.dtype = self.block.dtype

    @property
    def shape(self):
        return tuple(self.global_shape)


def _fname(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path) + ".bin"


def save(directory: str, tree, comm=None) -> None:
    """Checkpoint a tree of tensors or arrays into ``directory``.

    Collective over ``comm`` when given in the multi-process world (each
    rank writes its shards); the single controller writes everything
    otherwise (the device world included)."""
    leaves = _flatten(tree)
    rank = comm.rank if comm is not None else 0
    if rank == 0:
        os.makedirs(directory, exist_ok=True)
        manifest = {
            "leaves": {path: {"shape": (leaf.global_shape
                                        if isinstance(leaf, Shard)
                                        else list(leaf.shape)
                                        if hasattr(leaf, "shape")
                                        else list(np.shape(leaf))),
                              "dtype": _dtype_name(leaf),
                              "file": _fname(path)}
                       for path, leaf in leaves},
            "skeleton": _skeleton(tree),
        }
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if (comm is not None and comm.size > 1
            and not (comm.rte is not None and comm.rte.is_device_world)):
        comm.barrier()
        _save_multiprocess(directory, leaves, comm)
    else:
        # single controller (device world included): every row is
        # addressable here; write each leaf dense
        for path, leaf in leaves:
            arr = leaf.block if isinstance(leaf, Shard) else _host(leaf)
            arr.tofile(os.path.join(directory, _fname(path)))


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _save_multiprocess(directory: str, leaves, comm) -> None:
    """Each rank collectively writes the shards it owns through subarray
    file views (the fcoll two-phase path aggregates them)."""
    from ompi_tpu_torch.api.file import File
    from ompi_tpu_torch.datatype import core, from_numpy_dtype

    for path, leaf in leaves:
        fpath = os.path.join(directory, _fname(path))
        f = File.open(comm, fpath, "c+")
        if isinstance(leaf, Shard):
            global_shape, blocks = leaf.global_shape, \
                [(leaf.block, leaf.starts)]
        else:
            # a whole leaf is replicated: rank 0 writes its copy
            host = _host(leaf)
            global_shape, blocks = list(host.shape), \
                [(host, [0] * host.ndim)]
        blocks = [(b, s) for b, s in blocks
                  if list(b.shape) != global_shape or comm.rank == 0]
        # collective-call counts must match across ranks: pad to the max
        et_any = from_numpy_dtype(
            blocks[0][0].dtype if blocks else np.dtype(_dtype_name(leaf)))
        rounds = int(np.asarray(comm.allreduce(
            np.array([len(blocks)], np.int64), op_max())).ravel()[0])
        for i in range(rounds):
            if i < len(blocks):
                block, starts = blocks[i]
                et = from_numpy_dtype(block.dtype)
                if list(block.shape) == global_shape:
                    f.set_view(0, et, et)
                    f.write_at_all(0, block)
                else:
                    ft = core.subarray(global_shape, list(block.shape),
                                       [int(s) for s in starts],
                                       core.ORDER_C, et)
                    f.set_view(0, et, ft)
                    f.write_at_all(0, block)
            else:
                f.set_view(0, et_any, et_any)
                f.write_at_all(0, np.empty(0, np.uint8))
        f.close()


def _read_leaf(directory: str, meta: dict) -> np.ndarray:
    name = meta["dtype"]
    path = os.path.join(directory, meta["file"])
    if name == "bfloat16":
        # the 16-bit patterns, viewed as bfloat16 once on the tensor side
        return np.fromfile(path, dtype=np.uint16).reshape(meta["shape"])
    return np.fromfile(path, dtype=np.dtype(name)).reshape(meta["shape"])


def load(directory: str, device=None, comm=None):
    """Restore the tree.  ``device``: None puts every leaf on the card, a
    device (``"cpu"``) puts it there."""
    import torch

    from ompi_tpu_torch.base import cudaenv

    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    dev = cudaenv.resolve_device(device)
    values = {}
    for path, meta in manifest["leaves"].items():
        t = torch.from_numpy(_read_leaf(directory, meta))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        values[path] = t.to(dev)
    return _unflatten(manifest["skeleton"], values)
