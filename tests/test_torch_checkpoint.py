"""parallel/checkpoint in the port, held against the JAX package.

* the device world: a tree of tensors with a leading rank axis is written
  dense (one file a leaf plus ``manifest.json``) and loads back onto the
  device asked for, or as numpy; resharding is indexing of the loaded
  rows;
* one format: the same tree saved by either package leaves the same
  bytes, and a checkpoint written by either package loads in the other;
* between processes: each package's ``tpurun -n 4`` job saves its
  ``Shard``s (tensors in the port) and a replicated leaf through
  ``write_at_all``; the two checkpoint directories are byte-identical and
  restore in one process.
"""
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer0": {"w": rng.standard_normal((8, 4, 6)).astype(np.float32),
                   "b": np.arange(8 * 6, dtype=np.float64).reshape(8, 6)},
        "embed": [rng.integers(-9, 9, (8, 5)).astype(np.int32),
                  np.ones((8,), np.int8)],
        "step": np.array([7], np.int64),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree)
                for k2, v in _flat(x, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _dir_bytes(d):
    return {name: (Path(d) / name).read_bytes()
            for name in sorted(os.listdir(d))}


def test_device_world_save_load_reshard(tmp_path):
    from ompi_tpu_torch.parallel import checkpoint as ckpt

    tree = _to_torch(_tree_np())
    d = str(tmp_path / "ck")
    ckpt.save(d, tree)
    assert sorted(os.listdir(d)) == sorted(
        ["manifest.json", "layer0_w.bin", "layer0_b.bin", "embed_0.bin",
         "embed_1.bin", "step.bin"])
    back = ckpt.load(d, device="cpu")
    for path, want in _flat(tree).items():
        got = _flat(back)[path]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.numpy().tobytes() == want.numpy().tobytes(), path
    assert isinstance(back["embed"], list)
    # reshard: the 8-row world restored onto 4 ranks of 2 rows each (the
    # port's device world is the rows of one tensor, so indexing reshards)
    w4 = back["layer0"]["w"].reshape(4, 2, 4, 6)
    for r in range(4):
        assert torch.equal(w4[r], tree["layer0"]["w"][2 * r:2 * r + 2])
    # the default device is the card, which is absent here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load(d)


def test_bfloat16_leaf_round_trip(tmp_path):
    from ompi_tpu_torch.parallel import checkpoint as ckpt

    x = torch.linspace(-3, 3, 24, dtype=torch.bfloat16).reshape(8, 3)
    ckpt.save(str(tmp_path), {"x": x})
    back = ckpt.load(str(tmp_path), device="cpu")["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


def test_same_tree_same_bytes_in_both(tmp_path):
    from ompi_tpu.parallel import checkpoint as ref
    from ompi_tpu_torch.parallel import checkpoint as port

    tree = _tree_np(3)
    ref.save(str(tmp_path / "ref"), tree)
    port.save(str(tmp_path / "port_np"), tree)
    port.save(str(tmp_path / "port_t"), _to_torch(tree))
    want = _dir_bytes(tmp_path / "ref")
    assert _dir_bytes(tmp_path / "port_np") == want
    assert _dir_bytes(tmp_path / "port_t") == want


@pytest.mark.parametrize("writer", ["ompi_tpu", "ompi_tpu_torch"])
def test_either_package_loads_the_other(tmp_path, writer):
    import jax
    import jax.numpy as jnp

    from ompi_tpu.parallel import checkpoint as ref
    from ompi_tpu_torch.parallel import checkpoint as port

    tree = _tree_np(5)
    d = str(tmp_path / "ck")
    if writer == "ompi_tpu":
        # jax arrays as the JAX package saves them (float64 becomes
        # float32 without x64: the expectation is what jax holds)
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        ref.save(d, jtree)
        back = port.load(d, device="cpu")
        for path, leaf in _flat(jtree).items():
            want = np.asarray(leaf)
            got = _flat(back)[path]
            assert got.numpy().tobytes() == want.tobytes(), path
            assert str(got.numpy().dtype) == str(want.dtype)
    else:
        port.save(d, _to_torch(tree))
        back = ref.load(d)
        for path, want in _flat(tree).items():
            got = _flat(back)[path]
            assert got.dtype == want.dtype and got.tobytes() \
                == want.tobytes(), path


# ------------------------------------------------------ between processes

SAVER = textwrap.dedent('''
    import sys
    import numpy as np
    PKG, OUT = sys.argv[1], sys.argv[2]
    if PKG == "torch":
        import torch
        import ompi_tpu_torch as m
        from ompi_tpu_torch.parallel import checkpoint as ckpt
        w = m.init(device="cpu")
        mk = torch.from_numpy
    else:
        import ompi_tpu as m
        from ompi_tpu.parallel import checkpoint as ckpt
        w = m.init()
        mk = np.asarray
    r = w.rank
    gi, gj = divmod(r, 2)
    block = np.arange(15, dtype=np.float64).reshape(3, 5) + 100.0 * r
    tree = {
        "w": ckpt.Shard(mk(block), [gi * 3, gj * 5], [6, 10]),
        "v": ckpt.Shard(mk(np.full(4, r, np.int32)), [4 * r], [16]),
        "lr": mk(np.array([0.25])),     # replicated: rank 0 writes it
    }
    ckpt.save(OUT, tree, comm=w)
    print(f"saved rank {r}", flush=True)
    m.finalize()
''')


def _tpurun(pkg, script, out, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = ("ompi_tpu_torch.tools.tpurun" if pkg == "torch"
                else "ompi_tpu.tools.tpurun")
    p = subprocess.Popen(
        [sys.executable, "-m", launcher, "-n", "4", sys.executable,
         str(script), pkg, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env, start_new_session=True)
    try:
        o, e = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    return p.returncode, o, e


def test_multiprocess_sharded_save_same_bytes(tmp_path):
    from ompi_tpu_torch.parallel import checkpoint as ckpt

    script = tmp_path / "saver.py"
    script.write_text(SAVER)
    for pkg in ("torch", "jax"):
        rc, out, err = _tpurun(pkg, script, tmp_path / pkg)
        assert rc == 0 and out.count("saved") == 4, (pkg, out, err)
    assert _dir_bytes(tmp_path / "torch") == _dir_bytes(tmp_path / "jax")
    back = ckpt.load(str(tmp_path / "torch"), device="cpu")
    w = back["w"]
    assert w.shape == (6, 10) and w.dtype == torch.float64
    for r in range(4):
        gi, gj = divmod(r, 2)
        assert torch.equal(w[gi * 3:gi * 3 + 3, gj * 5:gj * 5 + 5],
                           torch.arange(15, dtype=torch.float64).reshape(
                               3, 5) + 100.0 * r)
    assert back["v"].tolist() == [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4
    assert back["lr"].tolist() == [0.25]
