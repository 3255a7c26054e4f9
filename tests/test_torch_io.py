"""MPI-IO in the port (``mca/io``, ``api/file.py``), held against the JAX
package: the same inputs through both packages' ``File`` must leave
byte-identical files.

* the file view: ``view_extents`` equal to the reference's for contiguous,
  vector, subarray and resized filetypes, and ``_coalesce_runs``;
* one process: individual and pointer I/O, strided views, ``(buffer,
  count, Datatype)`` triples, external32 and user datareps, the split
  collectives, the ordered and shared pointers, the nonblocking calls and
  the error cases — each file compared with the reference's byte for byte;
* tensors: a tensor written through a File is staged to the host; a read
  into a tensor raises ValueError (read-only, as the reference's view of a
  ``jax.Array`` is) and leaves it untouched, also as a triple;
* between processes: each package's ``tpurun -n 2`` and ``-n 4`` job
  writes with ``write_at_all`` through subarray views, a ragged pattern of
  two islands and a rank-ordered region, under ``io_ompio_fcoll`` static
  and dynamic, reads it all back collectively, and leaves the same bytes.
"""
import hashlib
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PKGS = ("ompi_tpu", "ompi_tpu_torch")


def _mod(pkg, name):
    return __import__(f"{pkg}.{name}", fromlist=["x"])


def _types(pkg):
    """The same filetypes built in one package's datatype engine."""
    core = _mod(pkg, "datatype.core")
    f64 = core.from_numpy_dtype(np.float64)
    return {
        "byte": core.BYTE,
        "vector": core.vector(2, 2, 4, f64),
        "vector_gap": core.vector(4, 1, 2, f64),
        "subarray": core.subarray([6, 10], [3, 5], [3, 5], core.ORDER_C, f64),
        "subarray_f": core.subarray([4, 6], [2, 3], [1, 2], core.ORDER_FORTRAN,
                                    f64),
        "resized": core.resized(core.vector(2, 1, 3, f64), 0, 64),
        "islands": core.vector(2, 256, 1 << 20, core.BYTE),
    }


@pytest.mark.parametrize("name", sorted(_types("ompi_tpu_torch")))
@pytest.mark.parametrize("disp,start,nbytes", [(0, 0, 48), (100, 8, 200),
                                               (7, 3, 1), (0, 0, 0)])
def test_view_extents_equal_the_reference(name, disp, start, nbytes):
    runs = {}
    for pkg in PKGS:
        ompio = _mod(pkg, "mca.io.ompio")
        ft = _types(pkg)[name]
        runs[pkg] = list(ompio.view_extents(disp, ft, start, nbytes))
        assert runs[pkg] == list(ompio.view_extents(disp, ft, start,
                                                    nbytes))
    assert runs["ompi_tpu_torch"] == runs["ompi_tpu"]
    assert sum(ln for _, ln in runs["ompi_tpu_torch"]) == nbytes
    port = _mod("ompi_tpu_torch", "mca.io.ompio")._coalesce_runs(
        runs["ompi_tpu_torch"])
    assert port == _mod("ompi_tpu", "mca.io.ompio")._coalesce_runs(
        runs["ompi_tpu"])


# ------------------------------------------------------------ one process

def _scenario_individual(pkg, path):
    fm = _mod(pkg, "api.file")
    f = fm.File.open(None, path, "c+")
    data = np.arange(100, dtype=np.float32)
    assert f.write_at(0, data) == 400
    back = np.zeros(100, np.float32)
    assert f.read_at(0, back) == 100
    assert np.array_equal(back, data)
    f.seek(0)
    f.write(np.array([7, 8, 9], np.int64))
    assert f.get_position() == 24
    f.seek(8)
    one = np.zeros(1, np.int64)
    f.read(one)
    assert one[0] == 8
    assert f.get_size() == 400
    f.seek(-8, fm.SEEK_END)
    assert f.get_position() == 392
    f.set_size(200)
    f.preallocate(256)
    f.sync()
    assert f.get_size() == 256
    f.set_atomicity(True)
    assert f.get_atomicity() and f.get_amode() & fm.MODE_CREATE
    f.close()


def _scenario_strided(pkg, path):
    fm = _mod(pkg, "api.file")
    core = _mod(pkg, "datatype.core")
    f64 = core.from_numpy_dtype(np.float64)
    f = fm.File.open(None, path, "c+")
    ft = core.vector(4, 1, 2, f64)
    f.set_view(0, f64, ft)
    f.write_at(0, np.array([1., 2., 3., 4.]))
    f.set_view(8, f64, ft)
    f.write_at(0, np.array([10., 20., 30., 40.]))
    assert f.get_view()[0] == 8
    f.set_view(0, f64, f64)
    allv = np.zeros(8)
    f.read_at(0, allv)
    assert allv.tolist() == [1., 10., 2., 20., 3., 30., 4., 40.]
    # a subarray view: a 3 x 5 block of a 6 x 10 array, twice
    sub = core.subarray([6, 10], [3, 5], [3, 5], core.ORDER_C, f64)
    f.set_view(64, f64, sub)
    f.write_at(0, np.arange(15, dtype=np.float64) + 0.5)
    f.write_at(15, np.arange(15, dtype=np.float64) * -1)
    assert f.get_byte_offset(1) == 64 + (3 * 10 + 5 + 1) * 8
    back = np.zeros(30)
    f.read_at(0, back)
    assert back[:15].tolist() == (np.arange(15) + 0.5).tolist()
    f.close()


def _scenario_triples(pkg, path):
    fm = _mod(pkg, "api.file")
    core = _mod(pkg, "datatype.core")
    errors = _mod(pkg, "api.errors")
    f64 = core.from_numpy_dtype(np.float64)
    f = fm.File.open(None, path, "c+")
    mem = np.arange(8, dtype=np.float64)
    mt = core.vector(4, 1, 2, f64)
    f.write_at(0, (mem, 1, mt))                  # 0, 2, 4, 6
    back = np.zeros(4)
    f.read_at(0, back)
    assert back.tolist() == [0., 2., 4., 6.]
    dst = np.zeros(8)
    f.read_at(0, (dst, 1, mt))
    assert dst.tolist() == [0., 0., 2., 0., 4., 0., 6., 0.]
    f.seek(0)
    dst2 = np.zeros(8)
    f.read((dst2, 1, mt))
    assert f.get_position() == 32
    with pytest.raises(errors.MpiError):
        f.seek(0, whence=9)
    with pytest.raises(errors.MpiError):
        f.seek(-1)
    # external32: big-endian on the file side, native in memory
    f.set_view(64, f64, f64, datarep="external32")
    f.write_at(0, np.array([1.5, -2.25]))
    got = np.zeros(2)
    f.read_at(0, got)
    assert got.tolist() == [1.5, -2.25]
    assert f.get_type_extent(mt) == mt.size
    f.close()
    with pytest.raises(errors.MpiError):
        f.write(np.zeros(1))                     # closed file
    raw = np.fromfile(path, np.uint8)[64:80].view(">f8")
    assert raw.tolist() == [1.5, -2.25]


def _scenario_split_ordered_nonblocking(pkg, path):
    fm = _mod(pkg, "api.file")
    f = fm.File.open(None, path, fm.MODE_CREATE | fm.MODE_RDWR)
    data = np.arange(8, dtype=np.int32)
    f.write_all_begin(data)
    with pytest.raises(RuntimeError):
        f.write_all_begin(data)                  # one outstanding
    with pytest.raises(RuntimeError):
        f.read_all_end(data)                     # mismatched kind
    assert f.write_all_end(data) == data.nbytes
    with pytest.raises(RuntimeError):
        f.write_all_end(data)                    # end without begin
    f.seek(0)
    out = np.zeros_like(data)
    f.read_all_begin(out)
    with pytest.raises(RuntimeError):
        f.read_all_end(np.zeros_like(data))      # another buffer
    f.read_all_end(out)
    assert np.array_equal(out, data)
    two = data * 2
    f.write_at_all_begin(32, two)
    f.write_at_all_end(two)
    back = np.zeros_like(data)
    f.read_at_all_begin(32, back)
    f.read_at_all_end(back)
    assert np.array_equal(back, two)
    # ordered and shared pointers
    f.seek_shared(64)
    a = np.arange(4, dtype=np.float32)
    b = np.arange(4, 8, dtype=np.float32)
    assert f.write_ordered(a) == a.nbytes
    f.write_ordered_begin(b)
    assert f.write_ordered_end(b) == b.nbytes
    assert f.get_position_shared() == 96
    f.write_shared(np.full(2, 9.0, np.float32))
    f.seek_shared(64)
    got = np.zeros(10, np.float32)
    f.read_ordered_begin(got)
    f.read_ordered_end(got)
    assert got.tolist() == list(range(8)) + [9.0, 9.0]
    f.seek_shared(64)
    one = np.zeros(2, np.float32)
    f.read_shared(one)
    assert one.tolist() == [0.0, 1.0]
    # nonblocking forms (eager requests)
    f.seek(104)
    r = f.iwrite(data * 3)
    r.wait()
    assert r.result == data.nbytes
    f.seek(104)
    got3 = np.zeros_like(data)
    f.iread(got3).wait()
    assert np.array_equal(got3, data * 3)
    f.iwrite_at(136, data).wait()
    f.iwrite_at_all(168, data + 1).wait()
    got4 = np.zeros_like(data)
    f.iread_at_all(168, got4).wait()
    assert np.array_equal(got4, data + 1)
    f.iwrite_shared(np.full(1, 5, np.int32)).wait()
    f.seek(200)
    f.iwrite_all(data).wait()
    f.seek(200)
    got5 = np.zeros_like(data)
    f.iread_all(got5).wait()
    f.iread_at(136, got4).wait()
    f.iread_shared(np.zeros(1, np.int32)).wait()
    assert np.array_equal(got5, data) and np.array_equal(got4, data)
    f.close()


def _scenario_errors(pkg, path):
    fm = _mod(pkg, "api.file")
    errors = _mod(pkg, "api.errors")
    with pytest.raises(errors.MpiError):
        fm.File.delete(path + ".missing")
    with pytest.raises(errors.MpiError):
        fm.File.open(None, path, "q")            # bad amode char
    f = fm.File.open(None, path, "c+")
    f.write_at(0, np.arange(4, dtype=np.int16))
    with pytest.raises(errors.MpiError):
        f.set_view(0, None, None, datarep="nope")
    core = _mod(pkg, "datatype.core")
    with pytest.raises(errors.MpiError):
        # filetype size not a multiple of the etype's
        f.set_view(0, core.from_numpy_dtype(np.float64), core.BYTE)
    f.close()
    with pytest.raises(errors.MpiError):
        f.read_at(0, np.zeros(1))
    with pytest.raises(errors.MpiError):
        fm.File.open(None, path, "cx+")          # exists: EXCL
    g = fm.File.open(None, path + ".tmp", "c+d")
    g.write_at(0, np.zeros(4, np.uint8))
    g.close()
    assert not os.path.exists(path + ".tmp")     # delete on close


SCENARIOS = {"individual": _scenario_individual,
             "strided": _scenario_strided, "triples": _scenario_triples,
             "split_ordered_nonblocking": _scenario_split_ordered_nonblocking,
             "errors": _scenario_errors}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_single_process_files_equal_the_reference(name, tmp_path):
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"{pkg}.dat")
        SCENARIOS[name](pkg, paths[pkg])
    assert Path(paths["ompi_tpu_torch"]).read_bytes() \
        == Path(paths["ompi_tpu"]).read_bytes()


def test_user_datarep_round_trip(tmp_path):
    """``register_datarep``: a size-preserving user representation (a byte
    reversal of the stream) in both packages, the same file."""
    files = {}
    for pkg in PKGS:
        fm = _mod(pkg, "api.file")
        name = "reverse_io_test"
        if name not in fm._datareps:
            fm.register_datarep(name, lambda b, et: b[::-1],
                                lambda b, et: b[::-1])
        errors = _mod(pkg, "api.errors")
        with pytest.raises(errors.MpiError):
            fm.register_datarep("native", None, None)
        path = str(tmp_path / f"{pkg}.rep")
        f = fm.File.open(None, path, "c+")
        f.set_view(0, None, None, datarep=name)
        f.write_at(0, np.arange(6, dtype=np.uint8))
        back = np.zeros(6, np.uint8)
        f.read_at(0, back)
        assert back.tolist() == list(range(6))
        f.close()
        files[pkg] = Path(path).read_bytes()
    assert files["ompi_tpu_torch"] == files["ompi_tpu"] == bytes(range(6))[
        ::-1]


def test_top_level_file_and_comm_self(tmp_path):
    import ompi_tpu_torch
    from ompi_tpu_torch.mca.io.ompio import OmpioModule
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    try:
        ompi_tpu_torch.init(device="cpu")
        f = ompi_tpu_torch.File.open(ompi_tpu_torch.COMM_SELF,
                                     str(tmp_path / "self.dat"), "c+")
        assert isinstance(f.io_module, OmpioModule)
        f.write_at_all(0, np.arange(6, dtype=np.int64))
        back = np.zeros(6, np.int64)
        f.read_at_all(0, back)
        assert back.tolist() == list(range(6))
        assert f.get_group().size == 1
        f.close()
    finally:
        rt.reset_for_testing()


def test_tensors_staged_on_write_read_only_on_read(tmp_path):
    import torch

    from ompi_tpu_torch.api.file import File
    from ompi_tpu_torch.datatype import core

    path = str(tmp_path / "t.dat")
    f = File.open(None, path, "c+")
    x = torch.arange(10, dtype=torch.float32)
    assert f.write_at(0, x) == 40
    f32 = core.from_numpy_dtype(np.float32)
    f.write_at(40, (torch.arange(8, dtype=torch.float32), 1,
                    core.vector(4, 1, 2, f32)))
    back = np.zeros(14, np.float32)
    f.read_at(0, back)
    assert back.tolist() == list(range(10)) + [0., 2., 4., 6.]
    dst = torch.zeros(10)
    with pytest.raises(ValueError, match="read-only"):
        f.read_at(0, dst)
    with pytest.raises(ValueError, match="read-only"):
        f.read_at(0, (dst, 1, core.vector(4, 1, 2, f32)))
    with pytest.raises(ValueError, match="read-only"):
        f.read(dst)
    # the tensor is untouched; the individual pointer moved before the
    # delivery failed, as in the reference (``read`` advances, then
    # unpacks)
    assert dst.tolist() == [0.0] * 10 and f.get_position() == 40
    f.close()
    assert Path(path).read_bytes() == np.concatenate(
        [np.arange(10, dtype=np.float32),
         np.array([0, 2, 4, 6], np.float32)]).tobytes()


# ------------------------------------------------------ between processes

MP_JOB = textwrap.dedent('''
    import hashlib, os, sys
    import numpy as np
    PKG, OUT = sys.argv[1], sys.argv[2]
    if PKG == "torch":
        import ompi_tpu_torch as m
        from ompi_tpu_torch.api.file import File
        from ompi_tpu_torch.base.var import registry
        from ompi_tpu_torch.datatype import core
        w = m.init(device="cpu")
    else:
        import ompi_tpu as m
        from ompi_tpu.api.file import File
        from ompi_tpu.base.var import registry
        from ompi_tpu.datatype import core
        w = m.init()
    r, n = w.rank, w.size
    f64 = core.from_numpy_dtype(np.float64)
    for alg in ("static", "dynamic"):
        out = OUT + "/" + alg
        os.makedirs(out, exist_ok=True)
        # 1. a (2n, 8) float64 array in row blocks of 2 x 8, subarrays
        G = [2 * n, 8]
        block = np.arange(16, dtype=np.float64).reshape(2, 8) + 100.0 * r
        ft = core.subarray(G, [2, 8], [2 * r, 0], core.ORDER_C, f64)
        f = File.open(w, out + "/dense.dat", "c+")
        registry.set("otpu_io_ompio_fcoll", alg)   # the io framework is open
        f.set_view(0, f64, ft)
        assert f.write_at_all(0, block) == block.nbytes
        back = np.zeros((2, 8))
        f.read_at_all(0, back)
        assert np.array_equal(back, block)
        f.set_view(0, f64, f64)
        whole = np.zeros(G)
        f.read_at_all(0, whole)
        f.close()
        # 2. a ragged pattern: two 256-byte islands 1 MB apart, a rank each
        f = File.open(w, out + "/ragged.dat", "c+")
        f.set_view(r * 256, core.BYTE,
                   core.vector(2, 256, 1 << 20, core.BYTE))
        data = np.concatenate([np.full(256, 10 * (r + 1), np.uint8),
                               np.full(256, 10 * (r + 1) + 5, np.uint8)])
        f.write_at_all(0, data)
        used = f.io_module.last_fcoll_alg
        f.set_view(0, core.BYTE, core.BYTE)
        isl = np.zeros(256 * n, np.uint8)
        f.read_at_all(1 << 20, isl)
        f.close()
        # 3. rank-ordered records and the shared pointer
        f = File.open(w, out + "/ordered.dat", "c+")
        f.write_ordered(np.full(r + 1, float(r), np.float32))
        w.barrier()
        f.seek_shared(0)
        w.barrier()
        mine = np.zeros(r + 1, np.float32)
        f.read_ordered(mine)
        assert mine.tolist() == [float(r)] * (r + 1)
        f.iwrite_at_all(4096 + 8 * r, np.array([r], np.int64)).wait()
        f.close()
        d = hashlib.sha256(whole.tobytes() + isl.tobytes()).hexdigest()[:16]
        print(f"IO {r} {alg} {used} {d}", flush=True)
    m.finalize()
''')


def _tpurun(pkg, n, script, args, extra=(), timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = ("ompi_tpu_torch.tools.tpurun" if pkg == "torch"
                else "ompi_tpu.tools.tpurun")
    p = subprocess.Popen(
        [sys.executable, "-m", launcher, "-n", str(n), *extra,
         sys.executable, str(script), pkg, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env, start_new_session=True)
    try:
        o, e = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    return subprocess.CompletedProcess(p.args, p.returncode, o, e)


def _tagged(stdout, tag):
    return sorted(line.partition("] ")[2] for line in stdout.splitlines()
                  if line.partition("] ")[2].startswith(tag))


@pytest.mark.parametrize("n", [2, 4])
def test_collective_io_files_equal_the_reference(tmp_path, n):
    """Each package's job writes and reads the three files under the static
    and then the dynamic partition (two aggregators): the same lines and
    the same bytes."""
    script = tmp_path / "io_job.py"
    script.write_text(MP_JOB)
    rows, files = {}, {}
    for pkg in ("torch", "jax"):
        out = tmp_path / pkg
        out.mkdir()
        res = _tpurun(pkg, n, script, [str(out)],
                      extra=("--mca", "io_ompio_num_aggregators", "2"))
        assert res.returncode == 0, (pkg, res.stdout[-3000:],
                                     res.stderr[-3000:])
        rows[pkg] = _tagged(res.stdout, "IO ")
        files[pkg] = {f"{alg}/{name}": hashlib.sha256(
            (out / alg / name).read_bytes()).hexdigest()
            for alg in ("static", "dynamic")
            for name in ("dense.dat", "ragged.dat", "ordered.dat")}
    assert len(rows["torch"]) == 2 * n
    assert rows["torch"] == rows["jax"]
    for row in rows["torch"]:
        _, _, alg, used, _ = row.split()
        assert used == alg, row
    assert files["torch"] == files["jax"]
    for alg in ("static", "dynamic"):
        dense = np.fromfile(tmp_path / "torch" / alg / "dense.dat",
                            np.float64).reshape(2 * n, 8)
        for r in range(n):
            assert np.array_equal(dense[2 * r:2 * r + 2],
                                  np.arange(16).reshape(2, 8) + 100.0 * r)
