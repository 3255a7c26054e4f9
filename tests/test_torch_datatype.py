"""The port's datatype engine held against the JAX package's:
``tests/test_datatype.py``'s cases, each type built by both packages from
the same constructor arguments and fed the same seeded bytes.  Pack (whole
and in chunks), and unpack with position resume (chunks out of order),
must give identical bytes; the type maps, sizes and extents must agree.
Both run their numpy loops here (the port has no native pack loop yet);
the reference's native loop gives the same bytes where it is built.
"""
import numpy as np
import pytest

import ompi_tpu.datatype as jdt
import ompi_tpu_torch.datatype as tdt


# every type of tests/test_datatype.py, as (builder, count)
TYPES = {
    "contiguous": (lambda d: d.contiguous(16, d.FLOAT32), 4),
    "vector": (lambda d: d.vector(3, 2, 5, d.FLOAT32), 3),
    "vector_f64": (lambda d: d.vector(4, 3, 7, d.FLOAT64), 2),
    "hvector": (lambda d: d.hvector(3, 2, 20, d.INT32), 2),
    "indexed": (lambda d: d.indexed([2, 1, 3], [0, 4, 9], d.INT32), 2),
    "indexed_block": (lambda d: d.indexed_block(2, [0, 5, 11], d.INT32), 3),
    "hindexed_descending": (lambda d: d.hindexed([1, 1], [8, 0], d.INT32), 1),
    "hindexed_block": (lambda d: d.hindexed_block(2, [0, 16], d.INT32), 2),
    "struct_mixed": (lambda d: d.create_struct(
        [2, 1, 4], [0, 8, 16], [d.INT32, d.FLOAT64, d.BYTE]), 3),
    "struct_coalesced": (lambda d: d.create_struct(
        [2, 2], [0, 8], [d.INT32, d.INT32]), 2),
    "resized": (lambda d: d.contiguous(3, d.resized(d.FLOAT32, -4, 16)), 2),
    "subarray_c": (lambda d: d.subarray([6, 8], [2, 3], [1, 2], d.ORDER_C,
                                        d.FLOAT32), 1),
    "subarray_fortran": (lambda d: d.subarray(
        [4, 5], [2, 2], [1, 3], d.ORDER_FORTRAN, d.INT32), 2),
    "darray_block_cyclic": (lambda d: d.darray(
        4, 1, [8, 8], [d.DISTRIBUTE_BLOCK, d.DISTRIBUTE_CYCLIC],
        [d.DISTRIBUTE_DFLT_DARG, 1], [2, 2], d.ORDER_C, d.INT32), 1),
    "bfloat16": (lambda d: d.vector(5, 3, 4, d.BFLOAT16), 3),
    "pair_float_int": (lambda d: d.contiguous(3, d.FLOAT_INT), 2),
    "structured_numpy": (lambda d: d.from_numpy_dtype(np.dtype(
        [("a", np.int32), ("b", np.float64), ("c", np.int8, (3,))],
        align=True)), 4),
}


def _span(dt, count):
    """Bytes a buffer needs to cover ``count`` elements (lb may be < 0:
    the convertor then starts at ``base_offset``)."""
    lo = min(0, dt.true_lb)
    hi = max(dt.true_ub, (count - 1) * dt.extent + dt.true_ub)
    return hi - lo, -lo


def _layout(dt):
    return ([(s.offset, str(s.dtype), s.count) for s in dt.segments],
            dt.size, dt.extent, dt.lb, dt.ub, dt.true_lb, dt.true_ub,
            dt.combiner)


def _pack_unpack(d, dt, count, chunk, seed):
    nbytes, base = _span(dt, count)
    src = np.random.default_rng(seed).integers(0, 255, max(nbytes, 1),
                                               dtype=np.uint8)
    cp = d.Convertor(dt, count, src, base_offset=base)
    if chunk is None:
        packed = cp.pack().tobytes()
    else:
        packed = b""
        while not cp.finished:
            packed += cp.pack(chunk).tobytes()
    # unpack with position resume: the second half first, then the first
    dst = np.zeros_like(src)
    cu = d.Convertor(dt, count, dst, base_offset=base)
    total = len(packed)
    for lo, hi in ((total // 2, total), (0, total // 2)):
        cu.set_position(lo)
        view = memoryview(packed)[lo:hi]
        while len(view):
            n = cu.unpack(view[:chunk] if chunk else view)
            view = view[n:]
    return packed, dst.tobytes()


@pytest.mark.parametrize("name", sorted(TYPES))
def test_type_map_matches(name):
    build, _ = TYPES[name]
    assert _layout(build(tdt)) == _layout(build(jdt))


@pytest.mark.parametrize("chunk", [None, 1, 5, 13, 64])
@pytest.mark.parametrize("name", sorted(TYPES))
def test_pack_unpack_bytes_match(name, chunk):
    build, count = TYPES[name]
    t_dt, j_dt = build(tdt), build(jdt)
    got = _pack_unpack(tdt, t_dt, count, chunk, seed=len(name))
    want = _pack_unpack(jdt, j_dt, count, chunk, seed=len(name))
    assert got == want
    assert len(got[0]) == count * t_dt.size


def test_named_types_match():
    for name, t in tdt.NAMED_TYPES.items():
        assert _layout(t) == _layout(jdt.NAMED_TYPES[name]), name


@pytest.mark.parametrize("chunk", [None, 13])
def test_external32_matches(chunk):
    data = np.random.default_rng(3).standard_normal(10)
    out = []
    for d in (tdt, jdt):
        c = d.Convertor(d.FLOAT64, 10, data.copy(),
                        flags=d.ConvertorFlags.EXTERNAL32)
        chunks = []
        while not c.finished:
            chunks.append(c.pack(chunk).tobytes())
        back = np.zeros(10)
        cu = d.Convertor(d.FLOAT64, 10, back,
                         flags=d.ConvertorFlags.EXTERNAL32)
        for ch in chunks:
            cu.unpack(ch)
        out.append(([len(ch) for ch in chunks], b"".join(chunks),
                    back.tobytes()))
    assert out[0] == out[1]
    assert np.frombuffer(out[0][1], ">f8").tolist() == data.tolist()


def test_checksum_matches():
    data = np.random.default_rng(4).standard_normal(100).astype(np.float32)
    sums = []
    for d in (tdt, jdt):
        c = d.Convertor(d.FLOAT32, 100, data.copy(),
                        flags=d.ConvertorFlags.CHECKSUM)
        c.pack(77)
        c.pack()
        sums.append(c.checksum)
    assert sums[0] == sums[1] != 0


def test_element_count_and_status_count_match():
    from ompi_tpu.api.status import Status as JStatus
    from ompi_tpu_torch.api.status import Status as TStatus

    for nbytes in (4, 12, 16, 40, 44, 48):
        got, want = [], []
        for d, status, acc in ((tdt, TStatus, got), (jdt, JStatus, want)):
            dt = d.create_struct([2, 1], [0, 8], [d.INT32, d.FLOAT64])
            st = status(_nbytes=nbytes)
            acc += [dt.element_count(nbytes), st.get_elements(dt),
                    st.get_count(dt), st.get_count(d.INT32)]
        assert got == want, nbytes


def test_device_flag_rejects_host_prepare():
    for d in (tdt, jdt):
        with pytest.raises(RuntimeError):
            d.Convertor(d.FLOAT32, 4, np.zeros(4, np.float32),
                        flags=d.ConvertorFlags.DEVICE)


def test_pack_unpack_api_matches():
    """MPI_Pack / Unpack / Pack_size, and their external32 forms."""
    src = np.random.default_rng(5).standard_normal(12)
    out = []
    for d in (tdt, jdt):
        dt = d.vector(3, 2, 4, d.FLOAT64)
        data = d.pack(src, 1, dt)
        dst = np.zeros(12)
        used = d.unpack(data, dst, 1, dt)
        d32 = d.pack(src[:4].astype(np.float32), 4, d.FLOAT32,
                     external32=True)
        out.append((data, d.pack_size(1, dt), used, dst.tobytes(), d32))
    assert out[0] == out[1]


def test_type_attributes_match():
    """MPI_Type_create_keyval / set_attr / get_attr / delete_attr and the
    copy callbacks at dup."""
    import ompi_tpu.api.attributes as jat
    import ompi_tpu_torch.api.attributes as tat

    seen = []
    for d, at in ((tdt, tat), (jdt, jat)):
        dt = d.vector(2, 1, 3, d.FLOAT32)
        kv_null = at.keyval_create()
        kv_dup = at.keyval_create(copy_fn=at.DUP_FN)
        dt.attr_put(kv_null, {"unit": "rows"})
        dt.attr_put(kv_dup, "shared")
        d2 = dt.dup()
        dt.attr_delete(kv_null)
        seen.append((d2.attr_get(kv_null), d2.attr_get(kv_dup),
                     dt.attr_get(kv_null), _layout(d2)[:3]))
        at.keyval_free(kv_null)
        at.keyval_free(kv_dup)
    assert seen[0] == seen[1]
    assert seen[0][:3] == ((False, None), (True, "shared"), (False, None))
