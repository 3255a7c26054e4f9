"""The byte mover of ``ompi_tpu_torch/csrc/pair_copy.cuh`` -- the one body of
K10, K11 (all-gather), K13 (right permute), K14 (all-to-all), K15 and K16
(the ragged pair) -- at the edges of its design, held against the JAX
package's Pallas kernels (``ompi_tpu/ops/pallas_collectives.py``).

The mover cuts the valid bytes of all pairs into equal spans of about 32
KB, aligned to 256 bytes, that the CTAs take in turn, moves each span in
16-byte multiples through a ring of 16 KB bulk-copy slots and copies each
pair's last ``nbytes % 16`` bytes apart; an unaligned pointer takes a byte
path over spans of the same length.  So the edges are: payloads that are
not 16-byte multiples (float16 ``(8, 1001)``, bool, totals of 1, 15, 16 and
17 bytes), one slot's length and 16 bytes either side, a stream of two
spans for every SM of an H100, views at storage offset 1, n = 1, 2, 3, 5,
8, an empty payload, and for the ragged pair counts tables that are
ragged, all zero, all R, or route every row to one expert.

On the CPU the same inputs (numpy, from a seed) go through the reference in
interpret mode (sub-meshes of the 8 virtual devices for n < 8) and through
the port's wrappers, which take their plain versions for CPU tensors: byte
for byte, the ragged pair over its valid rows.  The ``cuda`` cases (skipped
here) hold the kernels against the plain versions on the card, byte for
byte, and call the C entries directly to show that no byte past a pair's
count is written.

Under CUDA graph capture (``cuda`` cases): every mover entry given no
counter pair on a capturing stream returns 900, draws no slot of its
library's round-robin pool and launches nothing; a captured launch of K10
or K15 runs its span tickets on a counter pair that the graph owns, so a
replay started together with each of more eager launches than the pool has
slots, and two graphs captured a pool's length of launches apart and
replayed together on two streams, each stay byte-exact
(``tests/mover_capture.py``).
"""
import numpy as np
import pytest
import torch

import mover_capture as mc
from ompi_tpu.ops import pallas_collectives as pc
from ompi_tpu_torch.ops import ring_collectives as rc

SLOT = 16384            # bytes of one bulk-copy slot
SPAN = 32768            # bytes of one span
H100_SMS = 132


def _mesh(n: int):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:n]), ("x",))


def _run(fn, x, *args, **kw) -> np.ndarray:
    import jax

    return np.asarray(fn(jax.device_put(x), *args, **kw))


def _stack(dtype, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.integers(0, 2, shape).astype(bool)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def _offset_view(x: np.ndarray, device: str = "cpu") -> torch.Tensor:
    """``x`` as a contiguous tensor at storage offset 1 (the byte path)."""
    flat = torch.empty(x.size + 1, dtype=torch.from_numpy(x).dtype, device=device)
    view = flat[1:].view(x.shape)
    view.copy_(torch.from_numpy(x).to(device))
    assert view.storage_offset() == 1
    return view


#: all-gather edges: (dtype, (n, per-rank payload)); totals in bytes noted
GATHER_EDGES = {
    "float16 (8, 1001)": (np.float16, (8, 1001)),
    "bool (8, 37)": (np.bool_, (8, 37)),
    "n=1": (np.float32, (1, 6)),
    "n=2": (np.int8, (2, 17)),
    "n=3": (np.float32, (3, 1001)),
    "n=5, 15 bytes": (np.int8, (5, 3)),
    "n=8, 16 bytes": (np.int8, (8, 2)),
    "1 byte": (np.int8, (1, 1)),
    "17 bytes": (np.int8, (1, 17)),
    "one slot - 16 bytes": (np.int8, (8, (SLOT - 16) // 8)),
    "one slot": (np.int8, (8, SLOT // 8)),
    "one slot + 16 bytes": (np.int8, (8, (SLOT + 16) // 8)),
    "two spans for every SM": (np.float32, (8, H100_SMS * SPAN // 16 + 12)),
}


@pytest.mark.parametrize("variant", ["ring", "bidi"])
@pytest.mark.parametrize("edge", list(GATHER_EDGES))
def test_all_gather_edges_match_reference(edge, variant):
    """K10 (``ring``) and K11 (``bidi``; K10 for n <= 2, as the reference):
    the port's wrapper and its plain version against the reference."""
    dtype, shape = GATHER_EDGES[edge]
    x = _stack(dtype, shape, seed=len(edge))
    n = shape[0]
    want = _run(pc.all_gather, x, _mesh(n), "x", variant=variant)
    got = rc.all_gather(torch.from_numpy(x), n, variant)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    np.testing.assert_array_equal(_bytes(rc.all_gather_plain(torch.from_numpy(x), n)),
                                  _bytes(want))


@pytest.mark.parametrize("variant", ["ring", "bidi"])
def test_all_gather_from_storage_offset_one(variant):
    """A view at storage offset 1 (on the card: the byte path) gathers the
    same bytes as the reference."""
    x = _stack(np.int8, (8, 1001), seed=7)
    want = _run(pc.all_gather, x, _mesh(8), "x", variant=variant)
    got = rc.all_gather(_offset_view(x), 8, variant)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("variant", ["ring", "bidi"])
def test_all_gather_empty_payload(variant):
    """An empty payload gives an empty copy (the reference cannot trace an
    empty block: its ring divides by the block size)."""
    x = torch.zeros((8, 0), dtype=torch.float32)
    got = rc.all_gather(x, 8, variant)
    assert got.shape == (8, 0) and got.dtype == x.dtype and torch.equal(got, x)


#: right-permute and all-to-all edges: (dtype, n, per-rank or per-block payload)
EXCHANGE_EDGES = {
    "float16 n=8 1001": (np.float16, 8, 1001),
    "int8 n=3 17": (np.int8, 3, 17),
    "bool n=5 3": (np.bool_, 5, 3),
    "float32 n=2 1": (np.float32, 2, 1),
    "int8 n=8 4099": (np.int8, 8, 4099),          # 8 rows: two slots + 24 bytes
    "float32 n=8 1024": (np.float32, 8, 1024),    # 16-byte rows: the aligned path
    "int8 n=5 48": (np.int8, 5, 48),
}


@pytest.mark.parametrize("edge", list(EXCHANGE_EDGES))
def test_right_permute_edges_match_reference(edge):
    """K13 at odd sizes: ``out[(i+1) % n] = x[i]``."""
    dtype, n, per = EXCHANGE_EDGES[edge]
    x = _stack(dtype, (n, per), seed=per)
    want = _run(pc.right_permute, x, _mesh(n), "x")
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(_bytes(rc.right_permute(t, n)), _bytes(want))
    np.testing.assert_array_equal(_bytes(rc.right_permute_plain(t, n)), _bytes(want))


@pytest.mark.parametrize("edge", list(EXCHANGE_EDGES))
def test_all_to_all_edges_match_reference(edge):
    """K14 at odd block sizes: ``out[j, i] = x[i, j]``."""
    dtype, n, per = EXCHANGE_EDGES[edge]
    x = _stack(dtype, (n, n, per), seed=per)
    want = _run(pc.all_to_all, x, _mesh(n), "x")
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(_bytes(rc.all_to_all(t, n)), _bytes(want))
    np.testing.assert_array_equal(_bytes(rc.all_to_all_plain(t, n)), _bytes(want))


# -- the ragged pair (K15, K16) ----------------------------------------------

ROWS = 5                       # R: not a whole number of chunk_rows (8)


def _ragged_counts(shape, rows: int, seed: int) -> np.ndarray:
    """Counts over [-2, rows + 3], with a 0, an R, an R + 3 and a negative
    count forced in (as tests/test_torch_exchange.py's ``_counts``)."""
    c = np.random.default_rng(seed).integers(-2, rows + 4, shape)
    flat = c.reshape(-1)
    flat[:4] = (0, rows, rows + 3, -1)
    return c.astype(np.int32)


def _tables(shape) -> dict:
    one_expert = np.zeros(shape, np.int32)
    one_expert[..., 3] = ROWS                      # every row to expert 3
    return {"ragged": _ragged_counts(shape, ROWS, seed=4),
            "all zero": np.zeros(shape, np.int32),
            "all R": np.full(shape, ROWS, np.int32),
            "one expert": one_expert}


def _valid_equal(got: np.ndarray, want: np.ndarray, counts: np.ndarray) -> None:
    c = np.clip(counts, 0, ROWS)
    if c.ndim == 2:
        for i in range(c.shape[0]):
            for j in range(c.shape[1]):
                np.testing.assert_array_equal(_bytes(got[j, i, :c[i, j]]),
                                              _bytes(want[j, i, :c[i, j]]))
    else:
        for i in range(c.shape[0]):
            np.testing.assert_array_equal(_bytes(got[i, :c[i]]), _bytes(want[i, :c[i]]))


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("table", ["ragged", "all zero", "all R", "one expert"])
def test_all_to_all_v_tables_match_reference(table, dtype):
    """K15 with a ragged table, an all-zero one, an all-R one and one that
    routes every row to one expert, over the valid rows."""
    counts = _tables((8, 8))[table]
    x = _stack(dtype, (8, 8, ROWS, 128), seed=5)
    want = _run(pc.all_to_all_v, x, counts, _mesh(8), "x")
    t = torch.from_numpy(x)
    for out in (rc.all_to_all_v(t, counts, 8), rc.all_to_all_v_plain(t, counts, 8)):
        assert tuple(out.shape) == x.shape
        _valid_equal(out.numpy(), want, counts)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("table", ["ragged", "all zero", "all R", "one expert"])
def test_all_gather_v_tables_match_reference(table, dtype):
    """K16 with the same four kinds of table (row 0 of each)."""
    counts = _tables((8, 8))[table][0]
    x = _stack(dtype, (8, ROWS, 128), seed=6)
    want = _run(pc.all_gather_v, x, counts, _mesh(8), "x")
    t = torch.from_numpy(x)
    for out in (rc.all_gather_v(t, counts, 8), rc.all_gather_v_plain(t, counts, 8)):
        assert tuple(out.shape) == x.shape
        _valid_equal(out.numpy(), want, counts)


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(GATHER_EDGES))
def test_all_gather_edges_on_card(edge):
    """K10 and K11 against the plain version on the card, byte for byte,
    from an aligned tensor and from a view at storage offset 1."""
    _card()
    dtype, shape = GATHER_EDGES[edge]
    x = _stack(dtype, shape, seed=len(edge))
    n = shape[0]
    for t in (torch.from_numpy(x).cuda(), _offset_view(x, "cuda")):
        for variant in ("ring", "bidi"):
            got = rc.all_gather(t, n, variant)
            assert torch.equal(got.view(torch.uint8),
                               rc.all_gather_plain(t, n).view(torch.uint8)), \
                (edge, variant, t.data_ptr() % 16)


@pytest.mark.cuda
def test_all_gather_empty_payload_on_card():
    _card()
    x = torch.zeros((8, 0), device="cuda")
    before = dict(rc.launches)
    for variant in ("ring", "bidi"):
        got = rc.all_gather(x, 8, variant)
        assert got.shape == (8, 0) and got.is_cuda
    assert rc.launches == before


def _entry(lib: str, name: str):
    from ompi_tpu_torch.ops import _build

    return getattr(_build.load(lib), name)


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [1, 15, 16, 17, SLOT - 16, SLOT, SLOT + 16,
                                    H100_SMS * SPAN * 2 + 17])
def test_mover_totals_on_card(nbytes):
    """K10's entry on exactly ``nbytes`` bytes, aligned (vec 16) and from
    storage offset 1 (vec 1): the bytes arrive, and the byte past the end of
    the destination range is untouched."""
    _card()
    fn = _entry("ring_copy", "otpu_ring_all_gather")
    gen = torch.Generator(device="cuda").manual_seed(nbytes)
    src = torch.randint(0, 256, (nbytes + 64,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    stream = torch.cuda.current_stream().cuda_stream
    for vec, at in ((16, 0), (1, 1)):
        out = torch.full((nbytes + 64,), 0xAB, dtype=torch.uint8, device="cuda")
        assert fn(src[at:].data_ptr(), out[at:].data_ptr(), nbytes, vec, None,
                  stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out[at:at + nbytes], src[at:at + nbytes]), (nbytes, vec)
        assert bool((out[:at] == 0xAB).all()) and bool((out[at + nbytes:] == 0xAB).all())


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(EXCHANGE_EDGES))
def test_exchange_edges_on_card(edge):
    """K13 and K14 at odd sizes against their plain versions on the card."""
    _card()
    dtype, n, per = EXCHANGE_EDGES[edge]
    x = torch.from_numpy(_stack(dtype, (n, per), seed=per)).cuda()
    assert torch.equal(rc.right_permute(x, n).view(torch.uint8),
                       rc.right_permute_plain(x, n).view(torch.uint8))
    y = torch.from_numpy(_stack(dtype, (n, n, per), seed=per)).cuda()
    assert torch.equal(rc.all_to_all(y, n).view(torch.uint8),
                       rc.all_to_all_plain(y, n).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["ragged", "all zero", "all R", "one expert"])
def test_ragged_tables_on_card(table):
    """K15 and K16 with the four kinds of table against their plain versions
    over the valid rows, float32 and int8; then through the C entries into a
    filled output: every row past a count keeps the fill."""
    _card()
    tables = _tables((8, 8))
    a2a, agv = tables[table], tables[table][0]
    for dtype in (np.float32, np.int8):
        x = torch.from_numpy(_stack(dtype, (8, 8, ROWS, 128), seed=5)).cuda()
        _valid_equal(rc.all_to_all_v(x, a2a, 8).cpu().numpy(),
                     rc.all_to_all_v_plain(x, a2a, 8).cpu().numpy(), a2a)
        y = torch.from_numpy(_stack(dtype, (8, ROWS, 128), seed=6)).cuda()
        _valid_equal(rc.all_gather_v(y, agv, 8).cpu().numpy(),
                     rc.all_gather_v_plain(y, agv, 8).cpu().numpy(), agv)
    x = torch.from_numpy(_stack(np.float32, (8, 8, ROWS, 128), seed=5)).cuda()
    row = 128 * 4
    stream = torch.cuda.current_stream().cuda_stream
    for entry, src, counts in (("otpu_all_to_all_v", x, a2a),
                               ("otpu_all_gather_v", x[0], agv)):
        out = torch.full_like(src, float("nan"))
        table_d = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        assert _entry("exchange", entry)(src.data_ptr(), out.data_ptr(), table_d.data_ptr(),
                                         ROWS * row, row, 8, 16, None, stream) == 0
        want = (rc.all_to_all_v_plain(src, counts, 8) if counts.ndim == 2
                else rc.all_gather_v_plain(src, counts, 8))
        _valid_equal(out.cpu().numpy(), want.cpu().numpy(), counts)
        c = np.clip(counts, 0, ROWS)
        if c.ndim == 2:
            tails = [out[j, i, c[i, j]:] for i in range(8) for j in range(8)]
        else:
            tails = [out[i, c[i]:] for i in range(8)]
        assert all(bool(torch.isnan(t).all()) for t in tails), (entry, table)


# -- under CUDA graph capture ------------------------------------------------

#: rounds of each case: twice the pool and more, and 200 paired replays
BESIDE_ROUNDS = 2 * mc.TICKET_SLOTS + 100
APART_ROUNDS = 200
#: what a mover entry returns, having launched nothing, on a capturing
#: stream without a counter pair (cudaErrorStreamCaptureUnsupported)
NEEDS_COUNTER = 900


def _mover_call(entry: str):
    """(library, x, out, the entry's arguments between ``out`` and ``vec``,
    the counts tables they point to) on ``x`` (8, 8, 4, 256) int32 with
    every count full."""
    x = torch.arange(8 * 8 * 4 * 256, dtype=torch.int32, device="cuda")
    x = x.view(8, 8, 4, 256)
    out = torch.full_like(x, -1)
    rank, block = x[0].numel() * 4, x[0, 0].numel() * 4
    full = torch.full((8, 8), 4, dtype=torch.int32, device="cuda")
    rows = torch.full((8,), 32, dtype=torch.int32, device="cuda")
    args = {"otpu_ring_all_gather": ("ring_copy", (8 * rank,)),
            "otpu_ring_all_gather_bidi": ("ring_copy", (rank, 8)),
            "otpu_ring_right_permute": ("ring_copy", (rank, 8)),
            "otpu_all_to_all": ("exchange", (block, 8)),
            "otpu_all_to_all_v": ("exchange", (full.data_ptr(), block, 1024, 8)),
            # (8, 32, 256) rows: slot 32 KB, 32 rows a rank
            "otpu_all_gather_v": ("exchange", (rows.data_ptr(), rank, 1024,
                                               8))}
    lib, between = args[entry]
    return lib, x, out, between, (full, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["otpu_ring_all_gather",
                                   "otpu_ring_all_gather_bidi",
                                   "otpu_ring_right_permute", "otpu_all_to_all",
                                   "otpu_all_to_all_v", "otpu_all_gather_v"])
def test_a_captured_launch_without_its_counter_is_refused_on_card(entry):
    """On a capturing stream, an entry given no counter pair returns 900,
    draws no slot of its library's pool and launches nothing: the replay
    runs the rest of the capture and leaves ``out`` as it was.  The same
    call made eagerly draws one slot and copies."""
    _card()
    lib, x, out, between, _counts = _mover_call(entry)
    fn, dealt = _entry(lib, entry), _entry(lib, f"otpu_{lib}_tickets_dealt")
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    before = dealt()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        marker.add_(1)
        err = fn(x.data_ptr(), out.data_ptr(), *between, 16, None,
                 torch.cuda.current_stream().cuda_stream)
    assert err == NEEDS_COUNTER and dealt() == before, (err, entry)
    graph.replay()
    torch.cuda.synchronize()
    assert float(marker) == 1.0 and bool((out == -1).all()), entry
    assert fn(x.data_ptr(), out.data_ptr(), *between, 16, None,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert dealt() == before + 1 and bool((out != -1).any()), entry


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["all_gather", "all_to_all_v"])
def test_captured_launch_beside_eager_launches_on_card(kernel):
    """One captured launch replayed on stream A, BESIDE_ROUNDS times, each
    replay started together with an eager launch of the same library on
    stream B, each input bumped before its launch: the capture drew no
    slot of the pool, and every replay and every eager result is
    byte-exact."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(len(kernel))
    assert mc.beside_eager(kernel, BESIDE_ROUNDS, gen) == (0, 0, 0), kernel


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["all_gather", "all_to_all_v"])
def test_two_captures_a_pool_apart_replayed_at_once_on_card(kernel):
    """Two graphs whose captured launches are a pool's length of launches
    apart, replayed APART_ROUNDS times, each pair of replays started
    together on two streams, each on its own input bumped before each
    replay: both byte-exact."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(len(kernel) + 1)
    assert mc.two_apart(kernel, APART_ROUNDS, gen) == (0, 0), kernel
