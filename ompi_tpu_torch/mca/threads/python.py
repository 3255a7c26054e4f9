"""threads/python — ThreadPoolExecutor substrate.

Copy of ``ompi_tpu/mca/threads/python.py``.  Always available; numpy
releases the GIL inside its own ufunc/copy loops, so large jobs overlap.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from ompi_tpu_torch.mca.threads import base

_UFUNC = {"sum": np.add, "prod": np.multiply,
          "max": np.maximum, "min": np.minimum}


class _FutureWork(base.Work):
    def __init__(self, futures: list[Future]):
        self._futures = futures

    def test(self) -> bool:
        return all(f.done() for f in self._futures)

    def wait(self) -> None:
        for f in self._futures:
            f.result()


class PythonPool(base.WorkPool):
    def __init__(self, nworkers: int):
        self.size = max(1, nworkers)
        self._ex = ThreadPoolExecutor(
            max_workers=self.size, thread_name_prefix="otpu-threads")

    def _spans(self, n: int, grain: int):
        pieces = max(1, min(self.size, n // grain))
        per, rem = divmod(n, pieces)
        at = 0
        for i in range(pieces):
            ln = per + (1 if i < rem else 0)
            yield at, ln
            at += ln

    def memcpy(self, dst, src):
        if dst.nbytes != src.nbytes:
            raise ValueError("memcpy size mismatch")
        if not (dst.flags.c_contiguous and src.flags.c_contiguous):
            # same contract as every substrate — reshape(-1) on a
            # non-contiguous dst would silently write into a copy
            raise ValueError("pool jobs need C-contiguous arrays")
        d = dst.reshape(-1).view(np.uint8)
        s = src.reshape(-1).view(np.uint8)
        futs = [self._ex.submit(
            lambda a, ln, d=d, s=s: d.__setitem__(
                slice(a, a + ln), s[a:a + ln]), at, ln)
            for at, ln in self._spans(d.nbytes, 1 << 16)]
        return _FutureWork(futs)

    def reduce(self, op, acc, src):
        # same contract as every substrate (components must be
        # interchangeable): matching shapes AND dtypes only
        if (op not in _UFUNC or acc.shape != src.shape
                or src.dtype != acc.dtype):
            raise ValueError(f"unsupported reduce: {op}")
        if not acc.flags.c_contiguous:
            raise ValueError("pool jobs need C-contiguous arrays")
        uf = _UFUNC[op]
        a = acc.reshape(-1)
        s = src.reshape(-1)
        futs = [self._ex.submit(
            lambda at, ln: uf(a[at:at + ln], s[at:at + ln],
                              out=a[at:at + ln]), at, ln)
            for at, ln in self._spans(a.size, 1 << 14)]
        return _FutureWork(futs)

    def _packish(self, packing, mem, stream, seg_off, seg_len, extent,
                 base_offset, first_elem, nelem):
        seg_off = np.asarray(seg_off, np.int64)
        seg_len = np.asarray(seg_len, np.int64)
        elem_packed = int(seg_len.sum())

        def run(at, ln):
            # per-element segment gather/scatter, one span per worker
            for e in range(first_elem + at, first_elem + at + ln):
                ebase = base_offset + e * extent
                spos = (e - first_elem) * elem_packed
                for off, ln_j in zip(seg_off, seg_len):
                    if packing:
                        stream[spos:spos + ln_j] = \
                            mem[ebase + off:ebase + off + ln_j]
                    else:
                        mem[ebase + off:ebase + off + ln_j] = \
                            stream[spos:spos + ln_j]
                    spos += ln_j

        futs = [self._ex.submit(run, at, ln)
                for at, ln in self._spans(nelem, 64)]
        return _FutureWork(futs)

    def pack(self, mem, out, seg_off, seg_len, extent, base_offset,
             first_elem, nelem):
        return self._packish(True, mem, out, seg_off, seg_len, extent,
                             base_offset, first_elem, nelem)

    def unpack(self, mem, chunk, seg_off, seg_len, extent, base_offset,
               first_elem, nelem):
        return self._packish(False, mem, chunk, seg_off, seg_len, extent,
                             base_offset, first_elem, nelem)

    def close(self) -> None:
        self._ex.shutdown(wait=True)


class PythonThreadsComponent(base.ThreadsComponent):
    name = "python"
    priority = 10

    def make_pool(self, nworkers: int) -> base.WorkPool:
        return PythonPool(nworkers)


COMPONENT = PythonThreadsComponent()
