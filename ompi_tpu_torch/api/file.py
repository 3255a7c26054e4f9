"""File — the MPI-IO surface object (``MPI_File``).

Copy of ``ompi_tpu/api/file.py`` (after the reference's ``ompi/file/file.c``
and the ``MPI_File_*`` bindings, ``ompi/mpi/c/file_*.c``): a File is opened
collectively on a communicator, carries an access mode, a file view (disp,
etype, filetype), an individual file pointer and a *shared* file pointer,
and dispatches every I/O operation to the io module selected for it
(``mca/io/base``).

Buffers are numpy arrays or tensors (count/type inferred) or ``(buffer,
count, Datatype)`` triples; non-contiguous memory layouts go through the
datatype convertor's pack/unpack, and non-contiguous *file* layouts through
the view's filetype.  A tensor written through a File is staged to the host
as point-to-point stages it (``api/comm.host_buffer``: on the card, a D2H
copy); as a read buffer it is read-only there, as ``np.asarray`` of a
``jax.Array`` is in the reference, so a read into a tensor raises
ValueError and leaves the tensor as it was.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.api.comm import host_buffer, is_tensor
from ompi_tpu_torch.api.errors import ErrorClass, MpiError
from ompi_tpu_torch.api.request import CompletedRequest, Request
from ompi_tpu_torch.datatype import BYTE, Datatype
from ompi_tpu_torch.datatype.convertor import Convertor

# amode flags (MPI_MODE_*)
MODE_RDONLY = 0x01
MODE_WRONLY = 0x02
MODE_RDWR = 0x04
MODE_CREATE = 0x08
MODE_EXCL = 0x10
MODE_DELETE_ON_CLOSE = 0x20
MODE_APPEND = 0x40
MODE_UNIQUE_OPEN = 0x80
MODE_SEQUENTIAL = 0x100

SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2

_MODE_CHARS = {"r": MODE_RDONLY, "w": MODE_WRONLY, "+": MODE_RDWR,
               "c": MODE_CREATE, "x": MODE_EXCL, "a": MODE_APPEND,
               "d": MODE_DELETE_ON_CLOSE}


def _parse_amode(amode) -> int:
    if isinstance(amode, int):
        return amode
    flags = 0
    for ch in amode:
        if ch not in _MODE_CHARS:
            raise MpiError(ErrorClass.ERR_AMODE, f"bad amode char {ch!r}")
        flags |= _MODE_CHARS[ch]
    return flags


def _buffer_to_bytes(buf) -> tuple[bytes, Any]:
    """Pack a user buffer to its data-stream bytes (+ keepalive array)."""
    if isinstance(buf, tuple):
        arr, count, dt = buf
        arr = host_buffer(arr)
        if dt.is_contiguous and arr.flags.c_contiguous:
            data = arr.tobytes()[:count * dt.size]
        else:
            conv = Convertor(dt, count).prepare(arr)
            data = conv.pack()
        return data, arr
    arr = np.ascontiguousarray(host_buffer(buf))
    return arr.tobytes(), arr


def _stream_nbytes(buf) -> int:
    """Data-stream byte size of a buffer spec without packing it."""
    if isinstance(buf, tuple):
        _, count, dt = buf
        return count * dt.size
    if is_tensor(buf):
        return int(buf.nbytes)
    return np.asarray(buf).nbytes


# -- data representations (MPI_Register_datarep, io ompio datareps) -----
#
# "native" = bytes as-is; "external32" = canonical big-endian per etype
# item; user reps registered here convert the whole byte stream between
# file and memory representation (read_fn: file->memory bytes,
# write_fn: memory->file bytes), the MPI_Register_datarep contract with
# the dtype-conversion collapsed to the byte stream.
_datareps: dict = {}


def register_datarep(name: str, read_fn, write_fn,
                     extent_fn=None) -> None:
    """``MPI_Register_datarep``."""
    if name in ("native", "external32") or name in _datareps:
        raise MpiError(ErrorClass.ERR_ARG,
                       f"datarep {name!r} already defined")
    _datareps[name] = (read_fn, write_fn, extent_fn)


def _bytes_to_buffer(data: bytes, buf) -> int:
    """Unpack stream bytes into the user buffer; returns element count."""
    if isinstance(buf, tuple):
        arr, count, dt = buf
        arr = host_buffer(arr)
        conv = Convertor(dt, count).prepare(arr)
        return conv.unpack(data) // max(1, dt.size) if dt.size else 0
    arr = host_buffer(buf)
    if not arr.flags.c_contiguous:
        raise MpiError(ErrorClass.ERR_BUFFER,
                       "read into non-contiguous memory requires an "
                       "(array, count, Datatype) buffer triple")
    flat = arr.reshape(-1).view(np.uint8)
    n = min(len(data), flat.nbytes)
    flat[:n] = np.frombuffer(data, np.uint8, count=n)
    return n // max(1, arr.dtype.itemsize)


class File:
    """An open MPI file.  Create with ``File.open(comm, name, amode)``."""

    def __init__(self, comm, filename: str, amode: int, fd: int) -> None:
        self.comm = comm
        self.filename = filename
        self.amode = amode
        self.fd = fd
        self.closed = False
        self.atomicity = False
        self.io_module = None      # set by file_select
        # default view: displacement 0, byte stream
        self.disp = 0
        self.etype: Datatype = BYTE
        self.filetype: Datatype = BYTE
        self._fp = 0               # individual pointer, etype units
        self._sfp_key = f"__sfp__:{os.path.abspath(filename)}"
        self._split = None         # active split collective (kind, end)

    # -- open / close -----------------------------------------------------
    @classmethod
    def open(cls, comm, filename: str, amode="rc",
             info=None) -> "File":
        """Collective open (``MPI_File_open``).

        ``amode`` is an int of MODE_* flags or a string: r/w/+ access,
        c(reate), x(excl), a(ppend), d(elete-on-close).
        """
        flags = _parse_amode(amode)
        access = bool(flags & (MODE_RDONLY | MODE_WRONLY | MODE_RDWR))
        if not access:
            flags |= MODE_RDWR
        osflags = os.O_RDONLY
        if flags & MODE_RDWR or (flags & MODE_RDONLY and flags & MODE_WRONLY):
            osflags = os.O_RDWR
        elif flags & MODE_WRONLY:
            osflags = os.O_WRONLY
        if flags & MODE_CREATE:
            osflags |= os.O_CREAT
        if flags & MODE_APPEND:
            osflags |= os.O_APPEND
        rank = comm.rank if comm is not None else 0
        # rank 0 creates (EXCL races resolved there), others open after
        if comm is not None and comm.size > 1:
            err = ""
            if rank == 0:
                try:
                    excl = osflags | (os.O_EXCL if flags & MODE_EXCL else 0)
                    fd = os.open(filename, excl, 0o644)
                except OSError as exc:
                    err, fd = str(exc), -1
                comm.bcast(np.array([fd >= 0], np.int8), root=0)
                if fd < 0:
                    raise MpiError(ErrorClass.ERR_IO,
                                   f"cannot open {filename!r}: {err}")
            else:
                ok = comm.bcast(np.zeros(1, np.int8), root=0)
                if not int(ok[0]):
                    raise MpiError(ErrorClass.ERR_IO,
                                   f"cannot open {filename!r} (root failed)")
                fd = os.open(filename, osflags & ~os.O_CREAT
                             if not flags & MODE_CREATE else osflags, 0o644)
        else:
            excl = osflags | (os.O_EXCL if flags & MODE_EXCL else 0)
            try:
                fd = os.open(filename, excl, 0o644)
            except OSError as exc:
                raise MpiError(ErrorClass.ERR_IO,
                               f"cannot open {filename!r}: {exc}")
        f = cls(comm, filename, flags, fd)
        from ompi_tpu_torch.mca.io.base import file_select

        file_select(f)
        # per-open shared-pointer counter: a fresh key per collective open
        # (so reopened or concurrently-opened handles of the same path
        # don't share or inherit a stale counter), starting at 0
        client = f._sfp_client()
        if comm is not None and comm.size > 1:
            seq = np.zeros(1, np.int64)
            if rank == 0 and client is not None:
                seq[0] = client.fetch_add(-1, "__sfp_open_seq__", 1)
            seq = comm.bcast(seq, root=0)
            f._sfp_key += f":open{int(seq[0])}"
            if rank == 0:
                f._shared_reset(0)
            comm.barrier()   # reset visible before anyone's first I/O
        else:
            f._shared_reset(0)
        return f

    @staticmethod
    def delete(filename: str) -> None:
        try:
            os.unlink(filename)
        except FileNotFoundError as exc:
            raise MpiError(ErrorClass.ERR_FILE, str(exc))

    def close(self) -> None:
        if self.closed:
            return
        if self.comm is not None and self.comm.size > 1:
            self.comm.barrier()
        os.close(self.fd)
        if self.amode & MODE_DELETE_ON_CLOSE:
            if self.comm is None or self.comm.rank == 0:
                try:
                    os.unlink(self.filename)
                except FileNotFoundError:
                    pass
        self.closed = True

    def _check(self) -> None:
        if self.closed:
            raise MpiError(ErrorClass.ERR_FILE, "file is closed")

    # -- datarep conversion (applied at the stream boundary) -------------
    def _convert(self, data, direction: str):
        rep = getattr(self, "datarep", "native")
        if rep == "native":
            return data
        if rep == "external32":
            # segment-wise byteswap of the packed stream — derived
            # etypes swap each field at its own itemsize (the convertor
            # owns that walk; reuse it rather than re-deriving)
            from ompi_tpu_torch.datatype.convertor import (Convertor,
                                                     ConvertorFlags)

            size = max(1, self.etype.size)
            if len(data) % size:
                raise MpiError(ErrorClass.ERR_ARG,
                               f"external32 stream of {len(data)} bytes "
                               f"not a multiple of etype size {size}")
            arr = np.frombuffer(data, np.uint8).copy()
            cv = Convertor(self.etype, len(data) // size,
                           flags=ConvertorFlags.EXTERNAL32)
            cv._swap_external32(arr, 0)
            return arr.tobytes()
        read_fn, write_fn, _ = _datareps[rep]
        fn = read_fn if direction == "read" else write_fn
        out = fn(bytes(data), self.etype)
        if len(out) != len(data):
            # the read-sizing and file-pointer math assume the file and
            # memory representations have equal extents
            raise MpiError(ErrorClass.ERR_ARG,
                           f"datarep {rep!r} changed the stream size "
                           f"({len(data)} -> {len(out)}); only "
                           "size-preserving representations are "
                           "supported")
        return out

    def _to_stream(self, buf):
        data, keep = _buffer_to_bytes(buf)
        return self._convert(data, "write"), keep

    def _from_stream(self, data, buf) -> int:
        return _bytes_to_buffer(self._convert(data, "read"), buf)

    # -- view -------------------------------------------------------------
    def set_view(self, disp: int = 0, etype: Optional[Datatype] = None,
                 filetype: Optional[Datatype] = None,
                 datarep: str = "native", info=None) -> None:
        self._check()
        self.disp = disp
        self.etype = etype or BYTE
        self.filetype = filetype or self.etype
        if self.filetype.size % max(1, self.etype.size):
            raise MpiError(ErrorClass.ERR_ARG,
                           "filetype size must be a multiple of etype size")
        if datarep not in ("native", "external32") \
                and datarep not in _datareps:
            raise MpiError(ErrorClass.ERR_UNSUPPORTED_DATAREP
                           if hasattr(ErrorClass, "ERR_UNSUPPORTED_DATAREP")
                           else ErrorClass.ERR_ARG,
                           f"unsupported datarep {datarep!r}")
        self.datarep = datarep
        self._fp = 0
        if self.comm is None or self.comm.rank == 0:
            self._shared_reset(0)
        if self.comm is not None and self.comm.size > 1:
            # set_view is collective: nobody may issue shared-pointer I/O
            # until the reset has happened (rank 0 resets before its
            # barrier arrival releases the others)
            self.comm.barrier()

    def get_view(self) -> tuple:
        return self.disp, self.etype, self.filetype

    def get_byte_offset(self, offset: int) -> int:
        """``MPI_File_get_byte_offset``: absolute file byte of a
        view-relative offset (etype units), walking the filetype
        tiling (``ompi/mpi/c/file_get_byte_offset.c``)."""
        self._check()
        from ompi_tpu_torch.mca.io.ompio import view_extents

        start = offset * max(1, self.etype.size)
        for off, _ln in view_extents(self.disp, self.filetype, start, 1):
            return off
        # zero-size etype / empty view: the displacement itself
        return self.disp + start

    def get_type_extent(self, datatype: Datatype) -> int:
        """``MPI_File_get_type_extent``: datatype extent in this file's
        data representation (external32 is size-packed; native keeps
        the memory extent)."""
        self._check()
        rep = getattr(self, "datarep", "native")
        if rep != "native":
            if rep in _datareps and _datareps[rep][2] is not None:
                return int(_datareps[rep][2](datatype))  # extent_fn
            return datatype.size       # external32: size-packed stream
        return datatype.extent

    # -- explicit-offset I/O ---------------------------------------------
    def write_at(self, offset: int, buf) -> int:
        self._check()
        data, _ = self._to_stream(buf)
        return self.io_module.write_at(self, offset, data)

    def read_at(self, offset: int, buf) -> int:
        self._check()
        data = self.io_module.read_at(self, offset, _stream_nbytes(buf))
        return self._from_stream(data, buf)

    def write_at_all(self, offset: int, buf) -> int:
        self._check()
        data, _ = self._to_stream(buf)
        return self.io_module.write_at_all(self, offset, data)

    def read_at_all(self, offset: int, buf) -> int:
        self._check()
        data = self.io_module.read_at_all(self, offset, _stream_nbytes(buf))
        return self._from_stream(data, buf)

    # nonblocking variants (MPI_File_iwrite_at & friends): the I/O path is
    # synchronous POSIX, so requests complete eagerly — same shape the
    # device collectives use (the XLA stream / page cache is the engine)
    def iwrite_at(self, offset: int, buf) -> Request:
        r = CompletedRequest()
        r.result = self.write_at(offset, buf)
        return r

    def iread_at(self, offset: int, buf) -> Request:
        r = CompletedRequest()
        r.result = self.read_at(offset, buf)
        return r

    def iwrite_at_all(self, offset: int, buf) -> Request:
        """``MPI_File_iwrite_at_all`` (nonblocking collective; eager)."""
        r = CompletedRequest()
        r.result = self.write_at_all(offset, buf)
        return r

    def iread_at_all(self, offset: int, buf) -> Request:
        r = CompletedRequest()
        r.result = self.read_at_all(offset, buf)
        return r

    # -- individual-pointer I/O ------------------------------------------
    def _advance(self, buf, n_elems_bytes: int) -> None:
        self._fp += n_elems_bytes // max(1, self.etype.size)

    def write(self, buf) -> int:
        self._check()
        data, _ = self._to_stream(buf)
        n = self.io_module.write_at(self, self._fp, data)
        self._advance(buf, len(data))
        return n

    def read(self, buf) -> int:
        self._check()
        data = self.io_module.read_at(self, self._fp, _stream_nbytes(buf))
        self._advance(buf, len(data))
        return self._from_stream(data, buf)

    def write_all(self, buf) -> int:
        self._check()
        data, _ = self._to_stream(buf)
        n = self.io_module.write_at_all(self, self._fp, data)
        self._advance(buf, len(data))
        return n

    def iwrite(self, buf) -> Request:
        """``MPI_File_iwrite`` (individual pointer, eager completion —
        the pointer advances before return, per MPI nonblocking rules)."""
        r = CompletedRequest()
        r.result = self.write(buf)
        return r

    def iread(self, buf) -> Request:
        r = CompletedRequest()
        r.result = self.read(buf)
        return r

    def iwrite_all(self, buf) -> Request:
        """``MPI_File_iwrite_all`` (nonblocking collective; eager)."""
        r = CompletedRequest()
        r.result = self.write_all(buf)
        return r

    def iread_all(self, buf) -> Request:
        r = CompletedRequest()
        r.result = self.read_all(buf)
        return r

    def read_all(self, buf) -> int:
        self._check()
        data = self.io_module.read_at_all(self, self._fp, _stream_nbytes(buf))
        self._advance(buf, len(data))
        return self._from_stream(data, buf)

    # -- split collectives (MPI_File_read_all_begin/end family) ----------
    # The reference carries these as begin/end halves over its two-phase
    # collective engine (``ompi/mpi/c/file_read_all_begin.c`` ->
    # ``mca_common_ompio_file_read_all_begin``).  Here the collective
    # engine is synchronous, so *begin* runs the collective and parks
    # the delivery while *end* hands it to the caller — the standard's
    # contract is what matters and is enforced: one outstanding split
    # collective per handle, matching end call, same buffer at end.

    def _assert_no_split(self) -> None:
        """Must run BEFORE a begin's I/O: a rejected begin must not
        have touched the file or advanced any pointer."""
        if self._split is not None:
            raise RuntimeError(
                f"split collective {self._split[0]}_begin already "
                "active: MPI allows one outstanding split collective "
                "per file handle")

    def _split_begin(self, kind: str, buf, finish) -> None:
        self._assert_no_split()
        self._split = (kind, buf, finish)

    def _split_end(self, kind: str, buf):
        self._check()
        if self._split is None:
            raise RuntimeError(f"{kind}_end without {kind}_begin")
        active, begin_buf, finish = self._split
        if active != kind:
            raise RuntimeError(
                f"{kind}_end does not match active split collective "
                f"{active}_begin")
        if begin_buf is not buf:
            raise RuntimeError(
                f"{kind}_end must receive the same buffer passed to "
                f"{kind}_begin")
        self._split = None
        return finish()

    def read_all_begin(self, buf) -> None:
        self._check()
        self._assert_no_split()
        data = self.io_module.read_at_all(self, self._fp,
                                          _stream_nbytes(buf))
        self._advance(buf, len(data))
        self._split_begin("read_all", buf,
                          lambda: self._from_stream(data, buf))

    def read_all_end(self, buf) -> int:
        return self._split_end("read_all", buf)

    def write_all_begin(self, buf) -> None:
        self._check()
        self._assert_no_split()
        data, _ = self._to_stream(buf)
        n = self.io_module.write_at_all(self, self._fp, data)
        self._advance(buf, len(data))
        self._split_begin("write_all", buf, lambda: n)

    def write_all_end(self, buf) -> int:
        return self._split_end("write_all", buf)

    def read_at_all_begin(self, offset: int, buf) -> None:
        self._check()
        self._assert_no_split()
        data = self.io_module.read_at_all(self, offset,
                                          _stream_nbytes(buf))
        self._split_begin("read_at_all", buf,
                          lambda: self._from_stream(data, buf))

    def read_at_all_end(self, buf) -> int:
        return self._split_end("read_at_all", buf)

    def write_at_all_begin(self, offset: int, buf) -> None:
        self._check()
        self._assert_no_split()
        data, _ = self._to_stream(buf)
        n = self.io_module.write_at_all(self, offset, data)
        self._split_begin("write_at_all", buf, lambda: n)

    def write_at_all_end(self, buf) -> int:
        return self._split_end("write_at_all", buf)

    def seek(self, offset: int, whence: int = SEEK_SET) -> None:
        self._check()
        if whence == SEEK_SET:
            self._fp = offset
        elif whence == SEEK_CUR:
            self._fp += offset
        elif whence == SEEK_END:
            size_et = self.get_size() // max(1, self.etype.size)
            self._fp = size_et + offset
        else:
            raise MpiError(ErrorClass.ERR_ARG, f"bad whence {whence}")
        if self._fp < 0:
            raise MpiError(ErrorClass.ERR_ARG, "negative file position")

    def get_position(self) -> int:
        return self._fp

    # -- shared-pointer I/O (sharedfp framework) -------------------------
    def _sfp_client(self):
        rte = self.comm.rte if self.comm is not None else None
        return getattr(rte, "client", None)

    def _shared_fetch_add(self, delta: int) -> int:
        client = self._sfp_client()
        if client is not None:
            return client.fetch_add(-1, self._sfp_key, delta)
        # single-process models: plain local counter
        cur = getattr(self, "_local_sfp", 0)
        self._local_sfp = cur + delta
        return cur

    def _shared_reset(self, value: int = 0) -> None:
        """Set the shared pointer (one atomic put; MPI requires the shared
        pointer to be 0 at open and reset by set_view)."""
        client = self._sfp_client()
        if client is not None:
            client.put(-1, self._sfp_key, value)
        else:
            self._local_sfp = value

    def write_shared(self, buf) -> int:
        self._check()
        data, _ = self._to_stream(buf)
        n_et = -(-len(data) // max(1, self.etype.size))
        pos = self._shared_fetch_add(n_et)
        return self.io_module.write_at(self, pos, data)

    def read_shared(self, buf) -> int:
        self._check()
        nbytes = _stream_nbytes(buf)
        n_et = -(-nbytes // max(1, self.etype.size))
        pos = self._shared_fetch_add(n_et)
        data = self.io_module.read_at(self, pos, nbytes)
        return self._from_stream(data, buf)

    def iwrite_shared(self, buf) -> Request:
        """``MPI_File_iwrite_shared`` (eager; the shared-pointer
        fetch-add is the ordering point, same as the blocking form)."""
        r = CompletedRequest()
        r.result = self.write_shared(buf)
        return r

    def iread_shared(self, buf) -> Request:
        r = CompletedRequest()
        r.result = self.read_shared(buf)
        return r

    def get_position_shared(self) -> int:
        """``MPI_File_get_position_shared``: shared pointer in etypes."""
        self._check()
        return self._shared_fetch_add(0)

    # -- ordered shared-pointer collectives (MPI_File_read_ordered) ------
    def _ordered_pos(self, nbytes: int) -> int:
        """Collective rank-ordered carve-out of the shared pointer:
        every rank learns everyone's element count, rank 0 advances the
        shared counter once by the total, and each rank's region starts
        at the old value plus the counts of the ranks before it — the
        reference's sharedfp ordered algorithm
        (``ompio/sharedfp/base``) on the coord-backed counter."""
        n_et = -(-nbytes // max(1, self.etype.size))
        if self.comm is None or self.comm.size == 1:
            return self._shared_fetch_add(n_et)
        counts = np.asarray(self.comm.allgather(
            np.array([n_et], np.int64))).reshape(-1)
        rank = self.comm.rank
        base = np.zeros(1, np.int64)
        if rank == 0:
            base[0] = self._shared_fetch_add(int(counts.sum()))
        base = np.asarray(self.comm.bcast(base, root=0)).reshape(-1)
        return int(base[0]) + int(counts[:rank].sum())

    def read_ordered(self, buf) -> int:
        self._check()
        nbytes = _stream_nbytes(buf)
        pos = self._ordered_pos(nbytes)
        data = self.io_module.read_at(self, pos, nbytes)
        return self._from_stream(data, buf)

    def write_ordered(self, buf) -> int:
        self._check()
        data, _ = self._to_stream(buf)
        pos = self._ordered_pos(len(data))
        return self.io_module.write_at(self, pos, data)

    def read_ordered_begin(self, buf) -> None:
        self._check()
        self._assert_no_split()
        nbytes = _stream_nbytes(buf)
        pos = self._ordered_pos(nbytes)
        data = self.io_module.read_at(self, pos, nbytes)
        self._split_begin("read_ordered", buf,
                          lambda: self._from_stream(data, buf))

    def read_ordered_end(self, buf) -> int:
        return self._split_end("read_ordered", buf)

    def write_ordered_begin(self, buf) -> None:
        self._check()
        self._assert_no_split()
        data, _ = self._to_stream(buf)
        pos = self._ordered_pos(len(data))
        n = self.io_module.write_at(self, pos, data)
        self._split_begin("write_ordered", buf, lambda: n)

    def write_ordered_end(self, buf) -> int:
        return self._split_end("write_ordered", buf)

    def seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        """Collective in MPI; here any rank may reset the shared counter."""
        self._shared_reset(offset)

    # -- fs passthrough ---------------------------------------------------
    def get_size(self) -> int:
        self._check()
        return self.io_module.get_size(self)

    def set_size(self, size: int) -> None:
        self._check()
        self.io_module.set_size(self, size)

    def preallocate(self, size: int) -> None:
        self._check()
        self.io_module.preallocate(self, size)

    def sync(self) -> None:
        self._check()
        self.io_module.sync(self)

    def get_amode(self) -> int:
        return self.amode

    def get_group(self):
        return self.comm.group if self.comm is not None else None

    def set_atomicity(self, flag: bool) -> None:
        self.atomicity = bool(flag)

    def get_atomicity(self) -> bool:
        return self.atomicity

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"File({self.filename!r}, fd={self.fd})"
