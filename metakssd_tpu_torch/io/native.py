"""ctypes bindings for the native C++ host library (``native/*.cpp`` at
the repo root): the sequence parser, the sketch engine and the posting
passes.  The port's copy of ``metakssd_tpu/io/native.py``.

The library builds on first use from the shared sources, with the flags
of ``native/Makefile``, into ``metakssd_tpu_torch/_build/`` under a name
of its own (a hash of the sources and flags), so the two packages never
share one ``.so``.  Where that compile fails (a g++ without libgomp
refuses ``-fopenmp``) it is tried once more without ``-fopenmp``: the
sources guard every OpenMP call with ``#ifdef _OPENMP``, so the serial
build gives the same results on one thread.  ``build_kind()`` says which
one loaded.  When no compiler can build it, every caller takes its numpy
route (``MKSSD_NO_NATIVE=1`` forces that), except ``--device host``,
which runs on the library: its engine (``sketch_cpu``, ``sketch_fastq``,
``radix_sort_u32``, ``postings_expand``) raises without it (``require``),
and nothing runs the plain versions in its place.  Host code only: no
device work hides behind it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile's CXXFLAGS and link line
_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-fopenmp")

_SERIAL_CXXFLAGS = tuple(f for f in _CXXFLAGS if f != "-fopenmp")

_lib = None
_tried = False
_kind = None            # "openmp" or "serial" once a library has loaded


def _library_path(flags=_CXXFLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp"))
                      + glob.glob(os.path.join(_NATIVE_DIR, "*.h"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libfastseq_torch_{h.hexdigest()[:16]}.so")


def _compile(flags) -> str | None:
    """Path of the library built with ``flags``, or None on failure."""
    so = _library_path(flags)
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    srcs = [os.path.join(_NATIVE_DIR, f)
            for f in ("fastseq.cpp", "sketch_cpu.cpp", "postings.cpp")]
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run([cxx, *flags, "-shared", *srcs, "-o", tmp, "-lz"],
                       check=True, capture_output=True)
        os.replace(tmp, so)       # atomic: a concurrent builder's twin wins
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return so


def _build() -> str | None:
    """Path of the built library, or None when it cannot be built: a
    library that an earlier process built (either kind) before any
    compile, then the Makefile's flags, then the same without
    ``-fopenmp``."""
    global _kind
    builds = (("openmp", _CXXFLAGS), ("serial", _SERIAL_CXXFLAGS))
    for kind, flags in builds:
        if os.path.exists(_library_path(flags)):
            _kind = kind
            return _library_path(flags)
    for kind, flags in builds:
        so = _compile(flags)
        if so is not None:
            _kind = kind
            return so
    _kind = None
    return None


def build_kind() -> str | None:
    """"openmp" or "serial" for the library that loaded, None when the
    numpy routes run."""
    return _kind if _load() is not None else None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("MKSSD_NO_NATIVE") == "1":
        return None
    so = _build()
    if so is None:
        return None
    try:
        _lib = _bind(ctypes.CDLL(so))
    except OSError:
        return None
    return _lib


def _bind(lib):
    """``lib`` with the argument and result types of every entry point."""
    lib.fastseq_set_threads.restype = None
    lib.fastseq_set_threads.argtypes = [ctypes.c_int]
    lib.fastseq_parse_fasta.restype = ctypes.c_void_p
    lib.fastseq_parse_fasta.argtypes = [ctypes.c_char_p]
    lib.fastseq_parse_fastq.restype = ctypes.c_void_p
    lib.fastseq_parse_fastq.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fastseq_n_codes.restype = ctypes.c_int64
    lib.fastseq_n_codes.argtypes = [ctypes.c_void_p]
    lib.fastseq_n_starts.restype = ctypes.c_int64
    lib.fastseq_n_starts.argtypes = [ctypes.c_void_p]
    lib.fastseq_codes_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fastseq_codes_ptr.argtypes = [ctypes.c_void_p]
    lib.fastseq_starts_ptr.restype = ctypes.POINTER(ctypes.c_int64)
    lib.fastseq_starts_ptr.argtypes = [ctypes.c_void_p]
    lib.fastseq_free.restype = None
    lib.fastseq_free.argtypes = [ctypes.c_void_p]
    lib.fastseq_stream_open.restype = ctypes.c_void_p
    lib.fastseq_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fastseq_stream_next.restype = ctypes.c_int64
    lib.fastseq_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fastseq_stream_n_codes.restype = ctypes.c_int64
    lib.fastseq_stream_n_codes.argtypes = [ctypes.c_void_p]
    lib.fastseq_stream_codes_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fastseq_stream_codes_ptr.argtypes = [ctypes.c_void_p]
    lib.fastseq_stream_starts_ptr.restype = ctypes.POINTER(ctypes.c_int64)
    lib.fastseq_stream_starts_ptr.argtypes = [ctypes.c_void_p]
    lib.fastseq_stream_close.restype = None
    lib.fastseq_stream_close.argtypes = [ctypes.c_void_p]
    lib.sketch_cpu_run.restype = ctypes.c_int64
    lib.sketch_cpu_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
    lib.sketch_cpu_free.restype = None
    lib.sketch_cpu_free.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.fastseq_sketch_file.restype = ctypes.c_int64
    lib.fastseq_sketch_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
    lib.postings_expand_i32.restype = None
    lib.postings_expand_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint16)]
    lib.k_radix_sort_u32.restype = None
    lib.k_radix_sort_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.postings_count_u32.restype = None
    lib.postings_count_u32.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
    lib.postings_count_ranges.restype = None
    lib.postings_count_ranges.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
    lib.sorted_first_indices_u32.restype = ctypes.c_int64
    lib.sorted_first_indices_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.sorted_unique_pack_u32.restype = ctypes.c_int64
    lib.sorted_unique_pack_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32)]
    lib.invert_postings_u32.restype = None
    lib.invert_postings_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32)]
    lib.kv_radix_sort_u32.restype = None
    lib.kv_radix_sort_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.postings_group_stats.restype = None
    lib.postings_group_stats.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.format_name_float_lines.restype = ctypes.c_int64
    lib.format_name_float_lines.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    return lib


def available() -> bool:
    return _load() is not None


def require():
    """The loaded library; raises RuntimeError where none could be built
    or loaded (``--device host`` runs on it and on nothing else)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "--device host needs the native host library, which could not "
            "be built or loaded (MKSSD_NO_NATIVE=1, or no C++ compiler); "
            "--device cpu runs the plain versions")
    return lib


def _copy_out(ptr, n, dtype):
    # ctypes.memmove into a fresh array: np.ctypeslib.as_array(...).copy()
    # runs ~20x slower than memcpy on large buffers
    out = np.empty(n, dtype=dtype)
    if n:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    return out


def _extract(lib, h):
    n = lib.fastseq_n_codes(h)
    ns = lib.fastseq_n_starts(h)
    codes = _copy_out(lib.fastseq_codes_ptr(h), n, np.uint8)
    starts = _copy_out(lib.fastseq_starts_ptr(h), ns, np.int64)
    lib.fastseq_free(h)
    return codes, starts


def parse_fasta(path: str):
    """(codes, header_positions) or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastseq_parse_fasta(path.encode())
    if not h:
        raise OSError(f"fastseq: cannot open {path}")
    return _extract(lib, h)


def set_threads(n: int) -> None:
    """Cap OpenMP threads in every native kernel (CLI -p flag).  Also
    exports OMP_NUM_THREADS so a lib loaded later starts capped."""
    if n <= 0:
        return
    os.environ["OMP_NUM_THREADS"] = str(n)
    lib = _load()
    if lib is not None:
        lib.fastseq_set_threads(int(n))


def parse_fastq(path: str, min_qual: int = 0):
    """(codes, read_starts[nreads+1]) or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastseq_parse_fastq(path.encode(), min_qual)
    if not h:
        raise OSError(f"fastseq: cannot open {path}")
    return _extract(lib, h)


def stream_fastq(path: str, min_qual: int = 0,
                 max_bases: int = 64 << 20, copy: bool = True):
    """Generator of (codes uint8, read_starts int64) batches, bounded to
    ~max_bases host bytes per batch (reads never split across batches).

    With copy=False the yielded arrays are ZERO-COPY read-only views of
    the parser's internal batch buffer: valid only until the next
    iteration.  Fresh per-batch allocations are avoided in the hot
    pipeline on purpose — on this host first-touch page faults run
    ~0.1 GB/s, dwarfing the parse itself.  Default copy=True is the safe
    retainable behavior for other callers.

    Raises OSError on open failure; callers check available() first."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    h = lib.fastseq_stream_open(path.encode(), min_qual)
    if not h:
        raise OSError(f"fastseq: cannot open {path}")
    try:
        while True:
            nreads = lib.fastseq_stream_next(h, max_bases)
            if nreads < 0:
                raise OSError(f"fastseq: decode error reading {path}")
            if nreads == 0:
                break
            n = lib.fastseq_stream_n_codes(h)
            codes = np.ctypeslib.as_array(
                lib.fastseq_stream_codes_ptr(h), shape=(n,))
            starts = np.ctypeslib.as_array(
                lib.fastseq_stream_starts_ptr(h), shape=(nreads + 1,))
            if copy:
                yield codes.copy(), starts.copy()
            else:
                codes.flags.writeable = False
                starts.flags.writeable = False
                yield codes, starts
    finally:
        lib.fastseq_stream_close(h)


def _accept_args(shuf, accept):
    """The accept tables as ctypes arguments (tups, pfilters, count,
    bitmask), from ``accept`` or ``shuf.device_tables()``, and the arrays
    behind them, which must outlive the call."""
    if accept is None:
        accept = shuf.device_tables()
    tups = np.ascontiguousarray(accept[0], dtype=np.uint32)
    pf = np.ascontiguousarray(accept[1], dtype=np.uint32)
    mask = np.ascontiguousarray(
        accept[2] if len(accept) > 2 else shuf.accept_bitmask(),
        dtype=np.uint32)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    return (tups.ctypes.data_as(u32), pf.ctypes.data_as(u32),
            ctypes.c_int64(tups.size), mask.ctypes.data_as(u32)), \
        (tups, pf, mask)


def _take_drtuples(lib, out_ptr, n: int) -> np.ndarray:
    dr = _copy_out(out_ptr, n, np.uint64)
    if out_ptr:
        lib.sketch_cpu_free(out_ptr)
    return dr


def sketch_cpu(codes: np.ndarray, shuf, accept=None,
               nthreads: int = 0) -> np.ndarray:
    """All accepted drtuples of a code stream (duplicates kept, unsorted)
    from the native sketcher (``native/sketch_cpu.cpp``), bit-identical to
    ``golden.window_drtuples`` up to order.  ``nthreads`` <= 0 takes the
    OpenMP default; the serial build runs one thread whatever it says.
    Raises without the library."""
    lib = require()
    p = shuf.params
    args, _keep = _accept_args(shuf, accept)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out_ptr = ctypes.POINTER(ctypes.c_uint64)()
    n = lib.sketch_cpu_run(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(codes.size), p.k, p.subk, p.drlevel, *args,
        int(nthreads), ctypes.byref(out_ptr))
    return _take_drtuples(lib, out_ptr, n)


def sketch_fastq(path: str, shuf, accept=None, min_qual: int = 0,
                 nthreads: int = 0) -> np.ndarray:
    """All accepted drtuples of a fastq file (duplicates kept, unsorted)
    from the fused native parse, translate and sketch
    (``fastseq_sketch_file``): the file's codes never exist whole.  The
    same multiset as ``stream_fastq`` + ``sketch_cpu``.  Raises
    RuntimeError without the library, OSError where the file cannot be
    read."""
    lib = require()
    p = shuf.params
    args, _keep = _accept_args(shuf, accept)
    out_ptr = ctypes.POINTER(ctypes.c_uint64)()
    n_reads, n_bases = ctypes.c_int64(), ctypes.c_int64()
    n = lib.fastseq_sketch_file(
        path.encode(), int(min_qual), p.k, p.subk, p.drlevel, *args,
        int(nthreads), ctypes.byref(n_reads), ctypes.byref(n_bases),
        ctypes.byref(out_ptr))
    if n < 0:
        raise OSError(f"fastseq: cannot open or decode {path}")
    return _take_drtuples(lib, out_ptr, n)


def radix_sort_u32(keys: np.ndarray) -> None:
    """Sort a contiguous uint32 array in place (the native parallel LSD
    radix sort).  Raises without the library."""
    lib = require()
    if keys.dtype != np.uint32 or not keys.flags.c_contiguous:
        raise ValueError("radix_sort_u32: need a contiguous uint32 "
                         f"array, got {keys.dtype}")
    lib.k_radix_sort_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(keys.size),
        np.empty_like(keys).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))


def postings_expand(rows: np.ndarray, starts: np.ndarray,
                    gids: np.ndarray, ab: np.ndarray | None, total: int):
    """(genome int32 [total], abundance uint16 [total] or None): the
    postings ``starts[r] .. starts[r + 1]`` of every matched row r in
    turn, each with its row's ``ab`` entry; ``total`` is their count.
    Raises without the library."""
    lib = require()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    gids = np.ascontiguousarray(gids, dtype=np.int32)
    out_gid = np.empty(total, dtype=np.int32)
    out_ab = ab_ptr = ab_out_ptr = None
    if ab is not None:
        ab = np.ascontiguousarray(ab, dtype=np.uint16)
        out_ab = np.empty(total, dtype=np.uint16)
        ab_ptr = ab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        ab_out_ptr = out_ab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
    lib.postings_expand_i32(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(rows.size),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ab_ptr, out_gid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ab_out_ptr)
    return out_gid, out_ab


def format_name_float_lines(names_blob: bytes, name_off: np.ndarray,
                            order: np.ndarray, vals: np.ndarray):
    """Bulk b"name\\t%f\\n" formatting (glibc printf semantics); returns
    bytes, or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    name_off = np.ascontiguousarray(name_off, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    cap = len(names_blob) + 48 * order.size + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.format_name_float_lines(
        names_blob, name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(order.size), out, ctypes.c_int64(cap))
    if n < 0:
        return None
    return out.raw[:n]


def encode_names(names: list[str]) -> tuple[bytes, np.ndarray]:
    """(blob, offsets int64 [N + 1]): ``names`` UTF-8 encoded end to end,
    name i at ``blob[off[i]:off[i + 1]]``."""
    enc = [n.encode() for n in names]
    off = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in enc], out=off[1:])
    return b"".join(enc), off


def names_blob(names: list[str]) -> tuple[bytes | None, np.ndarray | None]:
    """``encode_names(names)`` as ``format_name_float_lines`` reads them,
    or (None, None) where the library is unavailable.  Built once per
    index, not per query."""
    if not available():
        return None, None
    return encode_names(names)


def write_name_float_lines(out, names, blob: bytes | None,
                           name_off: np.ndarray | None, order: np.ndarray,
                           vals: np.ndarray) -> None:
    """Write the lines ``name\t%f\n`` of samples ``order`` with ``vals``
    to the text stream ``out``: ``format_name_float_lines`` over ``blob``
    (``names_blob``) where it was built, else numpy's ``%f`` over
    ``names`` (a list or an object array), byte for byte the same."""
    vals = np.asarray(vals, dtype=np.float64)
    buf = None
    if blob is not None:
        buf = format_name_float_lines(blob, name_off, order, vals)
    if buf is not None:
        out.write(buf.decode())
        return
    sv = np.char.mod("%f\n", vals)
    names = np.asarray(names, dtype=object)
    out.write("".join((names[order] + "\t" + sv.astype(object)).tolist()))


def postings_count(rows: np.ndarray, starts: np.ndarray,
                   gids: np.ndarray, acc: np.ndarray) -> bool:
    """acc[gids[p]] += 1 over all postings of all (repeatable) rows —
    the dist shared-count inner loop in one native pass.  Returns False
    (caller falls back to NumPy) if the lib is unavailable."""
    lib = _load()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    gids = np.ascontiguousarray(gids, dtype=np.uint32)
    assert acc.dtype == np.uint32 and acc.flags.c_contiguous
    lib.postings_count_u32(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(rows.size),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        acc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(acc.size))
    return True


def postings_count_ranges(st: np.ndarray, en: np.ndarray,
                          gids: np.ndarray, acc: np.ndarray) -> bool:
    """acc[gids[p]] += 1 for p in [st[i], en[i]) — the dense-mco
    random-access count (gids may be a memory map; only touched pages
    fault in).  Returns False if the lib is unavailable."""
    lib = _load()
    if lib is None:
        return False
    st = np.ascontiguousarray(st, dtype=np.int64)
    en = np.ascontiguousarray(en, dtype=np.int64)
    assert gids.dtype == np.uint32 and gids.flags.c_contiguous
    assert acc.dtype == np.uint32 and acc.flags.c_contiguous
    lib.postings_count_ranges(
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        en.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(st.size),
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        acc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(acc.size))
    return True


def postings_group_stats(gids: np.ndarray, ab: np.ndarray, nref: int,
                         st_pctl: float, ed_pctl: float):
    """Per-genome reference profile stats over unordered matched
    postings: (count, sum, lastsum, lastn, median, max) int64 arrays,
    or None if the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    gids = np.ascontiguousarray(gids, dtype=np.int32)
    ab = np.ascontiguousarray(ab, dtype=np.uint16)
    outs = [np.empty(nref, dtype=np.int64) for _ in range(6)]
    ptrs = [o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            for o in outs]
    lib.postings_group_stats(
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(gids.size), ctypes.c_int64(nref),
        ctypes.c_double(st_pctl), ctypes.c_double(ed_pctl), *ptrs)
    return tuple(outs)


def kv_radix_sort(keys: np.ndarray, vals: np.ndarray):
    """Stable in-place sort of (uint32 key, int32 val) pairs by key
    (parallel LSD radix; builds the MarkerDB inverted index ~3x faster
    than argsort+gather at 59M postings).  Raises if the lib is
    unavailable — callers must pre-check available(); a silent False
    here would let unsorted data feed downstream sorted invariants."""
    lib = _load()
    if lib is None:
        raise RuntimeError("kv_radix_sort: native lib unavailable "
                           "(check available() and fall back to numpy)")
    if (keys.dtype != np.uint32 or vals.dtype != np.int32
            or not keys.flags.c_contiguous
            or not vals.flags.c_contiguous
            or keys.size != vals.size):
        raise ValueError("kv_radix_sort: need equal-size contiguous "
                         f"uint32/int32 arrays, got {keys.dtype}"
                         f"[{keys.size}] / {vals.dtype}[{vals.size}]")
    ks = np.empty_like(keys)
    vs = np.empty_like(vals)
    lib.kv_radix_sort_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(keys.size),
        ks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return True




def invert_postings(ids: np.ndarray, gindex: np.ndarray, nref: int):
    """(keys_sorted u32, genome_rows i32) of a combco posting stream —
    the fused copy + repeat + stable kv radix sort (reads the mmap'd
    ids directly; see native/postings.cpp invert_core_u32).  None when
    the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    gindex = np.ascontiguousarray(gindex, dtype=np.uint64)
    if gindex.size != nref + 1:
        raise ValueError(f"invert_postings: gindex has {gindex.size} "
                         f"entries for {nref} genomes")
    n = ids.size
    if gindex.size and int(gindex[-1]) != n:
        # size-consistency guard (the pre-fusion path got this for free
        # from kv_radix_sort's equal-size check): a truncated/corrupt
        # combco index would otherwise yield silently wrong — even
        # out-of-range — genome rows
        raise ValueError(f"invert_postings: gindex[-1]={int(gindex[-1])}"
                         f" != ids.size={n} (corrupt sketch dir?)")
    keys = np.empty(n, np.uint32)
    vals = np.empty(n, np.int32)
    ks = np.empty(n, np.uint32)
    vs = np.empty(n, np.int32)
    lib.invert_postings_u32(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        gindex.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int32(nref), ctypes.c_int64(n),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return keys, vals


def sorted_unique_pack(keys: np.ndarray):
    """(distinct_keys u32, first_idx i64) of an ascending-sorted uint32
    array in one fused parallel pass; None when the lib is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    if keys.dtype != np.uint32 or not keys.flags.c_contiguous:
        raise ValueError("sorted_unique_pack: need a contiguous uint32 "
                         f"array, got {keys.dtype}")
    kp = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    count = lib.sorted_unique_pack_u32(
        kp, ctypes.c_int64(keys.size),
        ctypes.cast(None, ctypes.POINTER(ctypes.c_int64)),
        ctypes.cast(None, ctypes.POINTER(ctypes.c_uint32)))
    idx = np.empty(count, dtype=np.int64)
    rk = np.empty(count, dtype=np.uint32)
    if count:
        lib.sorted_unique_pack_u32(
            kp, ctypes.c_int64(keys.size),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return rk, idx


def sorted_first_indices(keys: np.ndarray):
    """int64 first-occurrence indices of an ascending-sorted uint32
    array (parallel two-pass); None when the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if keys.dtype != np.uint32 or not keys.flags.c_contiguous:
        raise ValueError("sorted_first_indices: need a contiguous "
                         f"uint32 array, got {keys.dtype}")
    kp = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    count = lib.sorted_first_indices_u32(
        kp, ctypes.c_int64(keys.size),
        ctypes.cast(None, ctypes.POINTER(ctypes.c_int64)))
    out = np.empty(count, dtype=np.int64)
    if count:
        lib.sorted_first_indices_u32(
            kp, ctypes.c_int64(keys.size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out
