"""ctypes bindings for the native C++ host library (``native/*.cpp`` at
the repo root): the sequence parser and the posting passes.  The port's
copy of ``metakssd_tpu/io/native.py``.

The library builds on first use from the shared sources, with the flags
of ``native/Makefile``, into ``metakssd_tpu_torch/_build/`` under a name
of its own (a hash of the sources and flags), so the two packages never
share one ``.so``.  When no compiler can build it, every caller takes its
numpy route (``MKSSD_NO_NATIVE=1`` forces that).  Host code only: no
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

_lib = None
_tried = False


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for src in sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp"))
                      + glob.glob(os.path.join(_NATIVE_DIR, "*.h"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libfastseq_torch_{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    """Path of the built library, or None when it cannot be built."""
    so = _library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    srcs = [os.path.join(_NATIVE_DIR, f)
            for f in ("fastseq.cpp", "sketch_cpu.cpp", "postings.cpp")]
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-shared", *srcs, "-o", tmp, "-lz"],
                       check=True, capture_output=True)
        os.replace(tmp, so)       # atomic: a concurrent builder's twin wins
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return so


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
        lib = ctypes.CDLL(so)
    except OSError:
        return None
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
    lib.format_name_float_lines.restype = ctypes.c_int64
    lib.format_name_float_lines.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


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
