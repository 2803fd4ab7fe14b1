"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds).  The library
lands in ``metakssd_tpu_torch/_build/``, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is loaded as
is.  Nothing here runs at import time: the CPU-only test environment
imports every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # codes, n_codes, nwin, accept, pfil, n_accept, filter, filter_log2,
    # k, subk, drlevel, out_dr, out_pos, counter, capacity, stream
    "mkssd_sketch_compact": [_P, _LL, _LL, _P, _P, _I, _P, _I, _I, _I, _I,
                             _P, _P, _P, _LL, _P],
    # codes, n_codes, nwin, accept, pfil, n_accept, filter, filter_log2,
    # k, subk, drlevel, out_dr, out_keep, stream
    "mkssd_sketch_full": [_P, _LL, _LL, _P, _P, _I, _P, _I, _I, _I, _I,
                          _P, _P, _P],
    # hay, nh, nb, shift, table, stream
    "mkssd_member_index": [_P, _LL, _LL, _I, _P, _P],
    # hay, nh, table (NULL when nb == 0), nb, shift, values (NULL =
    # identity), needles, nn, out_member, out_value, stream
    "mkssd_member": [_P, _LL, _P, _LL, _I, _P, _P, _LL, _P, _P, _P],
    # tiles, dtype, nb, tile_rows, row0, row1, op, out, partial, tickets,
    # stream
    "mkssd_probe_floor": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # tiles, dtype, nb, tile_rows, nrows, TL, out, partial, tickets, stream
    "mkssd_probe_winmath": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # tiles, nb, tile_rows, nrows, table, table_dtype, table_size, mult,
    # ng, out, partial, tickets, stream
    "mkssd_probe_gather": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P,
                           _P],
    # tiles, nb, tile_rows, nrows, k, subk, drlevel, accept, n_accept,
    # index, n_buckets, shift, lev, sig (NULL = exact form), sig_words,
    # out, partial, tickets, stream
    "mkssd_probe_search": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I,
                           _P, _P, _I, _P, _P, _P, _P],
}

_lib = None
build_log = ""          # nvcc's stderr (ptxas register/smem report)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmkssd_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a library of the same hash exists;
    returns its path.  Raises with nvcc's output if the build fails."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, errors = [], []
    for src, _, proc in jobs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} ({proc.returncode}):\n"
                          f"{out}{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = f"{so}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_log = "".join(logs)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
