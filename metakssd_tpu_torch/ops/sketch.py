"""Sketch a code stream on a device: the port of
``metakssd_tpu/ops/sketch_xla.py:302-472``.

Every config with k - drlevel <= 8 (32-bit drtuples) and an accept table
that fits the kernels' shared memory runs the K1/K2 chunk loop
(``sketch_cuda.sketch_windows``): the CUDA kernels on a CUDA device,
their plain PyTorch versions on the CPU.  Wider configs, or larger
tables, go through the numpy model ``ops/golden.py`` (copied from
``metakssd_tpu/ops/golden.py``), as the JAX package does for k - drlevel > 8 (``sketch_xla.py:312-318``).
"""

from __future__ import annotations

import numpy as np

from metakssd_tpu_torch.ops import golden, sketch_cuda
from metakssd_tpu_torch.ops.golden import sets_from_drtuples
from metakssd_tpu_torch.state import AcceptTables, accept_tables

# Largest accept table the kernels stage in shared memory: 2 x 64 KiB
# (the Pallas kernel's bound too, sketch_pallas.py:665).
MAX_ACCEPT = 1 << 14


def on_device_path(shuf) -> bool:
    p = shuf.params
    return (p.k - p.drlevel <= 8
            and shuf.accept_table()[0].size <= MAX_ACCEPT)


def _windows(codes, shuf, device, tables, want_pos, **kw):
    tables = tables if tables is not None else accept_tables(shuf, device)
    return sketch_cuda.sketch_windows(np.asarray(codes, np.uint8),
                                      shuf.params, tables,
                                      want_pos=want_pos, **kw)


def sketch_codes(codes: np.ndarray, shuf, device,
                 tables: AcceptTables | None = None, **kw) -> np.ndarray:
    """All accepted drtuples of a code stream, sorted uint64 with
    duplicates kept (``sketch_xla.sketch_codes``).  ``kw`` reaches the
    chunk loop (``chunk_windows``, ``capacity``)."""
    if not on_device_path(shuf):
        return np.sort(golden.window_drtuples(codes, shuf))
    dr, _ = _windows(codes, shuf, device, tables, False, **kw)
    dr = dr.astype(np.uint64)
    dr.sort()
    return dr


def sketch_codes_with_positions(codes: np.ndarray, shuf, device,
                                tables: AcceptTables | None = None, **kw
                                ) -> tuple[np.ndarray, np.ndarray]:
    """All accepted (drtuple uint64, window position int64) pairs,
    unsorted, duplicates kept (``sketch_xla.sketch_codes_with_positions``)."""
    if not on_device_path(shuf):
        return golden.window_drtuples(codes, shuf, return_positions=True)
    dr, pos = _windows(codes, shuf, device, tables, True, **kw)
    return dr.astype(np.uint64), pos


def sketch_to_sets(codes: np.ndarray, shuf, device, mode: str = "set",
                   min_occ: int = 1, tables: AcceptTables | None = None):
    """Per-component (ids, counts) of a code stream
    (``sketch_xla.sketch_to_sets``)."""
    dr = sketch_codes(codes, shuf, device, tables)
    return sets_from_drtuples(dr, shuf.params, mode=mode, min_occ=min_occ)
