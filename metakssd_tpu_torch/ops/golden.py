"""Bit-exact NumPy model of KSSD sketching (the semantic oracle).

Vectorised re-derivation of the reference per-base loop
(reference iseq2comem.c:240-311, 380-410, 480-507): every window of
``2k`` consecutive valid bases yields a canonical tuple
min(forward, revcomp); its inner substring indexes the shuffle table;
accepted windows produce a ``drtuple`` that is a losslessly recoverable
4*(k-drlevel)-bit re-packing (outer context above, reduced substring
code below).

The port's copy of ``metakssd_tpu/ops/golden.py``: the route of configs
that the CUDA kernels do not take (``ops/sketch.py``), and the model that
the kernels and their plain versions must match exactly.
"""

from __future__ import annotations

import numpy as np

from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.formats.shuf import DimShuffle


def window_drtuples(codes: np.ndarray, shuf: DimShuffle,
                    return_positions: bool = False) -> np.ndarray:
    """All accepted drtuples in stream order (duplicates preserved).

    codes: uint8 stream (0-3 base codes, >=4 reset).
    Returns uint64 drtuples (with ``return_positions``, also the window
    start position of each).
    """
    p = shuf.params
    TL = p.kmer_len
    n = codes.size
    if n < TL:
        empty = np.zeros(0, dtype=np.uint64)
        return (empty, np.zeros(0, np.int64)) if return_positions else empty
    c = codes.astype(np.uint64)
    valid = codes < 4
    c = np.where(valid, c, 0)

    nwin = n - TL + 1
    fwd = np.zeros(nwin, dtype=np.uint64)
    rc = np.zeros(nwin, dtype=np.uint64)
    for j in range(TL):
        seg = c[j:j + nwin]
        fwd |= seg << np.uint64(2 * (TL - 1 - j))
        rc |= (seg ^ np.uint64(3)) << np.uint64(2 * j)

    # validity: all TL positions of the window are valid bases
    ok = np.all(
        np.lib.stride_tricks.sliding_window_view(valid, TL), axis=1)

    uni = np.minimum(fwd, rc)
    dim_tup = (uni & np.uint64(p.domask)) >> np.uint64(2 * p.outctx)
    pfilter = shuf.shuffled_dim[dim_tup.astype(np.int64)].astype(np.int64)
    keep = ok & (pfilter >= p.dim_start) & (pfilter < p.dim_end)

    uni = uni[keep]
    pf = (pfilter[keep] - p.dim_start).astype(np.uint64)
    outer_mask = np.uint64((1 << (2 * p.outctx)) - 1)
    dr = ((((uni & np.uint64(p.undomask))
            + ((uni & outer_mask) << np.uint64(4 * p.k - 4 * p.outctx)))
           >> np.uint64(4 * p.drlevel))
          + pf)
    if return_positions:
        return dr, np.nonzero(keep)[0].astype(np.int64)
    return dr






def drtuple_to_kmer(dr: np.ndarray, shuf: DimShuffle) -> np.ndarray:
    """Invert drtuples back to canonical 2k-base tuples
    (reference command_reverse.c:355-368)."""
    p = shuf.params
    rev = shuf.reverse_array()
    pf_bits = 4 * (p.subk - p.drlevel)
    inner_bits = 4 * p.subk
    half_outer_bits = 2 * p.outctx
    dr = dr.astype(np.uint64)
    ind = rev[(dr % np.uint64(4096)).astype(np.int64)].astype(np.uint64)
    tup = ((dr >> np.uint64(pf_bits)) << np.uint64(inner_bits)) + ind
    hom = np.uint64(((1 << half_outer_bits) - 1) << inner_bits)
    uni = ((tup & (hom << np.uint64(half_outer_bits)))
           + ((tup & hom) >> np.uint64(inner_bits))
           + ((tup & np.uint64((1 << inner_bits) - 1))
              << np.uint64(half_outer_bits)))
    return uni




def sets_from_drtuples(dr: np.ndarray, p, mode: str = "set",
                       min_occ: int = 1
                       ) -> list[tuple[np.ndarray, np.ndarray | None]]:
    """Unique/count/mode-filter a drtuple multiset and split components
    (shared by all sketching paths)."""
    uniq, counts = np.unique(dr, return_counts=True)
    if mode == "uniq":
        uniq, counts = uniq[counts == 1], None
    elif mode == "occ":
        uniq, counts = uniq[counts >= min_occ], None
    elif mode == "set":
        counts = None
    elif mode == "koc":
        counts = np.minimum(counts, 0xFFFF).astype(np.uint16)
    else:
        raise ValueError(mode)
    comp = (uniq % np.uint64(p.component_num)).astype(np.int64)
    ids = (uniq >> np.uint64(p.comp_code_bits)).astype(np.uint32)
    return [(ids[comp == ci], counts[comp == ci] if counts is not None else None)
            for ci in range(p.component_num)]
