"""The chip's peaks and the least work of an abv search call.

Peaks: NVIDIA's H100 SXM data sheet (dense, at its 700 W limit): 67
TFLOP/s of float32 outside the tensor cores, 3.35 TB/s of HBM3.  The
card's power limit is printed beside every share (``nvidia-smi``).

The work is counted as the inputs need it, whatever computes it: the abv
database is a sparse product, so a call reads each posting of its
queries' species once (int32 sample id + float32 percentage), each query
nonzero once (the same record), writes one float32 for each overlapping
(query, sample) pair, and spends the mode's operations on each posting.
A dense route does far more; a sparse one can reach this count, so no
implementation reads above 100%.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

POSTING_BYTES = 8
QUERY_NNZ_BYTES = 8
PAIR_BYTES = 4
# cosine: multiply, add; L1: subtract, absolute value, add; L2: subtract,
# square, add
OPS_PER_POSTING = {0: 2, 1: 3, 2: 3}


def abv_work(postings: int, nnz: int, pairs: int, mode: int
             ) -> tuple[float, float]:
    """(operations, bytes) of one query: ``postings`` of its species,
    ``nnz`` nonzeros, ``pairs`` overlapping samples."""
    ops = float(OPS_PER_POSTING[mode] * postings)
    nbytes = float(POSTING_BYTES * postings + QUERY_NNZ_BYTES * nnz
                   + PAIR_BYTES * pairs)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of its two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
