"""The plain reference of the abv search (reference tool's ``abv_search``,
command_composite.c:217-348), in NumPy and float64.

It works from the generated sparse vectors (``abv_corpus.Vectors``), never
from the index files or any array of the program, and imports nothing of
the program.  For a query x and a sample y, over the species both hold
(the overlap; a sample with none is not reported):

- mode 0, cosine: sum x*y / (|x| |y|), |y| over all of y's species;
- mode 1, L1: sum |x - y| + (200 - sum x - sum y), the sums over the
  overlap (the reference tool's complement term for percentages);
- mode 2, L2: sqrt(sum (x - y)^2).
"""

from __future__ import annotations

import numpy as np


class Reference:
    """Measures of queries against one database of sparse vectors."""

    def __init__(self, db, n_species: int):
        self.db = db
        self.n_species = n_species
        self.owner = db.owner()
        self.y = db.pct.astype(np.float64)
        self.ynorm = np.sqrt(np.bincount(self.owner, weights=self.y * self.y,
                                         minlength=db.n))

    def search(self, species: np.ndarray, pct: np.ndarray, mode: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """(ids of the samples that overlap the query, ascending; their
        measure, float64)."""
        x = np.zeros(self.n_species, dtype=np.float64)
        x[species] = pct
        hit = np.flatnonzero(x[self.db.species] != 0)
        own = self.owner[hit]
        xs = x[self.db.species[hit]]
        ys = self.y[hit]
        n = self.db.n
        ids = np.flatnonzero(np.bincount(own, minlength=n))
        if mode == 0:
            dot = np.bincount(own, weights=xs * ys, minlength=n)
            val = dot[ids] / (np.sqrt(np.sum(x * x)) * self.ynorm[ids])
        elif mode == 1:
            acc = np.bincount(own, weights=np.abs(xs - ys) - xs - ys,
                              minlength=n)
            val = acc[ids] + 200.0
        else:
            acc = np.bincount(own, weights=(xs - ys) ** 2, minlength=n)
            val = np.sqrt(acc[ids])
        return ids, val

    def row_checksums(self) -> np.ndarray:
        """Per sample, sum over its species j of bits(pct_j) * (j + 1), in
        int64: the dense row's checksum (``dense_checksums``), exact."""
        bits = self.db.pct.view(np.int32).astype(np.int64)
        w = bits * (self.db.species.astype(np.int64) + 1)
        return np.add.reduceat(w, self.db.ptr[:-1])
