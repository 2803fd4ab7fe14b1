"""Inputs and comparisons shared by the tests of the port's sketch
kernels.  Imports neither jax nor the JAX package, so the CUDA-marked
tests can run on a GPU machine that has neither."""

from __future__ import annotations

import numpy as np

from metakssd_tpu_torch.formats.shuf import DimShuffle, make_shuf
from metakssd_tpu_torch.params import SketchParams

# (k, subk, drlevel); (5, 5, 2) has outctx = 0 (no outer context)
CONFIGS = [(8, 5, 2), (11, 6, 3), (7, 5, 3), (6, 4, 2), (5, 5, 2)]


def random_codes(seed: int, n: int, n_invalid: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, n, n_invalid)] = 255
    codes[rng.integers(0, n, n_invalid)] = 4
    return codes


def pairs(dr, pos):
    """(positions, drtuples uint64) in one canonical order."""
    dr = np.asarray(dr).astype(np.uint64)
    order = np.lexsort((dr, pos))
    return np.asarray(pos)[order], dr[order]


def assert_pairs_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def zero_accepted(p: SketchParams, seed: int) -> DimShuffle:
    """A shuffle whose substring 0 is accepted with pfilter 0: the
    poly-A k-mer (canonical tuple 0) is then kept with drtuple 0."""
    shuf = make_shuf(p, seed=seed)
    arr = shuf.shuffled_dim.copy()
    j = int(np.flatnonzero(arr == 0)[0])
    arr[0], arr[j] = arr[j], arr[0]
    return DimShuffle(shuf.params, arr)
