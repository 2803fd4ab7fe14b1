""".shuf dimension-shuffle files.

Layout (reference command_shuffle.c:204-206):
    dim_shuffle_stat_t { int id, k, subk, drlevel }   (16 bytes, little-endian)
    int32[16**subk]                                    (the shuffled dimensions)

The array is a Fisher-Yates permutation of ``range(16**subk)``; an entry
``shuf[d] < dim_end`` means inner-substring value ``d`` is *accepted* and
``shuf[d]`` becomes the reduced substring code ("pfilter").

Device note: the engine never ships this table to the device.  Instead
:meth:`DimShuffle.accept_table` extracts the ~``dim_end`` accepted entries
as (sorted dim_tup, pfilter) pairs — a few KiB — which is what the device
kernels consume.
"""

from __future__ import annotations

import dataclasses
import struct
import numpy as np

from metakssd_tpu_torch.params import SketchParams, MIN_SUBCTX_DIM_SMP_SZ

_STAT = struct.Struct("<iiii")


@dataclasses.dataclass
class DimShuffle:
    params: SketchParams
    shuffled_dim: np.ndarray  # int32[16**subk]

    def accept_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (accept_tups sorted uint32, pfilter uint32 aligned).

        accept_tups are the dim_tup values with
        dim_start <= shuf[dim_tup] < dim_end; pfilter[i] =
        shuf[accept_tups[i]] - dim_start (reference iseq2comem.c:287-294).
        """
        cached = getattr(self, "_accept_table", None)
        if cached is not None:
            return cached
        p = self.params
        keep = (self.shuffled_dim >= p.dim_start) & (self.shuffled_dim < p.dim_end)
        tups = np.nonzero(keep)[0].astype(np.uint32)      # already sorted
        pf = (self.shuffled_dim[tups] - p.dim_start).astype(np.uint32)
        # memoized: the scan over the 16^subk shuffle is ~120 ms at
        # subk=6 and callers (device_tables, accept_bitmask) repeat it
        object.__setattr__(self, "_accept_table", (tups, pf))
        return tups, pf

    def accept_bitmask(self) -> np.ndarray:
        """Exact membership bitmask over the 16**subk substring space
        (2 MiB for subk=6): bit d set iff dim_tup d is accepted.  This is
        what the device filter gathers — one word per window."""
        p = self.params
        tups, _ = self.accept_table()
        mask = np.zeros((p.shuf_len + 31) // 32, dtype=np.uint32)
        np.bitwise_or.at(mask, tups >> 5,
                         np.uint32(1) << (tups & np.uint32(31)))
        return mask

    def device_tables(self):
        """(accept_tups, pfilters, accept_bitmask) ready for the kernels.

        Memoized: the derivation scans the 16^subk shuffle (~60 ms at
        subk=6), which would dominate small sketching runs if rebuilt
        per pipeline call."""
        cached = getattr(self, "_device_tables", None)
        if cached is None:
            tups, pf = self.accept_table()
            cached = (tups, pf, self.accept_bitmask())
            object.__setattr__(self, "_device_tables", cached)
        return cached

    def reverse_array(self) -> np.ndarray:
        """pfilter -> dim_tup inverse map (reference command_reverse.c:242-250)."""
        keep = self.shuffled_dim < MIN_SUBCTX_DIM_SMP_SZ
        rev = np.zeros(MIN_SUBCTX_DIM_SMP_SZ, dtype=np.uint32)
        idx = np.nonzero(keep)[0]
        if idx.size != MIN_SUBCTX_DIM_SMP_SZ:
            raise ValueError(
                f"shuffle has {idx.size} entries < {MIN_SUBCTX_DIM_SMP_SZ}; "
                "cannot build reverse array")
        rev[self.shuffled_dim[idx]] = idx
        return rev


def read_shuf(path: str) -> DimShuffle:
    with open(path, "rb") as f:
        sid, k, subk, drlevel = _STAT.unpack(f.read(_STAT.size))
        params = SketchParams(k=k, subk=subk, drlevel=drlevel, shuf_id=sid)
        params.validate()
        arr = np.fromfile(f, dtype=np.int32, count=params.shuf_len)
    if arr.size != params.shuf_len:
        raise ValueError(f"{path}: truncated shuffle array "
                         f"({arr.size} != {params.shuf_len})")
    return DimShuffle(params, arr)


def write_shuf(path: str, shuf: DimShuffle) -> None:
    p = shuf.params
    with open(path, "wb") as f:
        f.write(_STAT.pack(p.shuf_id, p.k, p.subk, p.drlevel))
        shuf.shuffled_dim.astype(np.int32).tofile(f)


def make_shuf(params: SketchParams, seed: int | None = None) -> DimShuffle:
    """Generate a fresh random permutation (reference uses srand(time);
    we use a seeded PRNG for reproducibility, id = derived random)."""
    rng = np.random.default_rng(seed)
    arr = rng.permutation(params.shuf_len).astype(np.int32)
    sid = params.shuf_id or int(rng.integers(1, 2**31 - 1))
    return DimShuffle(dataclasses.replace(params, shuf_id=sid), arr)
