"""Combined-sketch directory (".co dir") reader/writer.

A sketch directory holds, per component c (reference command_dist.c:407-470):
    combco.c         u32 k-mer ids, all genomes concatenated
    combco.index.c   u64 (size_t) cumulative k-mer counts, [infile_num+1]
    combco.c.a       u16 abundances parallel to combco.c (koc mode only)
    cofiles.stat     header (see formats.costat)

This engine always *writes* each genome's ids in ascending order (the
canonical form; the reference emits hash-table order, which downstream
readers treat as an unordered set).  Readers accept either order.
"""

from __future__ import annotations

import dataclasses
import os
import numpy as np

from metakssd_tpu_torch.formats.costat import CoStat

SKCH_PREFIX = "combco"            # reference command_set.c:236-239
IDX_PREFIX = "combco.index"
PAN_PREFIX = "pan"
UNIQ_PAN_PREFIX = "uniq_pan"


def _mmap_or_empty(path: str, dtype) -> np.ndarray:
    """Read-only memmap (zero-copy for multi-GiB sketch/index files);
    empty files yield empty arrays (np.memmap rejects length 0)."""
    if os.path.getsize(path) == 0:
        return np.zeros(0, dtype=dtype)
    return np.memmap(path, dtype=dtype, mode="r")


@dataclasses.dataclass
class CoDir:
    """In-memory view of a sketch directory."""

    stat: CoStat
    ids: list[np.ndarray]          # per component: uint32[total]
    index: list[np.ndarray]        # per component: uint64[infile_num+1]
    abund: list[np.ndarray] | None  # per component: uint16[total] (koc only)

    @classmethod
    def read(cls, dirpath: str, want_abund: bool | None = None) -> "CoDir":
        stat = CoStat.read(dirpath)
        ids, index, abund = [], [], []
        has_a = stat.koc if want_abund is None else want_abund
        for c in range(stat.comp_num):
            ids.append(_mmap_or_empty(
                os.path.join(dirpath, f"{SKCH_PREFIX}.{c}"), np.uint32))
            index.append(_mmap_or_empty(
                os.path.join(dirpath, f"{IDX_PREFIX}.{c}"), np.uint64))
            if has_a:
                apath = os.path.join(dirpath, f"{SKCH_PREFIX}.{c}.a")
                abund.append(_mmap_or_empty(apath, np.uint16)
                             if os.path.exists(apath) else None)
        if has_a and any(a is None for a in abund):
            has_a = False
        return cls(stat, ids, index, abund if has_a else None)

    def genome_ids(self, c: int, g: int) -> np.ndarray:
        lo, hi = int(self.index[c][g]), int(self.index[c][g + 1])
        return self.ids[c][lo:hi]

    def genome_abund(self, c: int, g: int) -> np.ndarray:
        lo, hi = int(self.index[c][g]), int(self.index[c][g + 1])
        return self.abund[c][lo:hi]

    def write(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        for c in range(self.stat.comp_num):
            self.ids[c].astype(np.uint32).tofile(
                os.path.join(dirpath, f"{SKCH_PREFIX}.{c}"))
            self.index[c].astype(np.uint64).tofile(
                os.path.join(dirpath, f"{IDX_PREFIX}.{c}"))
            if self.abund is not None:
                self.abund[c].astype(np.uint16).tofile(
                    os.path.join(dirpath, f"{SKCH_PREFIX}.{c}.a"))
        self.stat.write(dirpath)


def write_codir(dirpath: str, stat: CoStat,
                per_genome: list[list[tuple[np.ndarray, np.ndarray | None]]]) -> CoDir:
    """Assemble and write a sketch dir.

    per_genome[g][c] = (ids uint32 sorted, abund uint16 | None) for genome g,
    component c.
    """
    nfile = len(per_genome)
    comp_num = stat.comp_num
    ids, index, abund = [], [], ([] if stat.koc else None)
    for c in range(comp_num):
        chunks = [per_genome[g][c][0] for g in range(nfile)]
        counts = np.array([ch.size for ch in chunks], dtype=np.uint64)
        idx = np.zeros(nfile + 1, dtype=np.uint64)
        np.cumsum(counts, out=idx[1:])
        ids.append(np.concatenate(chunks) if chunks else
                   np.zeros(0, dtype=np.uint32))
        index.append(idx)
        if stat.koc:
            ab = [per_genome[g][c][1] for g in range(nfile)]
            abund.append(np.concatenate(ab) if ab else np.zeros(0, np.uint16))
    cd = CoDir(stat, ids, index, abund)
    cd.write(dirpath)
    return cd
