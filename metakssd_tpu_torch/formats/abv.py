"""Abundance-vector artifacts (reference command_composite.c).

.abv file: binVec_t { int32 ref_idx; float32 pct } records
(command_composite.h:12-16, written command_composite.c:634).

Index files under <refdir>/ named abundance_Vec.{abm,abmi,name,yl2n}
(command_composite.c:377-431):
    abm   — binVec_t postings: per species, (sample_idx, pct) pairs
    abmi  — int32[nspecies] cumulative posting counts
    name  — newline-separated sample file names
    yl2n  — float64[nsamples] L2 norms
"""

from __future__ import annotations

import dataclasses
import os
import numpy as np

BINVEC_DIRNAME = "abundance_Vec"
_ABV_DT = np.dtype([("ref_idx", "<i4"), ("pct", "<f4")])


def read_abv_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    rec = np.fromfile(path, dtype=_ABV_DT)
    return rec["ref_idx"].copy(), rec["pct"].copy()


def write_abv_file(path: str, ref_idx: np.ndarray, pct: np.ndarray) -> None:
    rec = np.empty(ref_idx.size, dtype=_ABV_DT)
    rec["ref_idx"] = ref_idx
    rec["pct"] = pct
    rec.tofile(path)


@dataclasses.dataclass
class AbvIndex:
    names: list[str]
    y_l2n: np.ndarray      # float64[nsamples]
    abmi: np.ndarray       # int32[nspecies] cumulative counts
    abm_idx: np.ndarray    # int32[total] sample index per posting
    abm_pct: np.ndarray    # float32[total]

    def _paths(self, refdir: str) -> dict[str, str]:
        b = os.path.join(refdir, BINVEC_DIRNAME)
        return {"abm": b + ".abm", "abmi": b + ".abmi",
                "name": b + ".name", "yl2n": b + ".yl2n"}

    def write(self, refdir: str) -> None:
        p = self._paths(refdir)
        rec = np.empty(self.abm_idx.size, dtype=_ABV_DT)
        rec["ref_idx"] = self.abm_idx
        rec["pct"] = self.abm_pct
        rec.tofile(p["abm"])
        self.abmi.astype(np.int32).tofile(p["abmi"])
        with open(p["name"], "w") as f:
            for n in self.names:
                f.write(n + "\n")
        self.y_l2n.astype(np.float64).tofile(p["yl2n"])

    @classmethod
    def read(cls, refdir: str) -> "AbvIndex":
        b = os.path.join(refdir, BINVEC_DIRNAME)
        with open(b + ".name") as f:
            names = [ln.rstrip("\n") for ln in f if ln.strip()]
        y_l2n = np.fromfile(b + ".yl2n", dtype=np.float64)
        abmi = np.fromfile(b + ".abmi", dtype=np.int32)
        rec = np.fromfile(b + ".abm", dtype=_ABV_DT)
        return cls(names, y_l2n, abmi, rec["ref_idx"].copy(),
                   rec["pct"].copy())
