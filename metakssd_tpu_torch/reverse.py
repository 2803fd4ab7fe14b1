"""Sketch -> k-mer string recovery (reference command_reverse.c).

The drtuple repacking is lossless; with the shuffle file's reverse array
every sketch id inverts to its canonical 2k-base k-mer
(core_reverse2unituple, command_reverse.c:355-368).
"""

from __future__ import annotations

import os
import sys
import numpy as np

from metakssd_tpu_torch.formats.codir import CoDir
from metakssd_tpu_torch.formats.shuf import read_shuf
from metakssd_tpu_torch.ops import golden

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _kmer_strings(unis: np.ndarray, TL: int) -> list[str]:
    """Vectorised unituple -> base-string decoding."""
    n = unis.size
    out = np.empty((n, TL), dtype=np.uint8)
    u = unis.copy()
    for i in range(TL - 1, -1, -1):
        out[:, i] = _BASES[(u & np.uint64(3)).astype(np.int64)]
        u >>= np.uint64(2)
    return [row.tobytes().decode() for row in out]


def co_reverse2kmer(codir: str, shuf_file: str, outdir: str = ".",
                    byreads: bool = False, out=None) -> None:
    shuf = read_shuf(shuf_file)
    p = shuf.params
    TL = p.kmer_len
    cd = CoDir.read(codir, want_abund=False)
    out = out or sys.stdout
    # component bits come from the DIR's component count, not the shuf
    # default: the .shuf file does not carry COMPONENT_SZ, so a sketch
    # written by a cs6/cs7 build splits ids across 16^(kd-6/7)
    # components while p.comp_code_bits (default build) says 0 —
    # reconstructing dr = id + c instead of (id << bits) | c (found by
    # the property fuzzer, case 5020: every multi-component k-mer
    # reversed wrong)
    ccb = cd.stat.comp_num.bit_length() - 1
    if (1 << ccb) != cd.stat.comp_num:
        raise ValueError(    # clean CLI diagnostic, survives python -O
            f"reverse: comp_num {cd.stat.comp_num} is not a power of "
            f"two — corrupt or foreign cofiles.stat?")

    if byreads:
        # per-read mode: combco.index.c indexes reads, printed to stdout
        # (reference co_rvs2kmer_byreads, command_reverse.c:148-232)
        # every component's ids invert in one pass (the shuffle's reverse
        # array is built per call), then print read by read
        nreads = cd.index[0].size - 1
        kmers = [_kmer_strings(golden.drtuple_to_kmer(
            (np.asarray(cd.ids[c]).astype(np.uint64) << np.uint64(ccb))
            + np.uint64(c), shuf), TL) for c in range(cd.stat.comp_num)]
        bounds = [np.asarray(cd.index[c]).astype(np.int64).tolist()
                  for c in range(cd.stat.comp_num)]
        for r in range(nreads):
            out.write(f">read {r + 1}\n")
            for c in range(cd.stat.comp_num):
                for s in kmers[c][bounds[c][r]:bounds[c][r + 1]]:
                    out.write(s + "\n")
        return

    os.makedirs(outdir, exist_ok=True)
    for g in range(cd.stat.infile_num):
        if not any(cd.genome_ids(c, g).size
                   for c in range(cd.stat.comp_num)):
            continue   # reference writes no file for empty sketches
        fname = os.path.basename(cd.stat.names[g]).replace(" ", "_")
        with open(os.path.join(outdir, fname), "w") as f:
            for c in range(cd.stat.comp_num):
                ids = cd.genome_ids(c, g)
                dr = (ids.astype(np.uint64) << np.uint64(ccb)) \
                    + np.uint64(c)
                unis = golden.drtuple_to_kmer(dr, shuf)
                for s in _kmer_strings(unis, TL):
                    f.write(s + "\n")
