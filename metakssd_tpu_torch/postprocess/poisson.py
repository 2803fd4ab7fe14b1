"""Poisson-corrected relative abundance from composite output
(port of reference src/possion.kssd2out.pl)."""

from __future__ import annotations

import sys

POISSON_N = (0, 0.02, 0.08, 0.69, 1.57, 2.49, 3.41, 4.31, 5.20, 6.08, 6.94)
POISSON_N_THR = 5
AVGPCT9899_OFFSET = 3


def _sanitize(sample: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "_." else "_"
                   for ch in sample)


def poisson_abundance(lines, shkm_thr: int = 6, out=None) -> None:
    """composite TSV lines -> 'sample ref relative_abundance' rows.

    Depth model (possion.kssd2out.pl:22): avgpct9899 > 5 -> linear
    (avg - 3); otherwise the tabulated Poisson expectation of the
    truncated mean.
    """
    out = out or sys.stdout
    data: dict[str, dict[str, float]] = {}
    sums: dict[str, float] = {}
    for ln in lines:
        ln = ln.rstrip("\n")
        if not ln:
            continue
        parts = ln.split("\t")
        sample, ref, shkm, avgpct = parts[0], parts[1], parts[2], parts[4]
        sample = _sanitize(sample)
        if float(shkm) > shkm_thr:
            a = float(avgpct)
            depth = a - AVGPCT9899_OFFSET if a > POISSON_N_THR \
                else POISSON_N[int(a)]
            data.setdefault(sample, {})[ref] = depth
            sums[sample] = sums.get(sample, 0.0) + depth
    for sample in sorted(data):
        # ties broken by ref name (Perl's hash order is process-random,
        # so the reference script itself is non-deterministic on ties)
        refs = sorted(data[sample], key=lambda r: (-data[sample][r], r))
        for ref in refs:
            # %.15g matches Perl's default number stringification
            out.write("%s\t%s\t%.15g\n"
                      % (sample, ref, data[sample][ref] / sums[sample]))
