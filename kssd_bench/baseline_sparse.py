"""The same-host baseline of an abv cell: the port's sparse host route
(``composite.abv_search``, ``composite -s <mode>`` without ``--dense``) on
the cell's own data, one call of ``--queries`` queries after one warm-up
query.  It prints one JSON line with its queries/s; it is no metric of
the benchmark.

    python3 kssd_bench/baseline_sparse.py --workload <name> --seed <n> \\
        [--queries 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kssd_bench import abv_corpus  # noqa: E402
from kssd_bench.run import load_cell  # noqa: E402


class _Count:
    def __init__(self):
        self.chars = 0

    def write(self, s: str) -> int:
        self.chars += len(s)
        return len(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, default=32)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    from metakssd_tpu_torch import composite
    from metakssd_tpu_torch.io import native
    with tempfile.TemporaryDirectory(prefix="kssd_bench_sparse_") as work:
        corpus = abv_corpus.make(cell.cfg, args.queries + 1, args.seed,
                                 "cuda")
        refdir = os.path.join(work, "db")
        os.makedirs(refdir)
        abv_corpus.write_index(refdir, corpus.db, corpus.names,
                               corpus.n_species, "cuda")
        qpaths = abv_corpus.write_queries(os.path.join(work, "q"),
                                          corpus.queries)
        mode = int(cell.traffic["mode"])
        composite.abv_search(refdir, qpaths[:1], mode, out=_Count())
        sink = _Count()
        t0 = time.perf_counter()
        composite.abv_search(refdir, qpaths[1:], mode, out=sink)
        dt = time.perf_counter() - t0
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "route": "composite.abv_search (sparse, host)",
                      "native": native.build_kind(),
                      "queries": args.queries, "seconds": dt,
                      "queries_per_s": args.queries / dt,
                      "chars": sink.chars}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
