"""Time the dense abv gather kernel (``csrc/abv.cu``, ``mkssd_abv_gather``)
on the card at the benchmark's shape: a DB of ROWS x SPECIES float32 (the
abv DB at GTDB r214 width, one card's eighth of an 8-card node, 16.3 GB)
and queries of NNZ nonzero species (the configuration's smallest, mean
and largest sample, and every species).

    python -m metakssd_tpu_torch.probes.bench_abv [--seed N]

The DB: each row holds a log-normal count of species (median 300, sigma
0.7, clipped to 30-3,000, as the configuration assumes) at uniform
random columns, with uniform random values; the kernel's cost follows
the query's columns, not the DB's content.  Queries: QUERIES_PER_NNZ
distinct queries a size, each of sorted uniform random columns, taken in
turns, so that no launch finds the previous launch's sectors in L2.

First a check at the full shape: the kernel against its plain twin
(``abv_gather_plain``) on the card for every mode (CHECK_MODES) and the
three sparse sizes, overlap exact and measure within CHECK_GAP.  Then one
JSON line a (mode, nnz) for L2 and L1 (TIMED_MODES, the benchmark's
cells): the kernel's ms (CUDA events over REPS launches after
two warm-ups, each launch through ``dense_abv.abv_gather`` on a CSR
already on the card), its bound (the 32-byte sectors that the query's
columns touch in every row, plus the outputs, over 3.35 TB/s),
``plain_ms`` None (the twin's times at these shapes are recorded in
PERF.md, section 6, row A1, and no longer taken), ``abv_search_batch``'s ms a
call on the host clock (CSR build and upload, launch, readback) and the
launches counted.  The last line names the card and the check's widest
gap, and beside them, marked as not measured here, the yardstick: the
retired torch-op chain's device time a call, from the benchmark's traced
runs before the kernel (PERF_LEDGER.jsonl).  ``chip_smoke.py`` runs this
module's ``run``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

ROWS = 47_752
SPECIES = 85_205
NNZ = (30, 383, 3000, SPECIES)
QUERIES_PER_NNZ = 8
REPS = 20
CHECK_MODES = (2, 1, 0)
TIMED_MODES = (2, 1)
CHECK_GAP = 1e-6
SECTOR = 32
PEAK_BYTES = 3.35e12
# the device time a call of the torch ops the kernel replaced, over the
# whole matrix (a float32 mask, products and GEMVs in L2; the mask, an
# overlap GEMV and 167 broadcast steps in L1): the benchmark's traced
# runs on an H100 80GB HBM3 at 700 W, one query a call
RETIRED_CHAIN_MS = {"L2": 71.1, "L1": 59.5}
MODE_NAMES = {0: "cosine", 1: "L1", 2: "L2"}


def make_db(seed: int, device):
    """(DenseAbv of ROWS x SPECIES on ``device``, its rows' species
    counts)."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops.dense_abv import DenseAbv
    rng = np.random.default_rng(seed)
    counts = np.clip(np.rint(rng.lognormal(np.log(300), 0.7, ROWS)), 30,
                     3000).astype(np.int64)
    g = torch.Generator(device=device).manual_seed(seed)
    mat = torch.zeros((ROWS, SPECIES), dtype=torch.float32, device=device)
    rows = torch.repeat_interleave(
        torch.arange(ROWS, device=device),
        torch.from_numpy(counts).to(device))
    cols = torch.randint(0, SPECIES, (rows.numel(),), generator=g,
                         device=device)
    mat[rows, cols] = torch.rand(rows.numel(), generator=g,
                                 device=device) + 0.01
    del rows, cols
    y_l2n = torch.linalg.vector_norm(mat, dim=1)
    return DenseAbv([f"s{i}" for i in range(ROWS)], mat, y_l2n), counts


def make_queries(nnz: int, seed: int):
    """QUERIES_PER_NNZ dense [1, SPECIES] float32 queries of ``nnz``
    nonzeros (numpy)."""
    import numpy as np
    rng = np.random.default_rng([seed, nnz])
    out = []
    for _ in range(QUERIES_PER_NNZ):
        q = np.zeros((1, SPECIES), np.float32)
        cols = rng.choice(SPECIES, nnz, replace=False)
        q[0, cols] = rng.random(nnz).astype(np.float32) + np.float32(0.01)
        out.append(q)
    return out


def sectors(q) -> int:
    """32-byte sectors of one DB row that the query's columns touch."""
    import numpy as np
    return int(np.unique(np.flatnonzero(q[0]) // (SECTOR // 4)).size)


def _csr_on(q, device):
    import torch
    from metakssd_tpu_torch.ops.dense_abv import query_csr
    return [torch.from_numpy(a).to(device) for a in query_csr(q)]


def _events_ms(fn, n: int) -> float:
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(n):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def check(dense, seed: int) -> float:
    """The kernel against its twin on the card at the full shape; the
    widest gap (raises past CHECK_GAP or on an overlap that differs)."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import dense_abv
    worst = 0.0
    for nnz in NNZ[:3]:
        csr = _csr_on(make_queries(nnz, seed + 1)[0], dense.mat.device)
        for mode in CHECK_MODES:
            m, o = dense_abv.abv_gather(dense.mat, dense.y_l2n, *csr, mode)
            pm, po = dense_abv.abv_gather_plain(dense.mat, dense.y_l2n,
                                                *csr, mode)
            torch.cuda.synchronize()
            if not torch.equal(o, po):
                raise AssertionError(f"mode {mode}, nnz {nnz}: overlap "
                                     "differs from the twin's")
            m, pm = m[o].double(), pm[o].double()
            gap = float(((m - pm).abs() / pm.abs().clamp(min=1.0)).max()) \
                if m.numel() else 0.0
            if not np.isfinite(gap) or gap > CHECK_GAP:
                raise AssertionError(f"mode {mode}, nnz {nnz}: gap {gap} "
                                     "to the twin")
            worst = max(worst, gap)
            print(f"  check: mode {mode}, nnz {nnz}: {int(o.sum())} rows "
                  f"overlap, gap to the twin {gap:.3g}", flush=True)
    return worst


def time_cases(dense, seed: int) -> list[dict]:
    """One record a (mode, nnz), as the module docstring says."""
    import torch
    from metakssd_tpu_torch.ops import _build, dense_abv
    dev = dense.mat.device
    lines = []
    for nnz in NNZ:
        qs = make_queries(nnz, seed + 2)
        csrs = [_csr_on(q, dev) for q in qs]
        nbytes = (sum(sectors(q) for q in qs) / len(qs) * ROWS * SECTOR
                  + ROWS * 5)
        for mode in TIMED_MODES:
            def kernel(i):
                dense_abv.abv_gather(dense.mat, dense.y_l2n,
                                     *csrs[i % len(csrs)], mode)
            kernel(0)
            kernel(1)
            torch.cuda.synchronize()
            before = _build.LAUNCHES["abv_gather"]
            ms = _events_ms(kernel, REPS)
            launches = _build.LAUNCHES["abv_gather"] - before
            path = []
            for q in qs[:5]:
                t = time.perf_counter()
                dense_abv.abv_search_batch(dense, q, mode=mode)
                path.append(1e3 * (time.perf_counter() - t))
            rec = {"kernel": "mkssd_abv_gather", "mode": MODE_NAMES[mode],
                   "rows": ROWS, "species": SPECIES, "nnz": nnz, "ms": ms,
                   "bound_ms": 1e3 * nbytes / PEAK_BYTES,
                   "bound_bytes": nbytes, "plain_ms": None,
                   "path_ms": sorted(path)[len(path) // 2],
                   "launches": launches}
            rec["ms_over_bound"] = ms / rec["bound_ms"]
            print(json.dumps(rec), flush=True)
            lines.append(rec)
        del csrs
        torch.cuda.empty_cache()
    return lines


def run(seed: int = 0) -> dict:
    """Check, then time, at the benchmark's shape; returns the records."""
    import torch
    dev = torch.device("cuda")
    t = time.time()
    dense, counts = make_db(seed, dev)
    torch.cuda.synchronize()
    print(f"  DB {ROWS} x {SPECIES} float32 on the card "
          f"({dense.mat.numel() * 4 / 1e9:.2f} GB; mean {counts.mean():.1f} "
          f"species a row) in {time.time() - t:.1f} s", flush=True)
    gap = check(dense, seed)
    lines = time_cases(dense, seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[:1]
    tail = {"card": card[0] if card else torch.cuda.get_device_name(0),
            "check_gap": gap}
    print(json.dumps({**tail, "not_measured_here": {
        "retired_chain_ms": RETIRED_CHAIN_MS,
        "from": "PERF_LEDGER.jsonl, the benchmark's traced runs before "
                "the kernel"}}), flush=True)
    del dense
    torch.cuda.empty_cache()
    return {"lines": lines, **tail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_abv: no CUDA device", file=sys.stderr)
        return 1
    run(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
