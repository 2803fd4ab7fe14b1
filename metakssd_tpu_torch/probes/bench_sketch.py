"""Time the sketch kernels K1 and K2 per 64M-window batch on the card,
over configs and filter bitmap sizes, and on a stream of filter false
positives.  Run as a script, so that ``--root`` can point at another
checkout of this package (to time two commits in one call, in turns):

    python metakssd_tpu_torch/probes/bench_sketch.py [--root DIR] [--sizes]

``--sizes`` adds bitmaps of 2^16..2^19 bits to the default one (only a
checkout whose kernels have a filter: ``state.make_accept_tables``).  One JSON line
per (config, bitmap): ms of K1 without and with positions and of K2, CUDA
events over 10 launches after two warm-ups.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

NWIN = 64 << 20
CONFIGS = [(11, 6, 3), (8, 5, 2), (7, 5, 3), (6, 4, 2)]


def _ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--sizes", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from metakssd_tpu_torch.formats.shuf import make_shuf
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.params import SketchParams
    from metakssd_tpu_torch import state
    from metakssd_tpu_torch.state import accept_tables

    sized = hasattr(state, "make_accept_tables")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, size=NWIN + 31, dtype=np.uint8)
    base[rng.integers(0, base.size, base.size // 1000)] = 4

    def time_all(label, c, tabs, p):
        cap = sketch_cuda.default_capacity(NWIN, tabs)
        print(json.dumps({
            "root": args.root, "case": label,
            "log2": getattr(tabs, "filter_log2", None),
            "k1": _ms(lambda: sketch_cuda.window_compact(c, tabs, p, cap)),
            "k1_pos": _ms(lambda: sketch_cuda.window_compact(
                c, tabs, p, cap, True)),
            "k2": _ms(lambda: sketch_cuda.window_full(c, tabs, p))}),
            flush=True)

    for cfg in CONFIGS:
        p = SketchParams(*cfg)
        shuf = make_shuf(p, seed=1)
        c = torch.from_numpy(base[:NWIN + p.kmer_len - 1]).to(dev)
        sizes = [None] + ([s for s in range(16, 20) if s <= 4 * p.subk]
                          if args.sizes and sized else [])
        for log2 in sizes:
            tabs = accept_tables(shuf, dev) if log2 is None else \
                state.make_accept_tables(*shuf.device_tables()[:2], p.subk,
                                         dev, log2)
            time_all(str(cfg), c, tabs, p)
        del c
    if sized:
        from metakssd_tpu_torch.ops import sketch_filter
        p = SketchParams(11, 6, 3)
        tabs = accept_tables(make_shuf(p, seed=1), dev)
        dims = sketch_filter.false_positive_dims(
            tabs.accept, tabs.filter, tabs.filter_log2, p.subk, 1 << 23, 2)
        codes, _ = sketch_filter.codes_with_dims(dims[:100_000], p, 3)
        c = torch.from_numpy(np.tile(codes, NWIN // codes.size + 1)
                             [:NWIN + p.kmer_len - 1]).to(dev)
        share = sketch_cuda.filter_candidates(
            c[:1 << 22], tabs, p)[0].numel() / ((1 << 22) - p.kmer_len + 1)
        time_all(f"false positives ({share:.4f} of windows are candidates)",
                 c, tabs, p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
