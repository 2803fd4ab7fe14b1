"""P1: split the compact kernel's cost on the card: the read floor, the
window math, the math plus the table search (exact and signature form),
and the port's full kernels K1 and K2 on the same windows.  The port of
``benchmarks/probe_kernel_cost.py``, at its shapes: L3K11, RWIN 256
(``sketch_pallas.RWIN``'s default), ext 24, 2^24 windows per dispatch.
The exact search goes through K3's index of the accept table
(``ops/probe.exact_index``), built once here, outside the timed runs.

    python -m metakssd_tpu_torch.probes.probe_kernel_cost [--densities]

``--densities`` times only the exact search, through K3's own index of
the table and through the densest (``ops/probe.exact_index``), in turns
(``density_turns``).
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import merge, probe, sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.probes._common import (NWIN, WINDOW_OPS, Variant,
                                               cuda_device, filter_ops,
                                               graph_ms, out_bytes, run_all,
                                               search_ops, vary)
from metakssd_tpu_torch.state import accept_tables

RWIN = 256
SRC = "benchmarks/probe_kernel_cost.py"
PARAMS = SketchParams(k=11, subk=6, drlevel=3)
EXACT = "winmath + exact search"


def _ext(TL: int) -> int:
    """Overlap rows, rounded up to 8 (``sketch_pallas._ext``)."""
    return -(-(TL - 1) // 8) * 8


def variants(device, nwin: int = NWIN, seed: int = 0,
             rwin: int = RWIN) -> list[Variant]:
    dev = torch.device(device)
    shuf = make_shuf(PARAMS, seed=1234)
    p = shuf.params
    TL, ext = p.kmer_len, _ext(p.kmer_len)
    nb = max(1, nwin // (rwin * probe.LANES))
    nwin = nb * rwin * probe.LANES
    codes = np.random.default_rng(seed).integers(
        0, 4, size=nwin + TL - 1).astype(np.uint8)
    c = torch.from_numpy(np.concatenate(
        [codes, np.full(rwin + ext, 255, np.uint8)])).to(dev)
    tiles = probe.tiles_from_codes(c, rwin, ext, nb)
    c = c[:nwin + TL - 1].contiguous()
    a_tups = shuf.device_tables()[0]
    tabs = accept_tables(shuf, dev)
    lev = torch.from_numpy(probe.bfs_levels(a_tups).view(np.int32)).to(dev)
    sig = torch.from_numpy(np.ascontiguousarray(
        probe.sig_tables(a_tups)).view(np.int32)).to(dev)
    ix = probe.exact_index(tabs.accept)
    n = a_tups.size
    steps = (n - 1).bit_length()
    rows = rwin + ext
    win_bytes = nb * (rwin + TL - 1) * probe.LANES * 4 + out_bytes(nb)
    k = (p.k, p.subk, p.drlevel)
    cap = sketch_cuda.default_capacity(nwin, tabs)
    survivors = nwin * n // p.shuf_len
    # K1/K2: the scan per window, the exact search per kept window
    k12_bytes = c.numel() + 8 * n + 4 * tabs.filter.numel()
    k12_ops = filter_ops(nwin, survivors, steps)
    return [
        Variant("floor (read+sum)", f"{SRC}:71", "probe_floor", tiles,
                lambda t: probe.floor(t, 0, rows),
                lambda t: probe.floor_plain(t, 0, rows),
                tiles.numel() * 4 + out_bytes(nb), tiles.numel(), nwin,
                lambda t: t[:, :rows].sum(dim=1, keepdim=True,
                                          dtype=torch.int32)),
        Variant("window math only", f"{SRC}:90", "probe_winmath", tiles,
                lambda t: probe.winmath(t, rwin, TL),
                lambda t: probe.winmath_plain(t, rwin, TL),
                win_bytes, nwin * WINDOW_OPS, nwin),
        # the function's least work: the window math and one table step
        # a window (the index takes a window to a bucket of about 2 keys)
        Variant(EXACT, f"{SRC}:136", "probe_search", tiles,
                lambda t: probe.search(t, rwin, *k, accept=tabs.accept,
                                       index=ix),
                lambda t: probe.search_plain(t, rwin, *k,
                                             accept=tabs.accept),
                win_bytes + 4 * (n + ix.table.numel()),
                nwin * search_ops(1), nwin,
                tables={"accept": tabs.accept, "index": ix}),
        Variant("winmath + sig-probe search", f"{SRC}:136", "probe_search",
                tiles,
                lambda t: probe.search(t, rwin, *k, lev=lev, sig=sig),
                lambda t: probe.search_plain(t, rwin, *k, lev=lev, sig=sig),
                win_bytes + 4 * (7 * probe.LANES + sig.numel()),
                nwin * search_ops(7, 5 * sig.shape[0]), nwin,
                tables={"lev": lev, "sig": sig}),
        # the port's full kernels on the same windows: compared with their
        # plain versions by chip_smoke.py's kernels phase, not here
        Variant("full kernel K1 (compact)", "metakssd_tpu/ops/"
                "sketch_pallas.py:323", "sketch_compact", c,
                lambda x: sketch_cuda.window_compact(x, tabs, p, cap)[2],
                None, k12_bytes + 4 * survivors + 8, k12_ops, nwin),
        Variant("full kernel K2 (all windows)", "metakssd_tpu/ops/"
                "sketch_pallas.py:298", "sketch_full", c,
                lambda x: sketch_cuda.window_full(x, tabs, p)[1],
                None, k12_bytes + 8 * nwin, k12_ops, nwin),
    ]


def index_stats(ix) -> dict:
    """nb, shift and the largest bucket (in keys) of an index."""
    t = ix.table.cpu().to(torch.int64) & 0xFFFFFFFF
    return {"nb": ix.nb, "shift": ix.shift,
            "largest_bucket": int(t.diff().max()) if ix.nb else None}


def density_turns(v: Variant, replays: int = 5) -> list[dict]:
    """The exact search variant ``v`` (its tiles and accept table) timed
    through K3's own index of the table ("k3") and through the densest
    ("densest", the probe's) in turns, ``replays`` rounds of one
    CUDA-graph timing each (16 XOR-varied dispatches, 5 replays); each
    result must equal the plain version.  One record per density: its
    index's ``index_stats``, the median and range of its timings."""
    accept = v.tables["accept"]
    inputs = vary(v.tiles)
    want = v.plain(v.tiles)
    runs = {}
    for density, ix in (("k3", merge.build_index(accept)),
                        ("densest", probe.exact_index(accept))):
        fn = (lambda ix: lambda t: probe.search(
            t, RWIN, PARAMS.k, PARAMS.subk, PARAMS.drlevel, accept=accept,
            index=ix))(ix)
        if not torch.equal(fn(v.tiles), want):
            raise AssertionError(f"exact search at {density}: kernel != "
                                 "plain")
        runs[density] = (ix, fn, [])
    for _ in range(replays):
        for ix, fn, ms in runs.values():
            ms.append(graph_ms(fn, inputs, 5))
    del inputs
    return [{"density": d, **index_stats(ix), "ms": statistics.median(ms),
             "ms_range": [min(ms), max(ms)]}
            for d, (ix, _, ms) in runs.items()]


def run(reps: int = 3) -> list[dict]:
    """Time every variant on the card; one record each."""
    return run_all(f"P1 probe_kernel_cost RWIN={RWIN}",
                   variants(cuda_device()), reps=reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--densities", action="store_true",
                    help="time only the exact search, at each index "
                         "density in turns")
    args = ap.parse_args(argv)
    if not args.densities:
        run()
        return 0
    (v,) = [v for v in variants(cuda_device()) if v.name == EXACT]
    print(f"P1 exact search by index density "
          f"({torch.cuda.get_device_name(0)})", flush=True)
    for rec in density_turns(v):
        print(f"  {rec['density']:8s} nb {rec['nb']:5d} shift "
              f"{rec['shift']:2d} largest bucket {rec['largest_bucket']:3d}"
              f"  {rec['ms']:.4f} ms ({rec['ms_range'][0]:.4f}-"
              f"{rec['ms_range'][1]:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
