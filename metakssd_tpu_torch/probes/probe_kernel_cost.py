"""P1: split the compact kernel's cost on the card: the read floor, the
window math, the math plus the table search (exact and signature form),
and the port's full kernels K1 and K2 on the same windows.  The port of
``benchmarks/probe_kernel_cost.py``, at its shapes: L3K11, RWIN 256
(``sketch_pallas.RWIN``'s default), ext 24, 2^24 windows per dispatch.

    python -m metakssd_tpu_torch.probes.probe_kernel_cost
"""

from __future__ import annotations

import numpy as np
import torch

from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import probe, sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.probes._common import (NWIN, WINDOW_OPS, Variant,
                                               cuda_device, out_bytes,
                                               run_all, search_ops)
from metakssd_tpu_torch.state import accept_tables

RWIN = 256
SRC = "benchmarks/probe_kernel_cost.py"


def _ext(TL: int) -> int:
    """Overlap rows, rounded up to 8 (``sketch_pallas._ext``)."""
    return -(-(TL - 1) // 8) * 8


def variants(device, nwin: int = NWIN, seed: int = 0,
             rwin: int = RWIN) -> list[Variant]:
    dev = torch.device(device)
    shuf = make_shuf(SketchParams(k=11, subk=6, drlevel=3), seed=1234)
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
    n = a_tups.size
    steps = (n - 1).bit_length()
    rows = rwin + ext
    win_bytes = nb * (rwin + TL - 1) * probe.LANES * 4 + out_bytes(nb)
    k = (p.k, p.subk, p.drlevel)
    cap = sketch_cuda.default_capacity(nwin, tabs)
    survivors = nwin * n // p.shuf_len
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
        Variant("winmath + exact search", f"{SRC}:136", "probe_search",
                tiles,
                lambda t: probe.search(t, rwin, *k, accept=tabs.accept),
                lambda t: probe.search_plain(t, rwin, *k,
                                             accept=tabs.accept),
                win_bytes + 4 * n, nwin * search_ops(steps), nwin,
                tables={"accept": tabs.accept}),
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
                None, c.numel() + 8 * n + 4 * survivors + 8,
                nwin * search_ops(steps), nwin),
        Variant("full kernel K2 (all windows)", "metakssd_tpu/ops/"
                "sketch_pallas.py:298", "sketch_full", c,
                lambda x: sketch_cuda.window_full(x, tabs, p)[1],
                None, c.numel() + 8 * n + 8 * nwin,
                nwin * search_ops(steps), nwin),
    ]


def run(reps: int = 3) -> list[dict]:
    """Time every variant on the card; one record each."""
    return run_all(f"P1 probe_kernel_cost RWIN={RWIN}",
                   variants(cuda_device()), reps=reps)


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
