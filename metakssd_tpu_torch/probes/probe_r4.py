"""P2: the floor over int32, int8 and uint16 tiles; the window math over
int32 and int8 tiles; and 30 chained, dependent lookups in a 32x128 table
(u32 and u16) or in its first row.  The port of
``benchmarks/probe_r4.py``, at its shapes: RWIN 256
(``sketch_pallas.RWIN``'s default), EXT 32, TL 22, 2^24 windows per
dispatch.  The TPU never timed the int8 window math (its compiler refused
int8 compares); the card runs it.

    python -m metakssd_tpu_torch.probes.probe_r4
"""

from __future__ import annotations

import numpy as np
import torch

from metakssd_tpu_torch.ops import probe
from metakssd_tpu_torch.probes._common import (NWIN, WINDOW_OPS, Variant,
                                               cuda_device, out_bytes,
                                               run_all)

RWIN = 256
EXT = 32
TLK = 22
NG = 30
SRC = "benchmarks/probe_r4.py"


def variants(device, nwin: int = NWIN, seed: int = 0,
             rwin: int = RWIN) -> list[Variant]:
    dev = torch.device(device)
    nb = max(1, nwin // (rwin * probe.LANES))
    nwin = nb * rwin * probe.LANES
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=(nb, rwin + EXT, probe.LANES),
                        dtype=np.int32)
    tab32 = np.sort(rng.integers(0, 1 << 24, (32, probe.LANES),
                                 dtype=np.uint32))
    tab16 = np.sort(rng.integers(0, 1 << 16, (32, probe.LANES))
                    .astype(np.uint16))
    t32 = torch.from_numpy(base).to(dev)
    tiles = {torch.int32: t32, torch.int8: t32.to(torch.int8),
             torch.uint16: torch.from_numpy(base.astype(np.uint16)).to(dev)}
    tabs = {"u32": torch.from_numpy(tab32.view(np.int32)).to(dev),
            "u16": torch.from_numpy(tab16).to(dev)}
    rows = rwin + EXT
    out = []
    for dt, label in ((torch.int32, "i32"), (torch.int8, "i8"),
                      (torch.uint16, "u16")):
        t = tiles[dt]
        out.append(Variant(
            f"floor {label}", f"{SRC}:73", "probe_floor", t,
            lambda x: probe.floor(x, 0, rows),
            lambda x: probe.floor_plain(x, 0, rows),
            t.numel() * t.element_size() + out_bytes(nb), t.numel(), nwin,
            lambda x: x[:, :rows].sum(dim=1, keepdim=True,
                                      dtype=torch.int32)))
    for dt, label in ((torch.int32, "i32"), (torch.int8, "i8")):
        t = tiles[dt]
        out.append(Variant(
            f"winmath {label}", f"{SRC}:149", "probe_winmath", t,
            lambda x: probe.winmath(x, rwin, TLK),
            lambda x: probe.winmath_plain(x, rwin, TLK),
            nb * (rwin + TLK - 1) * probe.LANES * t.element_size()
            + out_bytes(nb), nwin * WINDOW_OPS, nwin))
    for size, mult, tab, label, line in (
            (4096, 683, "u32", f"{NG}x 32-row gather u32", 90),
            (4096, 683, "u16", f"{NG}x 32-row gather u16", 90),
            (128, 37, "u32", f"{NG}x 1-row gather u32", 123)):
        tb = tabs[tab]
        out.append(Variant(
            label, f"{SRC}:{line}", "probe_gather", t32,
            lambda x, tb=tb, size=size, mult=mult: probe.gather(
                x, rwin, tb, size, mult, NG),
            lambda x, tb=tb, size=size, mult=mult: probe.gather_plain(
                x, rwin, tb, size, mult, NG),
            nb * rwin * probe.LANES * 4 + size * tb.element_size()
            + out_bytes(nb), nwin * (3 + 4 * NG), nwin,
            tables={"table": tb}))
    return out


def run(reps: int = 3) -> list[dict]:
    """Time every variant on the card; one record each."""
    return run_all(f"P2 probe_r4 RWIN={RWIN} EXT={EXT}",
                   variants(cuda_device()), reps=reps)


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
