"""P4: what the floor costs without its reads: a kernel that writes each
block's index and reads nothing, one that sums 8 rows, one that sums all
RWIN rows and one that XORs them.  The port of
``benchmarks/probe_floor_noread.py``, at its shapes: RWIN 512, EXT 32,
2^24 windows per dispatch.

    python -m metakssd_tpu_torch.probes.probe_floor_noread
"""

from __future__ import annotations

import numpy as np
import torch

from metakssd_tpu_torch.ops import probe
from metakssd_tpu_torch.probes._common import (NWIN, Variant, cuda_device,
                                               out_bytes, run_all)

RWIN = 512
EXT = 32
SRC = "benchmarks/probe_floor_noread.py"


def variants(device, nwin: int = NWIN, seed: int = 0,
             rwin: int = RWIN) -> list[Variant]:
    dev = torch.device(device)
    nb = max(1, nwin // (rwin * probe.LANES))
    nwin = nb * rwin * probe.LANES
    t = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, size=(nb, rwin + EXT, probe.LANES), dtype=np.int32)).to(dev)

    def lib_sum(rows):
        return lambda x: x[:, :rows].sum(dim=1, keepdim=True,
                                         dtype=torch.int32)

    out = []
    for name, line, rows, op in (("noread", 55, 0, "none"),
                                 ("touch8", 59, 8, "sum"),
                                 ("sumall", 63, rwin, "sum"),
                                 ("xorfold", 67, rwin, "xor")):
        read = nb * rows * probe.LANES
        out.append(Variant(
            name, f"{SRC}:{line}", "probe_floor", t,
            lambda x, rows=rows, op=op: probe.floor(x, 0, max(rows, 1), op),
            lambda x, rows=rows, op=op: probe.floor_plain(
                x, 0, max(rows, 1), op),
            4 * read + out_bytes(nb), read, nwin,
            lib_sum(rows) if op == "sum" else None))
    return out


def run(reps: int = 3) -> list[dict]:
    """Time every variant on the card; one record each."""
    return run_all(f"P4 probe_floor_noread RWIN={RWIN} EXT={EXT}",
                   variants(cuda_device()), reps=reps)


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
