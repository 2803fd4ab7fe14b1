"""P3: the floor and the window math over blocks of 512, 1024 and 2048
rows (the TPU walked the larger blocks in 512-row chunks): does a larger
block amortise a per-block overhead?  The port of
``benchmarks/probe_floor_chunk.py``, at its shapes: EXT 32, TL 22, 2^24
windows per dispatch.  On the card the rows of a block are spread over
blocks of 128 rows each, so the chunking has no counterpart; the sums
are the same.

    python -m metakssd_tpu_torch.probes.probe_floor_chunk
"""

from __future__ import annotations

import numpy as np
import torch

from metakssd_tpu_torch.ops import probe
from metakssd_tpu_torch.probes._common import (NWIN, WINDOW_OPS, Variant,
                                               cuda_device, out_bytes,
                                               run_all)

EXT = 32
TLK = 22
ROWS = (512, 1024, 2048)
SRC = "benchmarks/probe_floor_chunk.py"


def variants(device, nwin: int = NWIN, seed: int = 0,
             rows_list=ROWS) -> list[Variant]:
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    out = []
    for rows in rows_list:
        nb = max(1, nwin // (rows * probe.LANES))
        nw = nb * rows * probe.LANES
        t = torch.from_numpy(rng.integers(
            0, 4, size=(nb, rows + EXT, probe.LANES), dtype=np.int32)).to(dev)
        out.append(Variant(
            f"floor rows={rows} nb={nb}", f"{SRC}:32", "probe_floor", t,
            lambda x, rows=rows: probe.floor(x, 0, rows),
            lambda x, rows=rows: probe.floor_plain(x, 0, rows),
            nb * rows * probe.LANES * 4 + out_bytes(nb), nw, nw,
            lambda x, rows=rows: x[:, :rows].sum(dim=1, keepdim=True,
                                                 dtype=torch.int32)))
        out.append(Variant(
            f"winmath rows={rows} nb={nb}", f"{SRC}:57", "probe_winmath", t,
            lambda x, rows=rows: probe.winmath(x, rows, TLK),
            lambda x, rows=rows: probe.winmath_plain(x, rows, TLK),
            nb * (rows + TLK - 1) * probe.LANES * 4 + out_bytes(nb),
            nw * WINDOW_OPS, nw))
    return out


def run(reps: int = 3) -> list[dict]:
    """Time every variant on the card; one record each."""
    return run_all(f"P3 probe_floor_chunk EXT={EXT}",
                   variants(cuda_device()), reps=reps)


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
