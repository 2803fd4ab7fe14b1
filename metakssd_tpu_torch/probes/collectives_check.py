"""Round trip of the collectives (``parallel/mesh.gather_arrays`` and
``all_sum``) in a joined job, and the reader of a rank's TIMER report.

Run once per rank with the launch variables set, for example one rank on
its card (an NCCL group of one):

    MKSSD_COORDINATOR=127.0.0.1:<port> MKSSD_NPROCS=1 MKSSD_PROCID=0 \\
        python -m metakssd_tpu_torch.probes.collectives_check \\
        --device cuda --sizes 0,1,16777219

Rank r's array of each dtype (uint8, int32, uint32, int64, uint64) and
size n holds n + 5r random elements drawn from (r, dtype, n), so every
rank knows every rank's and the sizes differ across ranks.  Each array
goes through ``gather_arrays`` as numpy and as a tensor on ``--device``,
and its first n elements through ``all_sum``; every result must equal
what numpy computes (the gather: every rank's array in rank order; the
sum: int64 with wraparound) and the two forms must agree.  A tensor's
results must lie on its own device.  The counts of ``mesh.COLLECTIVES`` must show both
backends where they ran.  Prints ``collectives ok rank R {counts}`` and
exits 0, or exits 1 with the failure.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from metakssd_tpu_torch.parallel import mesh

DTYPES = (np.uint8, np.int32, np.uint32, np.int64, np.uint64)


def rank_array(rank: int, dtype, n: int) -> np.ndarray:
    """Rank ``rank``'s array of ``dtype`` for size ``n``."""
    rng = np.random.default_rng([rank, DTYPES.index(dtype), n])
    raw = rng.integers(0, 256, (n + 5 * rank) * np.dtype(dtype).itemsize,
                       dtype=np.uint8)
    return raw.view(dtype)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run(device: str, sizes: list[int]) -> dict:
    """The checks of the module docstring on this rank; returns the
    counts of the collectives they made."""
    nproc, rank = mesh.world()
    backend = mesh.collectives_backend()
    _check(backend is not None, "no group was joined")
    nccl = backend.startswith("nccl")
    dev = torch.device(device)
    mesh.reset_collectives()
    for dtype in DTYPES:
        for n in sizes:
            what = f"{np.dtype(dtype).name} x {n}"
            every = [rank_array(r, dtype, n) for r in range(nproc)]
            mine = every[rank]
            got_np = mesh.gather_arrays(mine)
            t = torch.from_numpy(mine.copy()).to(dev)
            got_t = mesh.gather_arrays(t)
            _check(len(got_np) == len(got_t) == nproc, f"{what}: ranks")
            for r, (a, b) in enumerate(zip(got_np, got_t)):
                _check(a.dtype == dtype and np.array_equal(a, every[r]),
                       f"{what}: numpy gather, rank {r}'s part")
                _check(b.device == t.device, f"{what}: tensor on {b.device}")
                _check(np.array_equal(b.cpu().numpy(), every[r]),
                       f"{what}: tensor gather, rank {r}'s part")
            head = [x[:n] for x in every]
            want = np.zeros(n, np.int64)
            for x in head:
                want += x.astype(np.int64)
            s_np = mesh.all_sum(head[rank])
            t = torch.from_numpy(head[rank].copy()).to(dev)
            s_t = mesh.all_sum(t)
            _check(s_np.dtype == np.int64 and np.array_equal(s_np, want),
                   f"{what}: numpy sum")
            _check(s_t.dtype == torch.int64 and s_t.device == t.device
                   and np.array_equal(s_t.cpu().numpy(), want),
                   f"{what}: tensor sum")
    counts = dict(mesh.COLLECTIVES)
    _check(counts["gloo_calls"] > 0, f"no gloo call: {counts}")
    _check((counts["nccl_calls"] > 0) == (nccl and dev.type == "cuda"),
           f"NCCL calls do not match the backend {backend}: {counts}")
    return counts


def read_report(log_path: str) -> dict:
    """The last TIMER report (``MKSSD_LOG=json``: one JSON line on
    stderr with "stages") in a rank's log; {} where there is none."""
    rep = {}
    with open(log_path, errors="replace") as f:
        for line in f:
            if line.startswith("{") and '"stages"' in line:
                try:
                    rep = json.loads(line)
                except json.JSONDecodeError:
                    pass
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="0,1,1000",
                    help="comma-separated element counts")
    args = ap.parse_args(argv)
    ok = False
    try:
        if not mesh.init_distributed(device=args.device):
            print("collectives_check: MKSSD_COORDINATOR is not set",
                  file=sys.stderr)
            return 1
        counts = run(args.device, [int(x) for x in args.sizes.split(",")])
        print(f"collectives ok rank {mesh.world()[1]} "
              f"{mesh.collectives_backend()} {json.dumps(counts)}",
              flush=True)
        ok = True
    except (AssertionError, RuntimeError) as e:
        print(f"collectives_check: {e}", file=sys.stderr)
    finally:
        mesh.leave_distributed(ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
