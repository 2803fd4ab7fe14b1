"""The readings that a cell's correctness limits are set from.

    python3 kssd_bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

For each seed, in one process: the cell's set-up, a window of
``--seconds`` of the program, then (for the control seeds) a window of the
control (``reference/control.py``, the precision named by the cell's
limits file) at the same size and load, each compared with the plain
reference as a run compares.  One JSON line a seed gives every number
compared: the program's are the lower readings, the control's the upper.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kssd_bench import run as harness  # noqa: E402
from kssd_bench.reference import control  # noqa: E402


def readings(checks) -> dict:
    return {c.name: float(c.value) for c in checks}


def calibrate(workload: str, seeds: list[int], control_seeds: list[int],
              seconds: float, *, root: Path | None = None,
              device: str = "cuda", out=None) -> list[dict]:
    cell = harness.load_cell(Path(root or harness.ROOT), workload)
    runner, limits = cell.runner, cell.limits
    cuda = device.startswith("cuda")
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="kssd_bench_cal_") as work:
            s = runner.Session(cell.cfg, cell.traffic, seed, device, work)
            try:
                t1 = time.perf_counter()
                calls, _ = harness._window(s, seconds, False, cuda)
                prog = s.records
                ctrl = None
                if seed in control_seeds:
                    s.records = s.new_records()
                    undo = control.install(s, limits["control"])
                    harness._window(s, seconds, False, cuda)
                    ctrl, s.records = s.records, prog
                    undo()
                checksums = s.db_checksums()
                s.close()
                row = {"workload": workload, "seed": seed,
                       "setup_s": t1 - t0, "calls": len(calls),
                       "queries_per_s": sum(c.queries for c in calls)
                       / (calls[-1].t1 - calls[0].t0)}
                checks, failed = s.compare(limits, checksums, prog)
                row["program"] = readings(checks)
                row["program_failed"] = failed
                if ctrl is not None:
                    checks, failed = s.compare(limits, checksums, ctrl)
                    row["control"] = readings(checks)
                    row["control_failed"] = failed
            finally:
                s.close()
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    seeds = [int(x) for x in args.seeds.split(",") if x]
    cseeds = [int(x) for x in args.control_seeds.split(",") if x]
    calibrate(args.workload, seeds, cseeds, args.seconds, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
