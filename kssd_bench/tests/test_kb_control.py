"""The control (``reference/control.py``: the search with its inputs
rounded to the precision below the configuration's) fails each cell's
committed limits, while the program on the same seeds passes them, at a
tiny size on the CPU.  On the card it is run at the cells' own sizes by
``calibrate.py``."""

import json

import pytest

from kb_tiny import tiny_root
from kssd_bench import calibrate


@pytest.mark.parametrize("workload", ["abv.l2.single", "abv.l1.single"])
def test_control_fails_the_limits(tmp_path, workload):
    root = tiny_root(tmp_path)
    limits = json.loads((root / "kssd_bench" / "limits" / f"{workload}.json")
                        .read_text())
    rows = calibrate.calibrate(workload, [3, 2**31 + 3], [3, 2**31 + 3], 0.3,
                               root=root, device="cpu")
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
        assert row["control_failed"] > 0
