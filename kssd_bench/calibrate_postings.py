"""``calibrate.py`` for a cell of the postings runner
(``runners/abv_postings.py``), whose control is
``reference/abv_post_control.py``.

    python3 kssd_bench/calibrate_postings.py --workload abv.whole.l2.single \\
        --seeds 1,2,3 [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

It runs ``calibrate.calibrate`` as it is, with the postings control in
the place of the dense one; the readings and their JSON lines are
``calibrate.py``'s.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kssd_bench import calibrate  # noqa: E402
from kssd_bench.reference import abv_post_control  # noqa: E402

calibrate.control = abv_post_control

if __name__ == "__main__":
    sys.exit(calibrate.main())
