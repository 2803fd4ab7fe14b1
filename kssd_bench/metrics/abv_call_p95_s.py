"""abv_call_p95_s: the 95th percentile of the latency of every call of
the window (host clock; numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile([c.t1 - c.t0 for c in run.calls], 95))
