"""abv_mask_ms: the device time per call of the kernels launched inside
the program's ``abv.mask`` spans (``ops/dense_abv``: the DB's float32
mask ``(db != 0).to(float32)``, two a call in L2, one in L1 and cosine),
from the traced window (``torch.profiler``).  None where the program has
no such span or no kernel ran in one (the CPU)."""

from kssd_bench import tracing


def read(run):
    if run.trace is None:
        return None
    kernel_s = tracing.kernel_seconds_in(run.trace, "abv.mask")
    return 1e3 * kernel_s / len(run.calls) if kernel_s > 0 else None
