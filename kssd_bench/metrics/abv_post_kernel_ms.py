"""abv_post_kernel_ms: the device time per call of the kernels launched
inside the program's ``abv.post.walk`` spans (``ops/abv_postings``: the
postings walk ``mkssd_abv_post_walk``), from the traced window
(``torch.profiler``).  None where the program has no such span or no
kernel ran in one (the CPU)."""

from kssd_bench import tracing


def read(run):
    if run.trace is None:
        return None
    kernel_s = tracing.kernel_seconds_in(run.trace, "abv.post.walk")
    return 1e3 * kernel_s / len(run.calls) if kernel_s > 0 else None
