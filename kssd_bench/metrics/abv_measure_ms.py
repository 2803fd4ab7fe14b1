"""abv_measure_ms: the device time per call of the kernels launched inside
the program's ``abv.measure`` span (``ops/dense_abv``: L2's masked
products and ``sqrt``, L1's chunked chain, the cosine), from the traced
window (``torch.profiler``).  In L2 it includes the DB mask that
``_dense_l2_overlap`` builds, which ``abv_mask_ms`` counts too.  None
where the program has no such span or no kernel ran in one (the CPU)."""

from kssd_bench import tracing


def read(run):
    if run.trace is None:
        return None
    kernel_s = tracing.kernel_seconds_in(run.trace, "abv.measure")
    return 1e3 * kernel_s / len(run.calls) if kernel_s > 0 else None
