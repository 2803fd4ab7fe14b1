"""abv_post_roofline: the least time the chip could take for the window's
calls (``roofline.least_seconds`` of ``roofline.abv_work``, counted from
the corpus: the query species' postings, its nonzeros, the samples it
overlaps) over the summed device time of the kernels launched inside
``postings_search_batch`` (``torch.profiler``), in %."""

from kssd_bench import roofline, tracing


def read(run):
    if run.trace is None:
        return None
    kernel_s = tracing.kernel_seconds_in(run.trace,
                                         "kssd_bench.postings_search_batch")
    if kernel_s <= 0:
        return None
    least = sum(roofline.least_seconds(*run.session.work(i))
                for i in range(len(run.calls)))
    return 100.0 * least / kernel_s
