"""abv_batch_ms: mean host time per call of ``ops/dense_abv.abv_search_batch``
(mask, overlap, measure, and the ``.cpu()`` readback that synchronises),
from the runner's span around the module attribute."""


def read(run):
    got = [c.spans["abv_search_batch"] for c in run.calls
           if "abv_search_batch" in c.spans]
    return 1e3 * sum(got) / len(got) if got else None
