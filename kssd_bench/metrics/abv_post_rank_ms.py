"""abv_post_rank_ms: the summed host time per call of the program's
``abv.post.rank`` spans (``ops/abv_postings``: ranking each query's
touched samples: ``np.flatnonzero``, the sort keys, the argsort and the
mode's final step), read from the traced window (``torch.profiler``'s
host clock). None where the program has no such span."""


def read(run):
    got = (run.trace.spans.get("abv.post.rank")
           if run.trace is not None else None)
    if not got:
        return None
    return 1e-3 * sum(b - a for a, b in got) / len(run.calls)
