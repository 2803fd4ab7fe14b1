"""abv_rank_ms: the summed host time per call of the program's ``abv.rank``
spans (``ops/dense_abv``: ranking each query's overlapping samples:
``np.nonzero``, the gather, the stable argsort), read from the traced
window (``torch.profiler``'s host clock). None where the program has no
such span."""


def read(run):
    got = run.trace.spans.get("abv.rank") if run.trace is not None else None
    if not got:
        return None
    return 1e-3 * sum(b - a for a, b in got) / len(run.calls)
