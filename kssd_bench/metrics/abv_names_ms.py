"""abv_names_ms: the summed host time per call of the program's
``abv.names`` spans (``ops/dense_abv``: the per-call encoding of the
DB's sample names into the blob and offsets that the text formatter
reads), read from the traced window (``torch.profiler``'s host clock).
None where the program has no such span."""


def read(run):
    got = run.trace.spans.get("abv.names") if run.trace is not None else None
    if not got:
        return None
    return 1e-3 * sum(b - a for a, b in got) / len(run.calls)
