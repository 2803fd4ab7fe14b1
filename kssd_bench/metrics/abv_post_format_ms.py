"""abv_post_format_ms: the summed host time per call of the program's
``abv.post.format`` spans (``ops/abv_postings``: each query's text: its
header, ``io/native.write_name_float_lines``, ``decode`` and the write),
read from the traced window (``torch.profiler``'s host clock). None where
the program has no such span."""


def read(run):
    got = (run.trace.spans.get("abv.post.format")
           if run.trace is not None else None)
    if not got:
        return None
    return 1e-3 * sum(b - a for a, b in got) / len(run.calls)
