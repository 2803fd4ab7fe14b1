"""abv_output_ms: mean host time per call of ``ops/dense_abv.abv_search_dense``
outside ``abv_search_batch``: query reads, the names blob, ranking and
formatting the text (``io/native.format_name_float_lines``)."""


def read(run):
    got = [c.t1 - c.t0 - c.spans["abv_search_batch"] for c in run.calls
           if "abv_search_batch" in c.spans]
    return 1e3 * sum(got) / len(got) if got else None
