"""abv_post_output_ms: mean host time per call of
``ops/abv_postings.abv_search_postings`` outside ``postings_search_batch``:
the index's cache lookup, query reads, ranking and formatting the text."""


def read(run):
    got = [c.t1 - c.t0 - c.spans["postings_search_batch"] for c in run.calls
           if "postings_search_batch" in c.spans]
    return 1e3 * sum(got) / len(got) if got else None
