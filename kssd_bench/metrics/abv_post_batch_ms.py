"""abv_post_batch_ms: mean host time per call of
``ops/abv_postings.postings_search_batch`` (the queries' CSR, its upload,
the postings walk and the readback that synchronises), from the runner's
span around the module attribute."""


def read(run):
    got = [c.spans["postings_search_batch"] for c in run.calls
           if "postings_search_batch" in c.spans]
    return 1e3 * sum(got) / len(got) if got else None
