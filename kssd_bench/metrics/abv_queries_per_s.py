"""abv_queries_per_s: the queries of every call of the window over the
time from the first call's start to the last call's end (host clock)."""


def read(run):
    span = run.calls[-1].t1 - run.calls[0].t0
    return sum(c.queries for c in run.calls) / span if span > 0 else None
