"""abv_roofline's count, worked by hand."""

import numpy as np
import pytest

from kssd_bench import abv_corpus, roofline


def test_abv_work_by_hand():
    # a query of 3 species whose posting lists hold 5, 0 and 2 samples,
    # 4 of them distinct: 7 postings, 3 nonzeros, 4 pairs
    ops, nbytes = roofline.abv_work(7, 3, 4, mode=2)
    assert ops == 3 * 7                       # subtract, square, add
    assert nbytes == 8 * 7 + 8 * 3 + 4 * 4    # 96 bytes
    assert roofline.abv_work(7, 3, 4, mode=0)[0] == 2 * 7
    assert roofline.abv_work(7, 3, 4, mode=1)[0] == 3 * 7
    # bytes bound: 96 B / 3.35 TB/s against 21 ops / 67 TFLOP/s
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        96 / 3.35e12)
    assert roofline.least_seconds(1e12, 1.0) == pytest.approx(1 / 67)


def test_session_work_counts_the_corpus(tmp_path):
    """The runner's count for a call equals a direct count."""
    import json
    from kb_tiny import SEED, TINY, REPO
    from kssd_bench import run
    name = "abv_mkssd_gtdb_r214_node8"
    cfg = json.loads((REPO / "kssd_bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(TINY[name])
    drv = run.load_file(REPO / "kssd_bench" / "runners" / "abv_search.py",
                        "kb_test_runner")
    traffic = {"runner": "abv_search", "mode": 2, "queries_per_call": 3,
               "pool": 8, "loop": "closed", "callers": 1,
               "compare_calls": 1}
    s = drv.Session(cfg, traffic, SEED, "cpu", str(tmp_path))
    try:
        s.call(0)
        ops, nbytes = s.work(0)
    finally:
        s.close()
    db = abv_corpus.make(cfg, 8, SEED).db
    dense = np.zeros((db.n, cfg["n_species"]), bool)
    dense[db.owner(), db.species] = True
    want_ops = want_bytes = 0
    for j in s.records.ids[0]:
        sp, _ = s.corpus.queries.row(j)
        postings = int(dense[:, sp].sum())
        pairs = int(dense[:, sp].any(axis=1).sum())
        want_ops += 3 * postings
        want_bytes += 8 * postings + 8 * sp.size + 4 * pairs
    assert (ops, nbytes) == (want_ops, want_bytes)
