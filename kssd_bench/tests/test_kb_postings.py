"""The postings cells at a tiny size on the CPU (the harness's look for a
card skipped): ``abv.whole.l2.single`` (runner ``abv_postings``) and
``abv.cos.single`` (runner ``abv_search``) read correct, their metrics
read what the CPU has, planted faults in the postings route read not
correct, each cell's control fails its committed limits, and a program
without the postings module fails at set-up at once."""

import json
import sys
import time

import pytest

from kb_tiny import REPO, SEED, run_cell, tiny_root
from kssd_bench import calibrate

from metakssd_tpu_torch.ops import abv_postings

WHOLE = "abv.whole.l2.single"
POST_CHECKS = {"index_wrong", "measure_wrong", "touch_wrong", "text_wrong",
               "text_gap"}
# the whole DB's configuration shrunk: samples of 1-200 species, so that
# some overlap a query in many species and some hold one (ties)
TINY_WHOLE = dict(n_species=300, species_pool=300, n_samples=3000,
                  species_per_sample=dict(median=20, sigma=1.0, min=1,
                                          max=200))


@pytest.fixture
def root(tmp_path):
    root = tiny_root(tmp_path)
    p = root / "kssd_bench" / "configs" / "abv_mkssd_gtdb_r214_whole.json"
    cfg = json.loads(p.read_text())
    cfg.update(TINY_WHOLE)
    p.write_text(json.dumps(cfg))
    return root


def _wanted(root, workload: str, trace: int) -> set:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    # metrics of the device's trace find nothing to read on the CPU
    return {m["name"] for m in manifest[kind]
            if workload in m.get("workloads", [workload])
            and m["source"] != "device_trace"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [WHOLE, "abv.cos.single"])
def test_cells_run_correct(root, capsys, workload, trace):
    rc, res, err = run_cell(root, workload, capsys, trace=trace)
    assert rc == 0 and res["correct"] is True, err
    assert res["failed"] == 0 and res["attempted"] > 0
    if workload == WHOLE:
        assert set(res["checks"]) == POST_CHECKS
    assert _wanted(root, workload, trace) <= set(res["metrics"])
    for v in res["metrics"].values():
        assert v["value"] > 0
    if trace:
        names = {k for k, _ in res["breakdown"]["idle_gaps"]}
        assert names


def _perturbed_posting(monkeypatch):
    """The staged index has one percentage one ulp off."""
    orig = abv_postings.stage_postings

    def stage(index, device):
        staged = orig(index, device)
        staged.pct[-1] = staged.pct[-1] * (1 + 2 ** -23)
        return staged
    monkeypatch.setattr(abv_postings, "stage_postings", stage)


def _reordered_sum(monkeypatch):
    """The sums run over the query's species in reverse order (the first
    touches as they should be)."""
    orig = abv_postings.postings_search_batch

    def batch(staged, queries, mode=0):
        measure, _ = orig(staged, [(sp[::-1].copy(), pc[::-1].copy())
                                   for sp, pc in queries], mode)
        return measure, orig(staged, queries, mode)[1]
    monkeypatch.setattr(abv_postings, "postings_search_batch", batch)


def _swapped_tie(monkeypatch):
    """Equal measures ranked in reverse first-touch order."""
    orig = abv_postings._order_key
    monkeypatch.setattr(abv_postings, "_order_key",
                        lambda m, t: orig(m, t.max(initial=0) - t))


def _dropped_line(monkeypatch):
    """Each query's text loses one line."""
    from metakssd_tpu_torch.io import native
    orig = native.write_name_float_lines

    def write(out, names, blob, off, ids, vals):
        orig(out, names, blob, off, ids[1:], vals[1:])
    monkeypatch.setattr(native, "write_name_float_lines", write)


@pytest.mark.parametrize("fault", [_perturbed_posting, _reordered_sum,
                                   _swapped_tie, _dropped_line],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    rc, res, err = run_cell(root, WHOLE, capsys)
    assert rc == 0 and res is not None
    assert res["correct"] is False, err
    assert any("FAIL" in ln for ln in err.splitlines())


@pytest.mark.parametrize("workload", [WHOLE, "abv.cos.single"])
def test_control_fails_the_limits(root, workload, monkeypatch):
    """The control (bfloat16 postings for the postings cell, TF32 inputs
    for the dense one) fails the committed limits; the program on the same
    seeds passes them."""
    limits = json.loads((root / "kssd_bench" / "limits"
                         / f"{workload}.json").read_text())
    if workload == WHOLE:
        from kssd_bench.reference import abv_post_control
        monkeypatch.setattr(calibrate, "control", abv_post_control)
    rows = calibrate.calibrate(workload, [3, 2**31 + 3], [3, 2**31 + 3], 0.3,
                               root=root, device="cpu")
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
        assert row["control_failed"] > 0


def test_without_the_module_setup_fails_at_once(root, capsys, monkeypatch):
    """A program without ``ops/abv_postings.py`` (the parent of this
    route): set-up raises before any data is made; no other route runs."""
    import metakssd_tpu_torch.ops as ops
    monkeypatch.delattr(ops, "abv_postings")
    monkeypatch.setitem(sys.modules, "metakssd_tpu_torch.ops.abv_postings",
                        None)
    t = time.perf_counter()
    with pytest.raises(ImportError):
        run_cell(root, WHOLE, capsys, seed=SEED)
    assert time.perf_counter() - t < 30


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_float64_walk_is_the_reference_measure(mode):
    """``abv_post_check.walk``'s float64 measure (over a query's postings)
    gives ``abv_ref.Reference.search``'s samples and measures."""
    from kssd_bench import abv_corpus
    from kssd_bench.reference import abv_post_check
    from kssd_bench.reference.abv_ref import Reference
    import numpy as np
    cfg = {**json.loads((REPO / "kssd_bench" / "configs"
                         / "abv_mkssd_gtdb_r214_whole.json").read_text()),
           **TINY_WHOLE}
    corpus = abv_corpus.make(cfg, 8, SEED, "cpu")
    post = abv_post_check.Postings.from_vectors(corpus.db, corpus.n_species)
    dense = Reference(corpus.db, corpus.n_species)
    for j in range(corpus.queries.n):
        sp, pc = corpus.queries.row(j)
        _, touch, m64 = abv_post_check.walk(post, sp, pc, mode)
        ids = np.flatnonzero(touch >= 0)
        val = m64[ids]
        want_ids, want = dense.search(sp, pc, mode)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(val, want, rtol=1e-12)
        assert ids.size > 0
