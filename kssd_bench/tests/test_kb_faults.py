"""A run with the timed path broken underneath comes out not correct:
one fault a test, planted in the program's module at a tiny size on the
CPU (the harness's look for a card skipped).  A cell on one chip has no
exchange between chips to leave out."""

import numpy as np
import pytest

from kb_tiny import run_cell, tiny_root

from metakssd_tpu_torch.ops import dense_abv


def _stale(monkeypatch):
    """Each call returns the previous call's answer (state unchanged)."""
    orig = dense_abv.abv_search_batch
    prev = {}

    def batch(dense, queries, mode=0):
        got = orig(dense, queries, mode=mode)
        out = prev.get("last", got)
        prev["last"] = got
        return out
    monkeypatch.setattr(dense_abv, "abv_search_batch", batch)


def _half_batch(monkeypatch):
    """Half of each call's queries are left out (of one, that one)."""
    orig = dense_abv.abv_search_dense

    def search(refdir, queries, mode=0, out=None, *, device):
        return orig(refdir, queries[:len(queries) // 2], mode,
                    out=out, device=device)
    monkeypatch.setattr(dense_abv, "abv_search_dense", search)


def _altered(monkeypatch):
    """One answer a call is altered where it is produced (1% off)."""
    orig = dense_abv.abv_search_batch

    def batch(dense, queries, mode=0):
        measure, overlap = orig(dense, queries, mode=mode)
        j = np.flatnonzero(overlap[0])[0]
        measure[0, j] *= np.float32(1.01)
        return measure, overlap
    monkeypatch.setattr(dense_abv, "abv_search_batch", batch)


def _staging(monkeypatch):
    """The staged database loses one posting."""
    orig = dense_abv.dense_abv_from_index

    def stage(idx, nspecies, device):
        dense = orig(idx, nspecies, device)
        dense.mat[int(idx.abm_idx[-1]), nspecies - 1] = 0.0
        return dense
    monkeypatch.setattr(dense_abv, "dense_abv_from_index", stage)


@pytest.mark.parametrize("workload", ["abv.l2.single", "abv.l1.single"])
@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered, _staging],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(tmp_path, capsys, monkeypatch, workload,
                              fault):
    root = tiny_root(tmp_path)
    fault(monkeypatch)
    rc, res, err = run_cell(root, workload, capsys)
    assert rc == 0 and res is not None
    assert res["correct"] is False, err
    assert any("FAIL" in ln for ln in err.splitlines())
