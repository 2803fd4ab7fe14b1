"""The harness end to end on the CPU at a tiny size: the program agrees
with the plain reference in all three modes, new traffic and metric files
are picked up with no other edit, and a run without a card exits nonzero
and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from kb_tiny import REPO, add_cell, run_cell, tiny_root


ALL_CHECKS = {"db_rows_wrong", "overlap_wrong", "text_wrong", "measure_gap",
              "text_gap"}


@pytest.fixture
def root(tmp_path):
    return tiny_root(tmp_path)


@pytest.mark.parametrize("workload", ["abv.l2.single", "abv.l1.single"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cells_run_correct(root, capsys, workload, trace):
    rc, res, err = run_cell(root, workload, capsys, trace=trace)
    assert rc == 0 and res["correct"] is True, err
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == ALL_CHECKS   # every layer observed
    assert err.rstrip().splitlines()[-1].startswith("check text_gap:")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in manifest[kind]
            if workload in m.get("workloads", [workload])}
    # device-trace metrics find nothing to read on the CPU
    want -= {"abv_roofline", "device_idle"}
    assert want <= set(res["metrics"])
    for v in res["metrics"].values():
        assert v["value"] > 0


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_reference_agrees_in_every_mode(root, capsys, mode):
    """A cell added as data files alone: a new traffic mix (the mode, a
    batch of 3) runs and is compared, in all three measures."""
    add_cell(root, f"abv.m{mode}.batch3", "abv_mkssd_gtdb_r214_node8",
             f"m{mode}.batch3",
             {"runner": "abv_search", "mode": mode, "queries_per_call": 3,
              "pool": 12, "loop": "closed", "callers": 1,
              "compare_calls": 3},
             limits_from="abv.l2.single")
    rc, res, err = run_cell(root, f"abv.m{mode}.batch3", capsys)
    assert rc == 0 and res["correct"] is True, err
    assert res["checks"]["measure_gap"]["value"] < 1e-4


def test_new_metric_file_is_picked_up(root, capsys):
    (root / "kssd_bench" / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["end_to_end"].append({"name": "calls_in_window", "unit": "calls",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    rc, res, _ = run_cell(root, "abv.l2.single", capsys)
    assert rc == 0
    assert res["metrics"]["calls_in_window"]["value"] >= 1


def test_unknown_workload_exits_nonzero(root, capsys):
    rc, res, _ = run_cell(root, "no.such.cell", capsys)
    assert rc != 0 and res is None


def test_no_card_exits_nonzero_without_a_result():
    """No card visible (on any host, one with cards too): exit 1 before
    any set-up, no result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    got = subprocess.run(
        [sys.executable, "kssd_bench/run.py", "--workload", "abv.l2.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0
    assert not [ln for ln in got.stdout.splitlines() if ln.startswith("{")]
    assert "needs 1 CUDA device" in got.stderr


@pytest.mark.parametrize("altered", [False, True])
def test_another_route_is_judged_by_its_text(root, capsys, monkeypatch,
                                             altered):
    """A route without the dense matrix's cache and ``abv_search_batch``
    (here the port's sparse host route behind the dense entry point)
    leaves those layers' checks out and says so; its ranked text is
    still compared, and one value altered in it fails."""
    from metakssd_tpu_torch import composite
    from metakssd_tpu_torch.ops import dense_abv

    class Alter:
        def __init__(self, out):
            self.out = out

        def write(self, s):
            head, sep, rest = s.partition("\t")
            if altered and sep and not head.startswith("#"):
                val, nl, tail = rest.partition("\n")
                s = f"{head}\t{float(val) * 1.01:f}{nl}{tail}"
            return self.out.write(s)

    def search(refdir, queries, mode=0, out=None, *, device):
        composite.abv_search(refdir, queries, mode, out=Alter(out))
    monkeypatch.setattr(dense_abv, "abv_search_dense", search)
    monkeypatch.delattr(dense_abv, "_DENSE_CACHE")
    monkeypatch.delattr(dense_abv, "abv_search_batch")
    rc, res, err = run_cell(root, "abv.l2.single", capsys)
    assert rc == 0 and res is not None
    assert set(res["checks"]) == {"text_wrong", "text_gap"}
    assert "not observed in this run" in err
    assert "db_rows_wrong" in err and "measure_gap" in err
    assert res["correct"] is (not altered), err


def test_compared_calls_are_drawn_over_the_whole_window():
    """The runner keeps the text of ``keep`` calls, drawn from the seed
    as they come, and counts the characters of the others."""
    import numpy as np
    from kssd_bench import run
    drv = run.load_file(REPO / "kssd_bench" / "runners" / "abv_search.py",
                        "kb_test_runner_records")

    def window(n, seed):
        recs = drv.Records(16, np.random.default_rng([seed, 2]))
        for i in range(n):
            sink = drv._Sink()
            sink.write(f"#Sample\tL2norm\n{'x' * (i % 7)}\n")
            recs.add([i], sink, None)
        return recs
    a, b = window(1000, 5), window(1000, 5)
    assert sorted(a.kept) == sorted(b.kept)
    assert len(a.kept) == 16 and a.batch_seen == 0
    total = sum(len(f"#Sample\tL2norm\n{'x' * (i % 7)}\n")
                for i in range(1000))
    assert a.chars + sum(s.chars() for s, _ in a.kept.values()) == total
    # every call has the same chance: over seeds, late calls as often
    # as early ones
    late = [sum(c >= 500 for c in window(1000, seed).kept)
            for seed in range(40)]
    assert 5 * 40 < sum(late) < 11 * 40
    assert sorted(window(10, 5).kept) == list(range(10))
