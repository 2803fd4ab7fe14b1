"""The port's benchmark, ``metakssd_tpu_torch.bench``, and its kernel leg,
``metakssd_tpu_torch.ops.kernel_bench``, on the CPU.

``kernel_chain_mwin``'s dispatches reduce to the drtuple sums that the JAX
package's ``sketch_xla`` path gives for the same codes; the bench writes
the root ``bench.py``'s input files byte for byte; a run on the CPU at a
tiny size prints one line with every key; a leg that fails, or a card
that is missing, ends the run nonzero with no number; the CPU sketch and
e2e numbers come from ``--device host`` runs, the root bench's meaning,
and the bench itself takes no ``--device host``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from metakssd_tpu.formats.shuf import make_shuf as jax_make_shuf
from metakssd_tpu.ops import sketch_xla
from metakssd_tpu.params import SketchParams
from metakssd_tpu_torch import bench
from metakssd_tpu_torch.ops import kernel_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"MKSSD_BENCH_READS": "2000", "MKSSD_BENCH_SPECIES": "64",
        "MKSSD_BENCH_REPS": "1"}
KEYS = ("cpu_reads_per_s", "cpu_reads_per_s_runs", "reads_per_s_runs",
        "kernel_mwin_per_s",
        "kernel_mwin_per_s_runs", "profile_latency_s",
        "profile_latency_s_runs", "abv_queries_per_s",
        "abv_queries_per_s_runs", "abv_dense_queries_per_s",
        "abv_dense_queries_per_s_runs", "e2e_total_s", "e2e_total_s_runs",
        "e2e_cold_total_s", "cpu_e2e_total_s", "cpu_e2e_total_s_runs",
        "cpu_e2e_cold_total_s")


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root: str) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_kernel_chain_sums_match_sketch_xla():
    """A pass of 3 dispatches on the CPU (K1's plain version): a positive
    rate, and each dispatch's int32 sum equal to that of the drtuples
    ``sketch_xla.sketch_codes`` gives for the dispatch's codes, with the
    JAX module's default shuffle."""
    nwin, k_reps = 1 << 14, 3
    assert kernel_bench.kernel_chain_mwin(nwin=nwin, k_reps=2, reps=1,
                                          device="cpu") > 0
    shuf = jax_make_shuf(SketchParams(k=11, subk=6, drlevel=3), seed=1234)
    np.testing.assert_array_equal(kernel_bench.default_shuf().shuffled_dim,
                                  shuf.shuffled_dim)
    got = kernel_bench.chain_sums(nwin=nwin, k_reps=k_reps, device="cpu")
    codes = kernel_bench.chain_codes(nwin, shuf.params.kmer_len, k_reps)
    want = [np.uint32(int(sketch_xla.sketch_codes(c, shuf).sum())
                      & 0xFFFFFFFF).view(np.int32) for c in codes]
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k_reps      # the streams differ


def test_inputs_byte_identical_to_root_bench(tmp_path, monkeypatch):
    """The fastq, shuffle, query sketch, MarkerDB and abv corpus (with its
    index) that the root bench writes, and those the port's bench writes
    into the same cache dir after it, are the same bytes."""
    cache = str(tmp_path / "cache")
    root = _root_bench()
    for mod in (root, bench):
        monkeypatch.setattr(mod, "CACHE", cache)
        monkeypatch.setattr(mod, "N_READS", 3000)
        monkeypatch.setattr(mod, "N_SPECIES", 64)
    monkeypatch.setenv("MKSSD_BACKEND", "cpu")
    fq, shufp = root._prepare()
    dbdir, qdir, _ = root._profile_fixture()
    root._worker_abv("cpu")                 # the corpus and its index
    theirs = {"fq": fq, "shuf": shufp, "db": dbdir, "qry": qdir}
    os.rename(cache, str(tmp_path / "root"))

    fq, shufp = bench._prepare()
    dbdir, qdir, _ = bench._profile_fixture("cpu")
    bench._abv_fixture(dbdir)
    ours = {"fq": fq, "shuf": shufp, "db": dbdir, "qry": qdir}
    for what, path in ours.items():
        other = theirs[what].replace(cache, str(tmp_path / "root"))
        if os.path.isdir(path):
            a, b = _tree(other), _tree(path)
            assert sorted(a) == sorted(b) and a, what
            for f in a:
                assert a[f] == b[f], f"{what}/{f} differs"
        else:
            with open(other, "rb") as x, open(path, "rb") as y:
                assert x.read() == y.read(), what
    assert len(_tree(os.path.join(dbdir, "abundance_Vec"))) == \
        bench.ABV_SAMPLES


# A stand-in for the C compiler: it writes, as its -o output, a tool
# that prints 100 lines and exits 0 (or exits 3 with STUB_TOOL_FAILS set)
STUB_GCC = """#!/bin/sh
while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done
printf '#!/bin/sh\\n[ -n "$STUB_TOOL_FAILS" ] && exit 3\\nseq 100\\n' \\
    > "$out"
chmod +x "$out"
"""


def _stub_reference(tmp_path) -> dict:
    """A reference source dir and the stub compiler first on PATH; returns
    the environment that points the bench at them."""
    ref, bindir = tmp_path / "reference", tmp_path / "bin"
    ref.mkdir()
    bindir.mkdir()
    (ref / "metakssd.c").write_text("int main(void) { return 0; }\n")
    gcc = bindir / "gcc"
    gcc.write_text(STUB_GCC)
    gcc.chmod(0o755)
    return {"MKSSD_REFERENCE": str(ref),
            "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}"}


def _run_bench(tmp_path, *args, **env):
    e = dict(os.environ, MKSSD_BENCH_CACHE=str(tmp_path / "cache"), **env)
    if "MKSSD_REFERENCE" not in env:
        e.pop("MKSSD_REFERENCE", None)
    return subprocess.run(
        [sys.executable, "-m", "metakssd_tpu_torch.bench", *args], cwd=REPO,
        env=e, capture_output=True, text=True, timeout=300)


def test_cpu_run_prints_every_key(tmp_path):
    """``--device cpu`` at a tiny size: one JSON line, every leg's key
    positive, each repeat listed, no reference (vs_baseline 0.0) and no
    kernel launched (the plain versions ran)."""
    r = _run_bench(tmp_path, "--device", "cpu", **TINY)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "fastq_sketch_reads_per_s"
    assert line["unit"] == "reads/s" and line["value"] > 0
    assert line["vs_baseline"] == 0.0
    ex = line["extra"]
    for key in KEYS:
        got = ex[key]
        assert (min(got) if isinstance(got, list) else got) > 0, key
    assert len(ex["kernel_mwin_per_s_runs"]) == 1
    for key in ("e2e_stages", "cpu_e2e_stages"):
        assert set(ex[key]) == {"e2e.sketch", "e2e.profile", "e2e.poisson"}
    assert ex["device"] == "cpu"
    assert ex["launches"] == {leg: {} for leg in bench.LEGS}
    assert not any(k.startswith("ref_") for k in ex)


def test_cpu_e2e_run_prints_its_line(tmp_path):
    """``--device cpu --e2e`` at a tiny size, with a stub reference tool:
    one ``e2e_profile_latency_s`` line with the steady and cold seconds,
    every repeat, the stages, the reference's seconds and vs_baseline."""
    r = _run_bench(tmp_path, "--device", "cpu", "--e2e", **TINY,
                   **_stub_reference(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "e2e_profile_latency_s"
    assert line["unit"] == "s" and line["value"] > 0
    ex = line["extra"]
    assert ex["e2e_total_s_runs"] == [line["value"]]
    assert ex["e2e_cold_total_s"] > 0 and ex["e2e_ref_total_s"] > 0
    assert line["vs_baseline"] == ex["e2e_ref_total_s"] / line["value"]
    assert set(ex["stages"]) == {"e2e.sketch", "e2e.profile", "e2e.poisson"}
    assert ex["device"] == "cpu" and ex["launches"] == {"e2e": {}}


def test_cpu_legs_run_the_host_engine(tmp_path, monkeypatch):
    """The sketch leg's ``cpu_reads_per_s`` repeats are ``run_stage1``
    calls on ``--device host`` (the fused native sketch each time), after
    those on ``--device``; every run of the e2e_host leg profiles on
    host, under the ``cpu_`` keys."""
    from metakssd_tpu_torch import pipeline, profile_e2e
    from metakssd_tpu_torch.io import native
    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(bench, "N_READS", 2000)
    monkeypatch.setattr(bench, "N_SPECIES", 64)
    monkeypatch.setattr(bench, "REPS", 2)
    calls = []

    def record(mod, name):
        real = getattr(mod, name)

        def f(*a, **kw):
            calls.append((name, kw.get("device")))
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, f)
    record(pipeline, "run_stage1")
    record(native, "sketch_fastq")
    res = bench.LEGS["sketch"]("cpu")
    assert calls == [("run_stage1", "cpu")] * 2 + [
        ("run_stage1", "host"), ("sketch_fastq", None)] * 2
    assert len(res["cpu_reads_per_s_runs"]) == 2
    assert res["cpu_reads_per_s"] == max(res["cpu_reads_per_s_runs"])
    assert res["reads_per_s_runs"] != res["cpu_reads_per_s_runs"]
    calls.clear()
    bench._profile_fixture("cpu")
    record(profile_e2e, "profile_fastq")
    res = bench.LEGS["e2e_host"]("cpu")
    assert [d for n, d in calls if n == "profile_fastq"] == ["host"] * 3
    assert sorted(res) == ["cpu_e2e_cold_total_s", "cpu_e2e_stages",
                           "cpu_e2e_total_s", "cpu_e2e_total_s_runs"]


def test_reference_legs_with_a_stub_tool(tmp_path, monkeypatch):
    """The reference legs, with a stub compiler and tool: nothing without
    MKSSD_REFERENCE; with it, the tool is built into the cache and timed
    (reads/s, the best of REPS seconds); a tool that fails or prints too
    few lines gives no time; a binary path whose length would let the
    tool's argv[0] overflow hit a malloc size field gets a longer copy."""
    env = _stub_reference(tmp_path)
    monkeypatch.setenv("PATH", env["PATH"])
    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(bench, "REPS", 2)
    monkeypatch.setattr(bench, "REFERENCE", "")
    assert bench._oracle_bin() is None
    assert bench._bench_reference("r.fq", "s.shuf") == 0.0
    monkeypatch.setattr(bench, "REFERENCE", env["MKSSD_REFERENCE"])
    tool = bench._oracle_bin()
    assert tool and os.access(tool, os.X_OK) and len(tool) % 16 != 11
    fq, shufp = tmp_path / "r.fq", tmp_path / "s.shuf"
    fq.write_bytes(b"@r\nACGT\n+\nIIII\n")
    shufp.write_bytes(b"\0" * 64)
    assert bench._bench_reference(str(fq), str(shufp)) > 0
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    assert bench._best_ref_s([["dist"], ["composite"]], min_lines=100,
                             fresh=str(fresh)) > 0
    assert not fresh.exists()
    assert bench._best_ref_s([["composite"]], min_lines=101) is None
    monkeypatch.setenv("STUB_TOOL_FAILS", "1")
    assert bench._best_ref_s([["composite"]]) is None

    d = tmp_path / "long"
    d.mkdir()
    name = "t" * ((10 - len(str(d))) % 16 + 16)
    path = d / name
    assert len(str(path)) % 16 == 11
    path.write_bytes(b"tool")
    safe = bench._safe_len_path(str(path))
    assert safe == str(path) + "_" and open(safe, "rb").read() == b"tool"
    assert bench._safe_len_path(safe) == safe


def test_failing_leg_fails_the_run(tmp_path, monkeypatch, capsys):
    """A leg that raises (the legs run in this process here) makes the run
    exit 1 with no line; a leg's process that fails makes its runner
    raise."""
    def in_process(task, device):
        return {**bench.LEGS[task](device), "launches": {}}

    def broken(device):
        raise RuntimeError("the abv leg broke")

    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(bench, "N_READS", 2000)
    monkeypatch.setattr(bench, "N_SPECIES", 64)
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "_run_worker", in_process)
    monkeypatch.setitem(bench.LEGS, "abv", broken)
    assert bench.main(["--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "the abv leg broke" in err
    monkeypatch.undo()
    with pytest.raises(bench.LegFailed, match="leg no-such-leg on cpu"):
        bench._run_worker("no-such-leg", "cpu")


def test_cuda_without_a_card_prints_no_number(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    r = _run_bench(tmp_path, "--device", "cuda", **TINY)
    assert r.returncode != 0 and r.stdout == ""
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not os.path.exists(tmp_path / "cache")


@pytest.mark.parametrize("device", ["host", "tpu", "cuda:x", "cpu:0"])
def test_device_refuses_all_but_cuda_and_cpu(device, capsys):
    """``--device`` is cuda, cuda:N or cpu: the host engine's legs run
    under the ``cpu_*`` keys whatever it is, so ``host`` is refused
    before any leg, as is a device that is none of these."""
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", device])
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert out == "" and "cuda, cuda:N or cpu" in err


@pytest.mark.parametrize("device", ["cuda", "cuda:3", "cpu"])
def test_device_takes_cuda_and_cpu(device):
    assert bench._bench_device(device) == device
