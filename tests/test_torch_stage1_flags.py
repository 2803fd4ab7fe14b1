"""The port's stage-I flags against the JAX package, byte for byte, on the
CPU: ``dist --byread`` (per-read sketches in stream order), ``dist -P``
(piped fastq) and ``--ckpt`` (crash and resume of the batched, per-file
and streamed paths, also from a checkpoint the JAX package wrote).
"""

import os

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import pipeline as jax_pipeline
from metakssd_tpu import profile_e2e as jax_profile_e2e
from metakssd_tpu.formats.shuf import make_shuf, write_shuf
from metakssd_tpu.io import native as jax_native
from metakssd_tpu.ops import sketch_xla
from metakssd_tpu.params import SketchParams

from metakssd_tpu_torch import cli, pipeline, profile_e2e
from metakssd_tpu_torch.formats.shuf import read_shuf
from metakssd_tpu_torch.io import native
from metakssd_tpu_torch.ops import sketch

from tests.util import random_seq, reads_from_genome, write_fasta, \
    write_fastq

K8S5L2 = (8, 5, 2)
L3K11 = (11, 6, 3)
WIDE = (12, 6, 2)               # k - drlevel > 8: the golden route


def _tree(root: str) -> dict:
    """{name: bytes} of every file of a dir, hidden entries left out."""
    out = {}
    for f in sorted(os.listdir(root)):
        if not f.startswith("."):
            with open(os.path.join(root, f), "rb") as fh:
                out[f] = fh.read()
    return out


def _same_tree(a: str, b: str) -> None:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for f in ta:
        assert ta[f] == tb[f], f


@pytest.fixture(scope="module")
def shufs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flag_shufs")
    out = {}
    for cfg in (K8S5L2, L3K11, WIDE):
        path = str(tmp / ("K%dS%dL%d.shuf" % cfg))
        write_shuf(path, make_shuf(SketchParams(*cfg), seed=sum(cfg)))
        out[cfg] = path
    return out


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """A fasta of several records (N runs, a record shorter than a k-mer,
    lower case) and a fastq of reads (short reads, N bases, a poly-A
    read, mixed qualities)."""
    tmp = tmp_path_factory.mktemp("flag_seqs")
    rng = np.random.default_rng(41)
    g = random_seq(rng, 60_000)
    recs = [g[:9000], "ACGTNACG", random_seq(rng, 7000, n_prob=0.01),
            g[20_000:26_000].lower(), "N" * 50 + g[30_000:34_000]]
    fa = str(tmp / "recs.fa")
    write_fasta(fa, recs)
    reads = reads_from_genome(rng, g, 900, 110, err=0.01)
    reads[::37] = [r[:15] for r in reads[::37]]
    reads[::41] = [r[:50] + "NN" + r[52:] for r in reads[::41]]
    reads[300] = "A" * 110
    quals = ["".join(rng.choice(list("#+5?I"), len(r))) for r in reads]
    fq = str(tmp / "reads.fq")
    write_fastq(fq, reads, quals)
    fq2 = str(tmp / "reads2.fq")
    write_fastq(fq2, reads_from_genome(rng, g, 500, 100))
    return {"fa": fa, "fq": fq, "fq2": fq2}


# ---------------------------------------------------------------------------
# --byread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [K8S5L2, L3K11, WIDE])
@pytest.mark.parametrize("kind", ["fa", "fq"])
def test_byread_matches(tmp_path, shufs, seqs, cfg, kind):
    """dist --byread writes the JAX CLI's combco.{c}, combco.index.{c} and
    cofiles.stat: windows in stream order with duplicates, per-read
    counts, on fasta records and fastq reads, also for the wide golden
    config."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["dist", "-L", shufs[cfg], "--byread"]
    assert jax_cli.main([*argv, "-o", a, seqs[kind]]) == 0
    assert cli.main([*argv, "-o", b, "--device", "cpu", seqs[kind]]) == 0
    _same_tree(a, b)
    nreads = 5 if kind == "fa" else 900
    idx = np.fromfile(os.path.join(b, "combco.index.0"), np.uint64)
    assert idx.size == nreads + 1
    assert idx[-1] == os.path.getsize(os.path.join(b, "combco.0")) // 4


@pytest.mark.parametrize("chunk,capacity", [(4096, None), (4096, 8),
                                            (997, 3)])
def test_byread_across_chunks_and_reruns(tmp_path, shufs, seqs, chunk,
                                         capacity):
    """Positions cross the chunk loop's TL-1 overlaps, and a capacity
    below a chunk's survivors sends it through the K2 rerun (positions
    by nonzero); the per-read dir stays the JAX package's."""
    shuf = read_shuf(shufs[K8S5L2])
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.sketch_byread(seqs["fq"], shuf, a)
    pipeline.sketch_byread(seqs["fq"], shuf, b, device="cpu",
                           chunk_windows=chunk, capacity=capacity)
    _same_tree(a, b)


def test_byread_takes_one_input(tmp_path, shufs, seqs):
    argv = ["dist", "-L", shufs[K8S5L2], "--byread", "-o",
            str(tmp_path / "x"), "--device", "cpu", seqs["fq"], seqs["fq2"]]
    with pytest.raises(SystemExit, match="--byread takes one input file"):
        cli.main(argv)


# ---------------------------------------------------------------------------
# -P
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["-A"], ["-Q", "20"],
                                   ["-A", "-Q", "20"]])
def test_pipecmd_matches(tmp_path, shufs, seqs, flags):
    """dist -P cat writes the JAX CLI's dir, and the same dir as dist of
    the file itself (piped input is fastq; -A drops the quality filter)."""
    argv = ["dist", "-L", shufs[K8S5L2], *flags]
    a, b, c = (str(tmp_path / x) for x in ("jax", "port", "plain"))
    assert jax_cli.main([*argv, "-P", "cat", "-o", a, seqs["fq"]]) == 0
    assert cli.main([*argv, "-P", "cat", "-o", b, "--device", "cpu",
                     seqs["fq"]]) == 0
    assert cli.main([*argv, "-o", c, "--device", "cpu", seqs["fq"]]) == 0
    _same_tree(a, b)
    _same_tree(b, c)


def test_pipecmd_keeps_files_out_of_the_batch(tmp_path, shufs, seqs):
    """With -P every file goes through the command, one at a time: a
    command that keeps the first 100 reads gives the JAX CLI's dir, not
    that of the whole files."""
    argv = ["dist", "-L", shufs[K8S5L2], "-P", "head -n 400"]
    a, b, c = (str(tmp_path / x) for x in ("jax", "port", "whole"))
    inputs = [seqs["fq"], seqs["fq2"]]
    assert jax_cli.main([*argv, "-o", a, *inputs]) == 0
    assert cli.main([*argv, "-o", b, "--device", "cpu", *inputs]) == 0
    assert cli.main(["dist", "-L", shufs[K8S5L2], "-o", c, "--device",
                     "cpu", *inputs]) == 0
    _same_tree(a, b)
    assert _tree(b)["combco.0"] != _tree(c)["combco.0"]


# ---------------------------------------------------------------------------
# --ckpt
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k8_shuf(shufs):
    return read_shuf(shufs[K8S5L2])


def _fastas(tmp, n=6, bases=4000):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        p = os.path.join(str(tmp), f"g{i}.fa")
        write_fasta(p, [random_seq(rng, bases)])
        paths.append(p)
    return paths


def _crash_after(monkeypatch, mod, name, n_ok: int, log: list):
    """Replace mod.name by a wrapper that records its first argument and
    raises on call n_ok + 1."""
    real = getattr(mod, name)

    def wrapped(*a, **kw):
        if len(log) >= n_ok:
            raise RuntimeError("injected crash")
        log.append(a[0])
        return real(*a, **kw)
    monkeypatch.setattr(mod, name, wrapped)
    return real


def _counting(monkeypatch, mod, name, real, log: list):
    def wrapped(*a, **kw):
        log.append(a[0])
        return real(*a, **kw)
    monkeypatch.setattr(mod, name, wrapped)


def test_ckpt_resume_batched(tmp_path, k8_shuf, monkeypatch):
    """Crash after the first group of 2 files; the resumed run sketches
    only the other files, clears .stage1_ckpt and writes the JAX
    package's uninterrupted dir."""
    paths = _fastas(tmp_path)
    clean = str(tmp_path / "clean")
    jax_pipeline.run_stage1(paths, k8_shuf, clean)
    monkeypatch.setattr(pipeline, "CKPT_GROUP", 2)
    first: list = []
    real = _crash_after(monkeypatch, pipeline, "_batched_stage1", 1, first)
    out = str(tmp_path / "ck")
    opts = pipeline.SketchOptions(ckpt=True)
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run_stage1(paths, k8_shuf, out, opts, device="cpu")
    ckdir = os.path.join(out, ".stage1_ckpt")
    assert sorted(os.listdir(ckdir)) == ["file0.npz", "file1.npz"]
    resumed: list = []
    _counting(monkeypatch, pipeline, "_batched_stage1", real, resumed)
    pipeline.run_stage1(paths, k8_shuf, out, opts, device="cpu")
    assert [p for grp in resumed for p in grp] == paths[2:]
    assert not os.path.isdir(ckdir)
    _same_tree(clean, out)


def test_ckpt_rerun_with_other_options_sketches_again(tmp_path, k8_shuf,
                                                      monkeypatch):
    """Snapshots written with one set of options are stale for another:
    every file is sketched again and the dir is the JAX package's."""
    paths = _fastas(tmp_path, n=4)
    monkeypatch.setattr(pipeline, "CKPT_GROUP", 2)
    first: list = []
    real = _crash_after(monkeypatch, pipeline, "_batched_stage1", 1, first)
    out = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run_stage1(paths, k8_shuf, out,
                            pipeline.SketchOptions(ckpt=True), device="cpu")
    again: list = []
    _counting(monkeypatch, pipeline, "_batched_stage1", real, again)
    opts = pipeline.SketchOptions(ckpt=True, dedup=True)
    pipeline.run_stage1(paths, k8_shuf, out, opts, device="cpu")
    assert [p for grp in again for p in grp] == paths
    clean = str(tmp_path / "clean")
    jax_pipeline.run_stage1(paths, k8_shuf, clean,
                            jax_pipeline.SketchOptions(dedup=True))
    _same_tree(clean, out)


def test_file_ckpt_invalidated_on_change(tmp_path, k8_shuf):
    """A file snapshot loads under its own options only, and not after
    its input changed; the JAX package reads the port's snapshot."""
    paths = _fastas(tmp_path, n=1)
    ckdir = str(tmp_path / "ckd")
    os.makedirs(ckdir)
    opts = pipeline.SketchOptions()
    sets = pipeline.sketch_file(paths[0], k8_shuf, opts, "cpu")
    fp = pipeline._file_ckpt_path(ckdir, 0)
    params = pipeline._file_ckpt_params(paths[0], k8_shuf, opts)
    assert params == jax_pipeline._file_ckpt_params(
        paths[0], k8_shuf, jax_pipeline.SketchOptions())
    pipeline._save_file_ckpt(fp, paths[0], sets, params)
    for got in (pipeline._load_file_ckpt(fp, paths[0], params),
                jax_pipeline._load_file_ckpt(fp, paths[0], params)):
        np.testing.assert_array_equal(got[0][0], sets[0][0])
    for other in (pipeline.SketchOptions(abundance=True),
                  pipeline.SketchOptions(min_qual=20),
                  pipeline.SketchOptions(min_occ=2),
                  pipeline.SketchOptions(dedup=True),
                  pipeline.SketchOptions(byread=True)):
        p2 = pipeline._file_ckpt_params(paths[0], k8_shuf, other)
        assert pipeline._load_file_ckpt(fp, paths[0], p2) is None
    with open(paths[0], "a") as f:
        f.write(">x\nACGTACGTACGT\n")
    assert pipeline._load_file_ckpt(fp, paths[0], params) is None


@pytest.fixture
def stream_fq(tmp_path, monkeypatch):
    """400 reads streamed in batches of 4000 bases (8 batches), one
    snapshot a batch, in both packages."""
    if not (native.available() and jax_native.available()):
        pytest.skip("the native parser is needed for the streaming path")
    rng = np.random.default_rng(9)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, [random_seq(rng, 80) for _ in range(400)])
    for mod in (pipeline, jax_pipeline):
        monkeypatch.setattr(mod, "STREAM_BATCH_BASES", 4000)
        monkeypatch.setattr(mod, "CKPT_EVERY", 1)
    return fq


def _batches(fq) -> int:
    return sum(1 for _ in native.stream_fastq(
        fq, 0, pipeline.STREAM_BATCH_BASES, copy=False))


def _stream_clean(fq, shuf):
    return jax_pipeline._sketch_fastq_streaming(fq, shuf, "occ", 1, 0, None,
                                                ckpt_file=None)


def _same_sets(a, b) -> None:
    assert len(a) == len(b)
    for (x, xa), (y, ya) in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert (xa is None) == (ya is None)
        if xa is not None:
            np.testing.assert_array_equal(xa, ya)


def test_stream_ckpt_resume(tmp_path, k8_shuf, stream_fq, monkeypatch):
    """Crash after 3 streamed batches; the resumed run sketches the
    other batches only, removes its snapshot and gives the JAX package's
    sets."""
    first: list = []
    real = _crash_after(monkeypatch, sketch, "sketch_codes", 3, first)
    ck = str(tmp_path / "s.ckpt")
    with pytest.raises(RuntimeError, match="injected"):
        pipeline._sketch_fastq_streaming(stream_fq, k8_shuf, "occ", 1, 0,
                                         "cpu", None, ckpt_file=ck)
    assert os.path.exists(ck)
    resumed: list = []
    _counting(monkeypatch, sketch, "sketch_codes", real, resumed)
    got = pipeline._sketch_fastq_streaming(stream_fq, k8_shuf, "occ", 1, 0,
                                           "cpu", None, ckpt_file=ck)
    n = _batches(stream_fq)
    assert n > 4 and len(resumed) == n - 3
    assert not os.path.exists(ck)
    _same_sets(got, _stream_clean(stream_fq, k8_shuf))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_ckpt_across_packages(tmp_path, k8_shuf, stream_fq,
                                     monkeypatch, writer):
    """One package writes a streaming snapshot and crashes; the other
    resumes it: the keys, names and payload are the same."""
    ck = str(tmp_path / "s.ckpt")
    first: list = []
    resumed: list = []
    if writer == "jax":
        real = _crash_after(monkeypatch, sketch_xla, "sketch_codes", 4,
                            first)
        with pytest.raises(RuntimeError, match="injected"):
            jax_pipeline._sketch_fastq_streaming(stream_fq, k8_shuf, "occ",
                                                 1, 0, None, ckpt_file=ck)
        monkeypatch.setattr(sketch_xla, "sketch_codes", real)
        _counting(monkeypatch, sketch, "sketch_codes", sketch.sketch_codes,
                  resumed)
        got = pipeline._sketch_fastq_streaming(stream_fq, k8_shuf, "occ", 1,
                                               0, "cpu", None, ckpt_file=ck)
    else:
        real = _crash_after(monkeypatch, sketch, "sketch_codes", 4, first)
        with pytest.raises(RuntimeError, match="injected"):
            pipeline._sketch_fastq_streaming(stream_fq, k8_shuf, "occ", 1,
                                             0, "cpu", None, ckpt_file=ck)
        monkeypatch.setattr(sketch, "sketch_codes", real)
        real_xla = sketch_xla.sketch_codes
        _counting(monkeypatch, sketch_xla, "sketch_codes", real_xla,
                  resumed)
        got = jax_pipeline._sketch_fastq_streaming(
            stream_fq, k8_shuf, "occ", 1, 0, None, ckpt_file=ck)
        monkeypatch.setattr(sketch_xla, "sketch_codes", real_xla)
    assert len(resumed) == _batches(stream_fq) - 4
    assert not os.path.exists(ck)
    _same_sets(got, _stream_clean(stream_fq, k8_shuf))


def test_batched_ckpt_written_by_jax_resumes_in_port(tmp_path, k8_shuf,
                                                     monkeypatch):
    """The JAX package crashes after its first group; the port resumes
    the same out dir, sketching only the files left."""
    paths = _fastas(tmp_path, n=5)
    clean = str(tmp_path / "clean")
    jax_pipeline.run_stage1(paths, k8_shuf, clean)
    monkeypatch.setattr(jax_pipeline, "CKPT_GROUP", 2)
    monkeypatch.setattr(pipeline, "CKPT_GROUP", 2)
    first: list = []
    _crash_after(monkeypatch, jax_pipeline, "_batched_stage1", 1, first)
    out = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected"):
        jax_pipeline.run_stage1(paths, k8_shuf, out,
                                jax_pipeline.SketchOptions(ckpt=True))
    resumed: list = []
    _counting(monkeypatch, pipeline, "_batched_stage1",
              pipeline._batched_stage1, resumed)
    pipeline.run_stage1(paths, k8_shuf, out,
                        pipeline.SketchOptions(ckpt=True), device="cpu")
    assert [p for grp in resumed for p in grp] == paths[2:]
    _same_tree(clean, out)


def test_cli_ckpt_flag(tmp_path, shufs):
    """dist --ckpt through the CLI writes the JAX CLI's dir and leaves no
    checkpoint dir (also with -r: stage I + II)."""
    paths = _fastas(tmp_path, n=3)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["dist", "-L", shufs[K8S5L2], "--ckpt"]
    assert jax_cli.main([*argv, "-o", a, *paths]) == 0
    assert cli.main([*argv, "-o", b, "--device", "cpu", *paths]) == 0
    _same_tree(a, b)
    assert not os.path.exists(os.path.join(b, ".stage1_ckpt"))
    # dist -r <sketch dir> --ckpt: stage II, the flag has nothing to do
    m = str(tmp_path / "mco")
    assert cli.main(["dist", "-r", b, "--ckpt", "--component_sz", "5",
                     "-o", m]) == 0
    assert os.path.exists(os.path.join(m, "mcofiles.stat"))


def test_profile_ckpt_resumes(tmp_path, shufs, stream_fq, monkeypatch):
    """profile --ckpt reaches the streaming path: a crash after 2 batches
    leaves a stream snapshot, and the resumed profile writes the JAX
    package's TSVs."""
    rng = np.random.default_rng(8)
    gdir = tmp_path / "g"
    gdir.mkdir()
    genomes = [random_seq(rng, 6000) for _ in range(3)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"sp{i}.fa"), [g])
    shufp = shufs[K8S5L2]
    db = str(tmp_path / "db")
    jax_pipeline.run_stage1(sorted(str(p) for p in gdir.iterdir()),
                            read_shuf(shufp), db)
    fq = str(tmp_path / "s.fq")
    write_fastq(fq, reads_from_genome(rng, genomes[0], 300, 80)
                + reads_from_genome(rng, genomes[2], 100, 80))
    ref = str(tmp_path / "jax_prof")
    jax_profile_e2e.profile_fastq([fq], db, shufp, ref)
    first: list = []
    real = _crash_after(monkeypatch, sketch, "sketch_codes", 2, first)
    out = str(tmp_path / "port_prof")
    opts = pipeline.SketchOptions(abundance=True, ckpt=True)
    with pytest.raises(RuntimeError, match="injected"):
        profile_e2e.profile_fastq([fq], db, shufp, out, opts=opts,
                                  device="cpu")
    assert os.path.exists(os.path.join(out, "qry.co", ".stage1_ckpt",
                                       "stream0.ckpt"))
    resumed: list = []
    _counting(monkeypatch, sketch, "sketch_codes", real, resumed)
    profile_e2e.profile_fastq([fq], db, shufp, out, opts=opts, device="cpu")
    assert _batches(fq) > 4 and len(resumed) == _batches(fq) - 2
    assert not os.path.exists(os.path.join(out, "qry.co", ".stage1_ckpt"))
    for f in ("species_coverage.tsv", "abundance.tsv"):
        with open(os.path.join(ref, f), "rb") as x, \
                open(os.path.join(out, f), "rb") as y:
            data = x.read()
            assert data and data == y.read(), f
