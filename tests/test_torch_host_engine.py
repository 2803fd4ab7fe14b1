"""``--device host``: the port's native host engine against the JAX
package's, on the CPU.

The engine's bindings (``io/native``: ``sketch_cpu``, ``sketch_fastq``,
``radix_sort_u32``, ``postings_expand``) against golden, numpy and the
JAX package's bindings, in the OpenMP build and in the serial build (the
card's host has no libgomp); every verb with ``--device host`` against
``metakssd_tpu.cli`` under ``MKSSD_BACKEND=cpu`` (the JAX package's host
routes) and against the port's ``--device cpu``, files and stdout byte
for byte (``--dense`` within 2e-3 of the JAX CLI's, as in
``tests/test_torch_dense_abv.py``); the routes without a host engine
(``--byread``, ``--mesh``, k - drlevel > 8) equal to ``--device cpu``;
CUDA never initialised; and a missing host library an error, never the
plain versions.
"""

import collections
import contextlib
import ctypes
import io
import os
import shutil

import numpy as np
import pytest
import torch

from metakssd_tpu import cli as jax_cli
from metakssd_tpu.formats.shuf import make_shuf, write_shuf
from metakssd_tpu.io import native as jax_native
from metakssd_tpu.io import seqio as jax_seqio
from metakssd_tpu.ops import golden as jax_golden
from metakssd_tpu.params import SketchParams

from metakssd_tpu_torch import cli, composite, device, setops
from metakssd_tpu_torch.formats.abv import write_abv_file
from metakssd_tpu_torch.formats.codir import write_codir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import read_shuf
from metakssd_tpu_torch.io import native
from metakssd_tpu_torch.ops import merge

from tests.util import random_seq, reads_from_genome, write_fasta, \
    write_fastq

K8S5L2 = (8, 5, 2)
L3K11 = (11, 6, 3)
WIDE = (12, 6, 2)               # k - drlevel > 8: no host engine
TOL = 2e-3                      # dense vs the JAX dense path

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="the host engine needs the native library of both packages")


def _tree(root: str) -> dict:
    """{relative path: bytes} of every file under ``root``, the MarkerDB
    staging sidecars (hidden) left out."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if not x.startswith(".")]
        for f in files:
            if not f.startswith("."):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Shuffles, 5 genomes (two records each, N runs), a fastq sampled
    from three of them (errors, N bases, short reads, a poly-A read, mixed
    qualities) and a second, smaller fastq."""
    tmp = tmp_path_factory.mktemp("host_engine")
    rng = np.random.default_rng(61)
    shufs = {}
    for cfg in (K8S5L2, L3K11, WIDE):
        shufs[cfg] = str(tmp / ("K%dS%dL%d.shuf" % cfg))
        write_shuf(shufs[cfg], make_shuf(SketchParams(*cfg), seed=sum(cfg)))
    gdir = tmp / "genomes"
    gdir.mkdir()
    genomes = [random_seq(rng, 12_000, n_prob=0.001) for _ in range(5)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"sp{i}.fa"), [g[:7000], g[7000:]])
    reads = (reads_from_genome(rng, genomes[0], 700, 110)
             + reads_from_genome(rng, genomes[2], 300, 110, err=0.01)
             + reads_from_genome(rng, genomes[4], 120, 110))
    reads[::31] = [r[:20] for r in reads[::31]]
    reads[::43] = [r[:50] + "NN" + r[52:] for r in reads[::43]]
    reads.append("A" * 110)
    quals = ["".join(rng.choice(list("#+5?I"), len(r))) for r in reads]
    fq = str(tmp / "sample.fq")
    write_fastq(fq, reads, quals)
    fq2 = str(tmp / "small.fq")
    write_fastq(fq2, reads_from_genome(rng, genomes[1], 200, 90))
    return {"tmp": tmp, "shufs": shufs, "gdir": str(gdir), "fq": fq,
            "fq2": fq2, "genomes": genomes}


def _codes(seq: str) -> np.ndarray:
    t = np.full(256, 255, np.uint8)
    for i, b in enumerate(b"ACGT"):
        t[b] = i
    return t[np.frombuffer(seq.encode(), np.uint8)]


# ---------------------------------------------------------------------------
# the bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [L3K11, K8S5L2])
def test_sketch_cpu_matches_golden(data, cfg):
    """Sorted, the drtuples of ``sketch_cpu`` (OpenMP default threads and
    one thread) are golden's and the JAX binding's, bit for bit."""
    shuf = read_shuf(data["shufs"][cfg])
    rng = np.random.default_rng(cfg[0])
    codes = rng.integers(0, 4, size=400_000).astype(np.uint8)
    codes[rng.random(codes.size) < 0.001] = 255
    codes = np.concatenate([codes, [255], _codes(data["genomes"][3])])
    want = np.sort(jax_golden.window_drtuples(codes, shuf))
    assert want.size > 50
    for nt in (0, 1):
        got = native.sketch_cpu(codes, shuf, nthreads=nt)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(np.sort(got), want)
    np.testing.assert_array_equal(
        np.sort(jax_native.sketch_cpu(codes, shuf)), want)
    assert native.sketch_cpu(codes[:5], shuf).size == 0


@pytest.mark.parametrize("cfg", [L3K11, K8S5L2])
@pytest.mark.parametrize("min_qual", [0, 20])
def test_sketch_fastq_matches_golden(data, cfg, min_qual):
    """``sketch_fastq`` of the fastq, sorted, is golden's drtuples of its
    codes (quality-filtered alike) and the JAX binding's."""
    shuf = read_shuf(data["shufs"][cfg])
    codes, _ = jax_seqio.fastq_to_codes(data["fq"], min_qual=min_qual)
    want = np.sort(jax_golden.window_drtuples(codes, shuf))
    got = native.sketch_fastq(data["fq"], shuf, min_qual=min_qual)
    np.testing.assert_array_equal(np.sort(got), want)
    np.testing.assert_array_equal(
        np.sort(jax_native.sketch_fastq(data["fq"], shuf,
                                        min_qual=min_qual)), want)


def test_sketch_fastq_equals_stream_and_sketch_cpu(data):
    """The fused engine gives the multiset of ``stream_fastq`` batches
    (small ones) through ``sketch_cpu``; an unreadable path is an
    OSError."""
    shuf = read_shuf(data["shufs"][L3K11])
    parts = [native.sketch_cpu(c, shuf) for c, _ in
             native.stream_fastq(data["fq"], 0, 5000, copy=False)]
    assert len(parts) > 2
    np.testing.assert_array_equal(
        np.sort(native.sketch_fastq(data["fq"], shuf, nthreads=2)),
        np.sort(np.concatenate(parts)))
    with pytest.raises(OSError):
        native.sketch_fastq(str(data["tmp"] / "missing.fq"), shuf)


@pytest.mark.parametrize("n,hi", [((1 << 20) + 77, 1 << 32),
                                  ((1 << 20) + 5, 5000), (1000, 300)])
def test_radix_unique_matches_np_unique(n, hi):
    """``host_unique`` (the radix sort from 2^20 ids, np.unique below) is
    np.unique with and without counts; ``radix_sort_u32`` sorts in place
    and refuses other dtypes."""
    rng = np.random.default_rng(n)
    ids = rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)
    vals, counts = setops.host_unique(ids, True)
    wv, wc = np.unique(ids, return_counts=True)
    np.testing.assert_array_equal(vals, wv)
    np.testing.assert_array_equal(counts, wc)
    np.testing.assert_array_equal(setops.host_unique(ids, False), wv)
    sk = ids.copy()
    native.radix_sort_u32(sk)
    np.testing.assert_array_equal(sk, np.sort(ids))
    with pytest.raises(ValueError):
        native.radix_sort_u32(ids.astype(np.int64))
    with pytest.raises(ValueError):
        native.radix_sort_u32(ids[::2])


def test_radix_unique_keeps_wide_ids_apart():
    """The 32-bit guard: 2^20 64-bit ids that share their low 32 bits
    stay distinct (np.unique), as the JAX package keeps them."""
    low = np.arange(1 << 19, dtype=np.uint64)
    ids = np.concatenate([low, low + (np.uint64(1) << np.uint64(32))])
    vals, counts = setops.host_unique(ids, True)
    assert vals.dtype == np.uint64 and vals.size == ids.size
    assert (counts == 1).all()


@pytest.mark.parametrize("with_ab", [True, False])
def test_postings_expand_matches_numpy(with_ab):
    """The expansion of matched rows (repeated, empty and unsorted rows
    included) equals the numpy expansion and the JAX binding's."""
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 9, size=500)
    lens[::17] = 0
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    gids = rng.integers(0, 1000, size=int(starts[-1])).astype(np.int32)
    rows = rng.integers(0, 500, size=300).astype(np.int64)
    ab = rng.integers(1, 60000, size=300).astype(np.uint16) if with_ab \
        else None
    rl = starts[rows + 1] - starts[rows]
    total = int(rl.sum())
    flat = np.concatenate([np.arange(starts[r], starts[r + 1])
                           for r in rows]).astype(np.int64)
    g, a = native.postings_expand(rows, starts, gids, ab, total)
    np.testing.assert_array_equal(g, gids[flat])
    jg, ja = jax_native.postings_expand(rows, starts, gids, ab, total)
    np.testing.assert_array_equal(g, jg)
    if with_ab:
        np.testing.assert_array_equal(a, np.repeat(ab, rl))
        np.testing.assert_array_equal(a, ja)
    else:
        assert a is None and ja is None


def test_serial_build_gives_the_same_results(data, tmp_path, monkeypatch):
    """The build without ``-fopenmp`` (the card's host's) compiles, binds
    and gives the OpenMP build's results for every engine entry point."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    so = native._compile(native._SERIAL_CXXFLAGS)
    assert so and so.startswith(str(tmp_path))
    serial = native._bind(ctypes.CDLL(so))
    shuf = read_shuf(data["shufs"][L3K11])
    codes = _codes(data["genomes"][1])
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1 << 32, size=(1 << 20) + 3,
                       dtype=np.uint64).astype(np.uint32)
    starts = np.arange(0, 4001, 4, dtype=np.int64)
    gids = rng.integers(0, 50, size=4000).astype(np.int32)
    rows = rng.integers(0, 1000, size=700).astype(np.int64)
    ab = rng.integers(0, 9, size=700).astype(np.uint16)

    def run():
        sk = ids.copy()
        native.radix_sort_u32(sk)
        return (np.sort(native.sketch_cpu(codes, shuf, nthreads=4)),
                np.sort(native.sketch_fastq(data["fq"], shuf, nthreads=4)),
                sk, *native.postings_expand(rows, starts, gids, ab, 2800))
    want = run()
    monkeypatch.setattr(native, "_lib", serial)
    got = run()
    assert want[0].size and want[1].size
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the verbs: --device host against the JAX CLI's host routes and --device cpu
# ---------------------------------------------------------------------------

def _jax(argv: list, monkeypatch) -> str:
    """stdout of ``metakssd_tpu.cli`` under MKSSD_BACKEND=cpu."""
    monkeypatch.setenv("MKSSD_BACKEND", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli.main(argv) == 0
    monkeypatch.delenv("MKSSD_BACKEND")
    return buf.getvalue()


def _port(argv: list, device: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([*argv, "--device", device]) == 0
    return buf.getvalue()


ENGINE = ("sketch_cpu", "sketch_fastq", "radix_sort_u32",
          "postings_expand", "host_membership")


def _count_engine(monkeypatch) -> collections.Counter:
    """Counts the calls of the host engine's entry points."""
    calls = collections.Counter()

    def counted(name, real):
        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return f
    for name in ENGINE[:4]:
        monkeypatch.setattr(native, name, counted(name, getattr(native,
                                                                name)))
    for mod in (merge, composite):
        monkeypatch.setattr(mod, "host_membership", counted(
            "host_membership", merge.host_membership))
    return calls


def _three(tmp, argv_of, monkeypatch):
    """Runs ``argv_of({"o": dir})`` with the JAX CLI (host routes), the
    port on host and the port on cpu, each with its own output dir under
    ``tmp``; returns {run: (stdout, {"o": tree}, engine calls)}."""
    res = {}
    calls = _count_engine(monkeypatch)
    for run in ("jax", "host", "cpu"):
        d = str(tmp / f"{run}_o")
        calls.clear()
        out = _jax(argv_of({"o": d}), monkeypatch) if run == "jax" \
            else _port(argv_of({"o": d}), run)
        res[run] = (out, {"o": _tree(d)} if os.path.isdir(d) else {},
                    dict(calls))
    return res


def _all_equal(res, *engine) -> None:
    """The three runs wrote the same files and stdout; the host run called
    each of the ``engine`` entry points and the cpu run none."""
    want = res["jax"]
    assert want[1] and all(want[1].values()), "nothing written"
    for run in ("host", "cpu"):
        assert res[run][0] == want[0], f"{run} stdout"
        assert sorted(res[run][1]) == sorted(want[1])
        for o, tree in want[1].items():
            got = res[run][1][o]
            assert sorted(got) == sorted(tree), (run, o)
            for f in tree:
                assert got[f] == tree[f], (run, o, f)
    assert all(res["host"][2].get(name, 0) > 0 for name in engine), \
        res["host"][2]
    assert not res["cpu"][2], res["cpu"][2]


@pytest.mark.parametrize("cfg", [K8S5L2, L3K11])
@pytest.mark.parametrize("flags", [[], ["-u"], ["-p", "1"]])
def test_dist_genome_dir(data, tmp_path, monkeypatch, cfg, flags):
    """Stage I of several fasta files: the per-file engine in the -p
    pool."""
    res = _three(tmp_path, lambda d: [
        "dist", "-L", data["shufs"][cfg], *flags, "-o", d["o"],
        data["gdir"]], monkeypatch)
    _all_equal(res, "sketch_cpu")


@pytest.mark.parametrize("flags", [[], ["-A"], ["-n", "2"], ["-Q", "53"],
                                   ["--ckpt"], ["-A", "--ckpt"]])
def test_dist_fastq(data, tmp_path, monkeypatch, flags):
    """Stage I of one fastq: the fused engine, or with --ckpt the batch
    loop through sketch_cpu."""
    res = _three(tmp_path, lambda d: [
        "dist", "-L", data["shufs"][L3K11], *flags, "-o", d["o"],
        data["fq"]], monkeypatch)
    _all_equal(res, "sketch_cpu" if "--ckpt" in flags else "sketch_fastq")
    if "--ckpt" not in flags:
        assert "sketch_cpu" not in res["host"][2]


def test_dist_fastqs_and_genomes(data, tmp_path, monkeypatch):
    """Stage I of two fastqs with -A (batched koc) and of fastq and fasta
    files together."""
    for files in ([data["fq"], data["fq2"]],
                  [data["fq2"], os.path.join(data["gdir"], "sp1.fa")]):
        res = _three(tmp_path / str(len(os.listdir(tmp_path))), lambda d: [
            "dist", "-L", data["shufs"][K8S5L2], "-A", "-o", d["o"],
            *files], monkeypatch)
        _all_equal(res, "sketch_cpu")


@pytest.fixture(scope="module")
def sketches(data):
    """The genomes' sketch dir (a MarkerDB) and the sample's -A sketch at
    K8S5L2, by the JAX package."""
    tmp = data["tmp"]
    db, qry = str(tmp / "db"), str(tmp / "qry")
    shufp = data["shufs"][K8S5L2]
    assert jax_cli.main(["dist", "-L", shufp, "-o", db, data["gdir"]]) == 0
    assert jax_cli.main(["dist", "-L", shufp, "-A", "-o", qry,
                         data["fq"], data["fq2"]]) == 0
    taxf = str(tmp / "tax.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{1 + i // 2}\ttaxon{i // 2}\n" for i in range(5))
    return {"db": db, "qry": qry, "shuf": shufp, "tax": taxf}


def _db_copy(sketches, tmp, name) -> str:
    """A copy of the MarkerDB per run: staging writes sidecars into it."""
    d = str(tmp / name)
    if not os.path.exists(d):
        shutil.copytree(sketches["db"], d)
    return d


def test_profile(data, sketches, tmp_path, monkeypatch):
    """profile of the fastq against the MarkerDB: sketch, match, stats
    and Poisson files, byte for byte."""
    res = _three(tmp_path, lambda d: [
        "profile", "-L", sketches["shuf"], "-r",
        _db_copy(sketches, tmp_path, os.path.basename(d["o"]) + "_db"),
        "-o", d["o"], data["fq"]], monkeypatch)
    _all_equal(res, "sketch_fastq", "host_membership", "postings_expand")


@pytest.mark.parametrize("flags", [[], ["-b"]])
def test_composite_query(sketches, tmp_path, monkeypatch, flags):
    """composite -q [-b]: the host match (np.searchsorted, the native
    expansion and statistics) prints the JAX CLI's lines."""
    def argv(d):
        db = _db_copy(sketches, tmp_path, os.path.basename(d["o"]) + "_db")
        return ["composite", "-r", db, "-q", sketches["qry"], *flags,
                *(["-o", d["o"]] if flags else [])]
    res = _three(tmp_path, argv, monkeypatch)
    if not flags:
        for r in res.values():
            r[1]["o"] = {"stdout": r[0].encode()}
        assert res["jax"][0].count("\n") >= 3
    _all_equal(res, "host_membership", "postings_expand")


@pytest.mark.parametrize("flags", [[], ["-M", "1", "-N", "2"]])
def test_dist_search(data, sketches, tmp_path, monkeypatch, flags):
    """dist -r: the host membership writes the JAX CLI's distance.out."""
    res = _three(tmp_path, lambda d: [
        "dist", "-r", sketches["db"], *flags, "-o", d["o"],
        sketches["qry"]], monkeypatch)
    _all_equal(res, "host_membership")


def test_set_verbs(sketches, tmp_path, monkeypatch):
    """set -g -> -q -> -i, then -u and -s, of the genomes' sketch dir."""
    def argv(verb):
        def f(d):
            src = {"-g": ["-g", sketches["tax"], "-o", d["o"],
                          sketches["db"]],
                   "-u": ["-u", "-o", d["o"], sketches["db"]]}[verb]
            return ["set", *src]
        return f
    for verb in ("-g", "-u"):
        _all_equal(_three(tmp_path / verb, argv(verb), monkeypatch))
    pans = str(tmp_path / "-g" / "jax_o")
    _all_equal(_three(tmp_path / "q", lambda d: [
        "set", "-q", "-o", d["o"], pans], monkeypatch))
    uq = str(tmp_path / "q" / "jax_o")
    for verb in ("-i", "-s"):
        _all_equal(_three(tmp_path / verb, lambda d: [
            "set", verb, uq, "-o", d["o"], pans], monkeypatch),
            "host_membership")


def test_set_unions_past_the_radix_floor(data, tmp_path, monkeypatch):
    """set -u and -q of a sketch dir of 2^20 ids and more in one
    component: both packages' host routes take the radix sort."""
    rng = np.random.default_rng(13)
    p = read_shuf(data["shufs"][K8S5L2]).params
    per_genome, n = [], 0
    for g in range(6):
        ids = np.unique(rng.integers(0, 1 << 24, size=200_000,
                                     dtype=np.uint64).astype(np.uint32))
        per_genome.append([(ids, None)])
        n += ids.size
    assert n >= setops.HOST_RADIX_MIN
    ctx = np.array([g[0][0].size for g in per_genome], np.uint32)
    co = str(tmp_path / "co")
    write_codir(co, CoStat(p.shuf_id, False, 2 * p.k, 2 * p.drlevel, 1,
                           int(ctx.sum()), ctx,
                           [f"g{i}" for i in range(6)]), per_genome)
    for verb in ("-u", "-q"):
        _all_equal(_three(tmp_path / verb, lambda d: [
            "set", verb, "-o", d["o"], co], monkeypatch), "radix_sort_u32")


@pytest.fixture(scope="module")
def abv_db(tmp_path_factory):
    """80 abundance vectors over 120 species and their index."""
    ref = tmp_path_factory.mktemp("host_abv")
    rng = np.random.default_rng(17)
    vdir = ref / "abundance_Vec"
    vdir.mkdir()
    for s in range(80):
        d = np.sort(rng.choice(120, int(rng.integers(4, 30)), replace=False))
        pct = rng.random(d.size)
        write_abv_file(str(vdir / f"s{s}.abv"), d.astype(np.int32),
                       (pct / pct.sum() * 100).astype(np.float32))
    CoStat(1, False, 16, 4, 1, 0, np.zeros(120, np.uint32),
           [f"sp{i}" for i in range(120)]).write(str(ref))
    assert jax_cli.main(["composite", "-r", str(ref), "-i"]) == 0
    return str(ref)


def _blocks(text: str) -> list:
    out = []
    for blk in text.split("#Sample\t")[1:]:
        lines = blk.splitlines()
        out.append((lines[0], {ln.split("\t")[0]: float(ln.split("\t")[1])
                               for ln in lines[1:]}))
    return out


@pytest.mark.parametrize("dense", [False, True])
def test_composite_search(abv_db, monkeypatch, dense):
    """composite -s 2 (sparse: host work on every device) and -s 2
    --dense (torch on the CPU): host prints what cpu prints; the sparse
    text is the JAX CLI's, the dense one reports the JAX dense search's
    samples within 2e-3 (a query's L2 to itself excepted)."""
    qs = [f"s{i}.abv" for i in range(0, 80, 9)]
    argv = ["composite", "-r", abv_db, "-s", "2",
            *(["--dense"] if dense else []), *qs]
    want = _jax(argv, monkeypatch)
    host, cpu = _port(argv, "host"), _port(argv, "cpu")
    assert host == cpu and host.count("#Sample") == len(qs)
    if not dense:
        assert host == want
        return
    for q, (hg, g), (hw, w) in zip(qs, _blocks(host), _blocks(want)):
        assert hg == hw and set(g) == set(w)
        for name in g:
            if name != q:
                assert abs(g[name] - w[name]) < TOL, (q, name)


# ---------------------------------------------------------------------------
# routes without a host engine, CUDA, and a missing library
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--byread"], ["--mesh", "2"], ["--mesh", "2", "-A"]])
def test_routes_without_engine_run_as_cpu(data, tmp_path, monkeypatch,
                                          argv):
    """--byread and --mesh run on host exactly as on cpu, without the
    engine."""
    src = data["fq"] if "-A" in argv or "--byread" in argv \
        else data["gdir"]
    outs = {}
    calls = _count_engine(monkeypatch)
    for dev in ("host", "cpu"):
        o = str(tmp_path / dev)
        _port(["dist", "-L", data["shufs"][L3K11], *argv, "-o", o, src], dev)
        outs[dev] = _tree(o)
    assert outs["host"] == outs["cpu"] and outs["host"] and not calls


def test_shard_db_runs_as_cpu(data, sketches, tmp_path, monkeypatch):
    """--shard-db N (composite -q, profile, dist -r) runs on host exactly
    as on cpu, through the db shards and not the host engine's match."""
    calls = _count_engine(monkeypatch)
    outs = {}
    for dev in ("host", "cpu"):
        db = _db_copy(sketches, tmp_path, f"db_{dev}")
        o = lambda name: str(tmp_path / f"{dev}_{name}")   # noqa: E731
        text = _port(["composite", "-r", db, "-q", sketches["qry"],
                      "--shard-db", "2"], dev)
        _port(["profile", "-L", sketches["shuf"], "-r", db, "--shard-db",
               "1", "-o", o("p"), data["fq"]], dev)
        _port(["dist", "-r", sketches["db"], "--shard-db", "2", "-o",
               o("r"), sketches["qry"]], dev)
        outs[dev] = (text, _tree(o("p")), _tree(o("r")))
    assert outs["host"] == outs["cpu"] and outs["host"][0].count("\n") >= 3
    assert set(calls) <= {"sketch_fastq"}      # profile's stage I only


def test_wide_config_runs_as_cpu(data, tmp_path, monkeypatch):
    """k - drlevel > 8: golden on host, as on cpu, and the JAX CLI's
    files."""
    for src in (data["gdir"], data["fq"]):
        res = _three(tmp_path / str(len(os.listdir(tmp_path))),
                     lambda d: ["dist", "-L", data["shufs"][WIDE], "-o",
                                d["o"], src], monkeypatch)
        _all_equal(res)
        assert not res["host"][2]


def test_host_never_initialises_cuda(data, sketches, tmp_path,
                                     monkeypatch):
    """Every verb on host with CUDA's initialisation and its device
    queries made to fail: all run, and CUDA stays uninitialised."""
    def no_cuda(*a, **kw):
        raise AssertionError("--device host touched CUDA")
    for name in ("_lazy_init", "is_available", "device_count",
                 "current_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    db = _db_copy(sketches, tmp_path, "db")
    o = lambda name: str(tmp_path / name)   # noqa: E731
    for argv in (
            ["dist", "-L", sketches["shuf"], "-o", o("g"), data["gdir"]],
            ["dist", "-L", sketches["shuf"], "-A", "-o", o("f"), data["fq"]],
            ["profile", "-L", sketches["shuf"], "-r", db, "-o", o("p"),
             data["fq"]],
            ["composite", "-r", db, "-q", sketches["qry"]],
            ["dist", "-r", sketches["db"], "-o", o("r"), sketches["qry"]],
            ["set", "-u", "-o", o("u"), sketches["db"]],
            ["set", "-g", sketches["tax"], "-o", o("pan"), sketches["db"]],
            ["set", "-q", "-o", o("uq"), o("pan")]):
        _port(argv, "host")
    assert not torch.cuda.is_initialized()


def test_missing_library_raises(data, sketches, tmp_path, monkeypatch):
    """Without the host library every host verb and engine call raises
    (no plain version runs in its place), while --device cpu still
    runs."""
    monkeypatch.setattr(native, "_load", lambda: None)
    shuf = read_shuf(sketches["shuf"])
    for call in (lambda: native.sketch_cpu(np.zeros(40, np.uint8), shuf),
                 lambda: native.sketch_fastq(data["fq"], shuf),
                 lambda: native.radix_sort_u32(np.zeros(4, np.uint32)),
                 lambda: native.postings_expand(
                     np.zeros(0, np.int64), np.zeros(1, np.int64),
                     np.zeros(0, np.int32), None, 0)):
        with pytest.raises(RuntimeError, match="host library"):
            call()
    o = lambda name: str(tmp_path / name)   # noqa: E731
    for argv in (
            ["dist", "-L", sketches["shuf"], "-o", o("g"), data["gdir"]],
            ["dist", "-L", sketches["shuf"], "-o", o("b"), "--byread",
             data["fq2"]],
            ["composite", "-r", sketches["db"], "-q", sketches["qry"]],
            ["dist", "-r", sketches["db"], "-o", o("r"), sketches["qry"]],
            ["set", "-u", "-o", o("u"), sketches["db"]],
            ["set", "-g", sketches["tax"], "-o", o("pan"), sketches["db"]]):
        with pytest.raises(RuntimeError, match="host library"):
            _port(argv, "host")
    _port(["dist", "-L", sketches["shuf"], "-o", o("c"), data["fq2"]], "cpu")
    assert os.path.exists(os.path.join(o("c"), "cofiles.stat"))


@pytest.mark.parametrize("name,cfg,want", [
    ("host", None, True), ("host", K8S5L2, True), ("host", L3K11, True),
    ("host", WIDE, False), ("cpu", L3K11, False), ("cuda", None, False),
    (torch.device("cpu"), None, False), (None, None, False)],
    ids=["host", "host-K8S5L2", "host-L3K11", "host-wide", "cpu", "cuda",
         "torch-cpu", "none"])
def test_engine_is_the_one_rule(data, monkeypatch, name, cfg, want):
    """``device.engine``, which every route asks: the host engine takes
    ``"host"`` alone, and a sketch only where k - drlevel <= 8; its torch
    device is the CPU; without the host library only ``"host"`` raises."""
    shuf = None if cfg is None else read_shuf(data["shufs"][cfg])
    assert device.engine(name, shuf) is want
    if name == "host":
        assert device.resolve_device(name) == torch.device("cpu")
    monkeypatch.setattr(native, "_load", lambda: None)
    if name == "host":
        with pytest.raises(RuntimeError, match="host library"):
            device.engine(name, shuf)
        with pytest.raises(RuntimeError, match="host library"):
            device.resolve_device(name)
    else:
        assert device.engine(name, shuf) is False
