"""The port's shards (``metakssd_tpu_torch/parallel/mesh.py``) on the card
against the same shards on the CPU: ``sharded_sketch`` over N data shards
(K1 on each, K2 where a chunk overflows), ``ShardedMatchIndex`` and
``sharded_shared_counts`` over N db shards (K3 on each), and
``device_union`` over N data shards.  Then the NCCL route: a child process
joins a one-rank NCCL group and round-trips the collectives on CUDA
tensors (``probes/collectives_check``), and another runs
``sharded_shared_counts`` and ``device_union`` there, equal to the CPU's;
with two or more cards, two ranks of one card each do the same, run
``dist --mesh 4``, ``dist -r --shard-db 4`` and ``set -u`` byte-identical
to one process, and ``make_mesh`` deals shards over the cards.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_mesh_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from metakssd_tpu_torch.formats.codir import write_codir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import _build, sketch
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.parallel import mesh
from ranks import ROOT, free_port, run_ranks

pytestmark = pytest.mark.cuda

ALL_ONES = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cfg", [(11, 6, 3), (8, 5, 2)])
def test_sharded_sketch_cuda_matches_cpu(cuda, n, cfg):
    """N shards of a 2M-window stream with a poly-A block, at a capacity
    of 16 kept windows a chunk, so chunks overflow into K2: the one-device
    sketch on the CPU; K1 launches for every shard's chunk."""
    rng = np.random.default_rng(31)
    shuf = make_shuf(SketchParams(*cfg), seed=32)
    codes = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    codes[rng.integers(0, codes.size, 1000)] = 255
    codes[700_000:760_000] = 0
    kw = {"chunk_windows": 1 << 18, "capacity": 16}
    _build.reset_launches()
    got = mesh.sharded_sketch(codes, shuf, mesh.make_mesh(n, 1, cuda), **kw)
    launches = dict(_build.LAUNCHES)
    want = sketch.sketch_codes(codes, shuf, "cpu")
    np.testing.assert_array_equal(got, want)
    assert launches["sketch_compact"] >= n
    assert launches["sketch_full"] >= 1


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_match_index_cuda_matches_cpu(cuda, n):
    """N db slices on the card: the CPU's answer (0xFFFFFFFF matched,
    keys >= 2^31), one K3 launch and one index build per slice."""
    rng = np.random.default_rng(41)
    rk = np.unique(_u32(rng, 0, 1 << 32, 200_000))
    rk[-1] = ALL_ONES
    lens = rng.integers(1, 5, rk.size)
    starts = np.zeros(rk.size + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    gid = rng.integers(0, 300, int(starts[-1])).astype(np.int32)
    q = np.unique(np.concatenate([rng.choice(rk, 6000),
                                  _u32(rng, 0, 1 << 32, 6000),
                                  np.array([ALL_ONES], np.uint32)]))
    ab = rng.integers(1, 1000, q.size).astype(np.uint16)
    _build.reset_launches()
    ix = mesh.ShardedMatchIndex(rk, starts, gid, mesh.make_mesh(1, n, cuda))
    got = ix.match(q, ab)
    launches = dict(_build.LAUNCHES)
    want = mesh.ShardedMatchIndex(rk, starts, gid, "cpu").match(q, ab)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert launches["member"] == n and launches["member_index"] == n
    last = gid[starts[-2]:starts[-1]]        # the rows of 0xFFFFFFFF
    assert np.isin(last, got[0][got[1] == ab[-1]]).all()


def _codir(path, rows, koc=False):
    ctx = np.array([sum(x.size for x, _ in g) for g in rows], np.uint32)
    write_codir(path, CoStat(9, koc, 16, 4, len(rows[0]), int(ctx.sum()),
                             ctx, [f"g{i}" for i in range(len(rows))]), rows)


def test_sharded_shared_counts_cuda_matches_cpu(cuda, tmp_path):
    """4 db shards and 2 x 2 shards on the card: the counts of one shard
    on the CPU (duplicated query k-mers, keys >= 2^31); K3 runs."""
    rng = np.random.default_rng(51)
    pool = np.unique(_u32(rng, 0, 1 << 32, 40_000))
    ref = [[(np.unique(rng.choice(pool, 3000)), None) for _ in range(2)]
           for _ in range(30)]
    qry = [[(np.sort(np.concatenate([x, x[::3]])), None)
            for x in (rng.choice(pool, 2000), rng.choice(pool, 500))]
           for _ in range(5)]
    _codir(str(tmp_path / "ref"), ref)
    _codir(str(tmp_path / "qry"), qry)
    want = mesh.sharded_shared_counts(str(tmp_path / "ref"),
                                      str(tmp_path / "qry"), "cpu")
    assert want.max() > 0
    for layout in ((1, 4), (2, 2)):
        _build.reset_launches()
        got = mesh.sharded_shared_counts(str(tmp_path / "ref"),
                                         str(tmp_path / "qry"),
                                         mesh.make_mesh(*layout, cuda))
        np.testing.assert_array_equal(got, want)
        assert _build.LAUNCHES["member"] > 0


def test_device_union_cuda_over_shards(cuda):
    """Two data shards on the card: np.unique's values and counts."""
    rng = np.random.default_rng(61)
    ids = np.concatenate([_u32(rng, 0, 1 << 32, 300_000),
                          _u32(rng, 0, 5000, 100_000),
                          np.full(3, ALL_ONES, np.uint32)])
    v, c = mesh.device_union(ids, mesh.make_mesh(2, 1, cuda),
                             return_counts=True)
    wv, wc = np.unique(ids, return_counts=True)
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_array_equal(c, wc)


# ---------------------------------------------------------------------------
# the NCCL route
# ---------------------------------------------------------------------------

JOB_TIMEOUT = 300                 # seconds a process of a job may take


def _ranks_run(argv: list, nprocs: int, env=None) -> list[str]:
    """``python argv`` once per rank, joined; every rank must exit 0;
    returns their outputs."""
    port = free_port()
    procs = []
    for r in range(nprocs):
        e = dict(os.environ if env is None else env,
                 MKSSD_COORDINATOR=f"127.0.0.1:{port}",
                 MKSSD_NPROCS=str(nprocs), MKSSD_PROCID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=JOB_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, {torch.cuda.device_count()} "
                    "visible: NCCL takes one rank a card")


def test_one_rank_nccl_collectives(cuda):
    """A one-rank NCCL group on the card: the gather and the sum of CUDA
    tensors of 0, 1 and 2^24 + 3 elements (uint8 to uint64) give the
    input back, over NCCL, equal to the numpy forms over gloo."""
    out, = _ranks_run(["-m", "metakssd_tpu_torch.probes.collectives_check",
                       "--device", "cuda", "--sizes", "0,1,16777219"], 1)
    assert "collectives ok rank 0 nccl (1 rank, 1 card)" in out, out


_MERGES = (
    "import sys, numpy as np\n"
    "from metakssd_tpu_torch.parallel import mesh\n"
    "d = sys.argv[1]\n"
    "assert mesh.init_distributed(device='cuda')\n"
    "assert mesh.collectives_backend().startswith('nccl'), "
    "mesh.collectives_backend()\n"
    "n, r = mesh.world()\n"
    "got = mesh.sharded_shared_counts(d + '/ref', d + '/qry', "
    "mesh.make_mesh(2 * n, 2, 'cuda'))\n"
    "assert np.array_equal(got, np.load(d + '/counts.npy'))\n"
    "ids = np.load(d + '/ids.npy')\n"
    "v, c = mesh.device_union(ids, mesh.make_mesh(None, 1, 'cuda'), "
    "return_counts=True)\n"
    "wv, wc = np.unique(ids, return_counts=True)\n"
    "assert np.array_equal(v, wv) and np.array_equal(c, wc)\n"
    "assert mesh.COLLECTIVES['nccl_calls'] >= 3, mesh.COLLECTIVES\n"
    "mesh.leave_distributed(True)\n"
    "print('merges ok', r)\n")


@pytest.mark.parametrize("nprocs", [1, 2])
def test_nccl_merges_match_cpu(cuda, tmp_path, nprocs):
    """``sharded_shared_counts`` (2 data x 2 db shards a rank) and
    ``device_union`` in a joined job on the cards: the CPU's counts and
    np.unique's values and counts, their merges over NCCL."""
    if nprocs > 1:
        _two_cards()
    rng = np.random.default_rng(71)
    pool = np.unique(_u32(rng, 0, 1 << 32, 40_000))
    ref = [[(np.unique(rng.choice(pool, 3000)), None) for _ in range(2)]
           for _ in range(30)]
    qry = [[(np.sort(np.concatenate([x, x[::3]])), None)
            for x in (rng.choice(pool, 2000), rng.choice(pool, 500))]
           for _ in range(5)]
    _codir(str(tmp_path / "ref"), ref)
    _codir(str(tmp_path / "qry"), qry)
    np.save(tmp_path / "counts.npy", mesh.sharded_shared_counts(
        str(tmp_path / "ref"), str(tmp_path / "qry"), "cpu"))
    np.save(tmp_path / "ids.npy", np.concatenate([
        _u32(rng, 0, 1 << 32, 300_000), _u32(rng, 0, 5000, 100_000),
        np.full(3, ALL_ONES, np.uint32)]))
    script = tmp_path / "merges.py"
    script.write_text(_MERGES)
    outs = _ranks_run([str(script), str(tmp_path)], nprocs,
                      env=dict(os.environ, PYTHONPATH=ROOT))
    for r, out in enumerate(outs):
        assert f"merges ok {r}" in out, out


def test_two_rank_nccl_collectives(cuda):
    _two_cards()
    outs = _ranks_run(["-m", "metakssd_tpu_torch.probes.collectives_check",
                       "--device", "cuda", "--sizes", "0,1,1000003"], 2)
    for r, out in enumerate(outs):
        assert f"collectives ok rank {r} nccl (2 ranks, 2 cards)" in out, out


def _files(root: str) -> dict:
    out = {}
    for f in sorted(os.listdir(root)):
        if not f.startswith("."):
            with open(os.path.join(root, f), "rb") as fh:
                out[f] = fh.read()
    return out


def test_two_rank_nccl_cli_matches_one_process(cuda, tmp_path):
    """Two ranks, one card each: ``dist --mesh 4``, ``dist -r --shard-db
    4`` and ``set -u`` write one process's files, their merges over
    NCCL."""
    _two_cards()
    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.formats.shuf import write_shuf
    from metakssd_tpu_torch.probes.collectives_check import read_report
    rng = np.random.default_rng(81)
    gdir = tmp_path / "g"
    gdir.mkdir()
    for i in range(4):
        seq = "".join(rng.choice(list("ACGT"), 50_000))
        (gdir / f"g{i}.fa").write_text(f">g{i}\n{seq}\n")
    shufp = str(tmp_path / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(8, 5, 2), seed=9))
    cu = ["--device", "cuda"]

    def j(name):
        return str(tmp_path / name)
    verbs = {"co": ["dist", "-L", shufp, "--mesh", "4", str(gdir)],
             "dist": ["dist", "-r", j("co_one"), "--shard-db", "4",
                      j("co_one")],
             "set": ["set", "-u", j("co_one")]}
    for name, argv in verbs.items():
        assert cli.main(argv + ["-o", j(f"{name}_one"), *cu]) == 0
    steps = [(argv + ["-o", j(f"{name}_p{{rank}}"), *cu], None)
             for name, argv in verbs.items()]
    logs = j("logs")
    run_ranks(steps, 2, logs, JOB_TIMEOUT,
              env=dict(os.environ, MKSSD_LOG="json"))
    for r in range(2):
        for name in verbs:
            a, b = _files(j(f"{name}_one")), _files(j(f"{name}_p{r}"))
            assert sorted(a) == sorted(b) and a
            for f in a:
                assert a[f] == b[f], f"rank {r}: {name}/{f}"
        for i in range(len(steps)):
            meta = read_report(os.path.join(logs, f"step{i}_rank{r}.log"))[
                "meta"]
            assert meta["collectives"] == "nccl (2 ranks, 2 cards)", meta
            assert meta["collective_counts"]["nccl_calls"] > 0, meta


def test_make_mesh_deals_shards_over_cards(cuda):
    _two_cards()
    n = torch.cuda.device_count()
    m = mesh.make_mesh(2 * n + 1, 1, "cuda")
    assert [s.device for s in m.shards] == \
        [torch.device("cuda", i % n) for i in range(2 * n + 1)]
