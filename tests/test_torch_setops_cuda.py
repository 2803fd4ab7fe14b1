"""Set algebra and dense abv search on the card against the same code on
the CPU.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_setops_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from metakssd_tpu_torch import cli
from metakssd_tpu_torch.composite import index_abv
from metakssd_tpu_torch.formats.abv import (AbvIndex, read_abv_file,
                                            write_abv_file)
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import make_shuf, write_shuf
from metakssd_tpu_torch.ops import dense_abv, sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.parallel import mesh
from metakssd_tpu_torch.state import dense_abv_from_index

pytestmark = pytest.mark.cuda

ALL_ONES = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(name: str) -> np.ndarray:
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros(0, np.uint32)
    if name == "all_equal":
        return np.full(5000, 77, np.uint32)
    x = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    if name == "dup_heavy":
        x >>= np.uint32(12)
    if name == "all_ones":
        x[::1000] = ALL_ONES
    return x


@pytest.mark.parametrize("name", ["empty", "all_equal", "random",
                                  "dup_heavy", "all_ones"])
def test_device_union_cuda_matches_cpu(cuda, name):
    ids = _ids(name)
    v, c = mesh.device_union(ids, cuda, return_counts=True)
    pv, pc = mesh.device_union(ids, "cpu", return_counts=True)
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(c, pc)
    np.testing.assert_array_equal(mesh.device_union(ids, cuda), pv)
    want_v, want_c = np.unique(ids, return_counts=True)
    np.testing.assert_array_equal(v, want_v)
    np.testing.assert_array_equal(c, want_c)


def _same_dir(a: str, b: str) -> None:
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb and fa
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def _write_fasta(path, codes):
    with open(path, "wb") as f:
        f.write(b">g\n" + np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()
                + b"\n")


@pytest.fixture
def sketch_dir(cuda, tmp_path):
    """Eight genomes in four taxa (two share half their sequence) and a
    taxid-0 genome, sketched on the card at K8S5L2 with 16 components."""
    rng = np.random.default_rng(11)
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    base = rng.integers(0, 4, 400_000)
    for i in range(9):
        g = rng.integers(0, 4, 400_000)
        if i < 4:
            g[:200_000] = base[i * 50_000:i * 50_000 + 200_000]
        _write_fasta(str(gdir / f"g{i}.fa"), g)
    shufp = str(tmp_path / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=12))
    co = str(tmp_path / "co")
    assert cli.main(["dist", "-L", shufp, "--component_sz", "5", "-o", co,
                     "--device", "cuda", str(gdir)]) == 0
    taxf = str(tmp_path / "tax.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{1 + i // 2}\tt{i // 2}\n" for i in range(8))
        f.write("0\n")
    return tmp_path, co, taxf


def test_set_verbs_cuda_match_cpu(sketch_dir, monkeypatch):
    """set -g, -q, -i, -u, -s and -c on the card write the CPU run's
    directories, byte for byte; -i and -s launch K3.  Each device's run
    has a directory of its own and names its outputs relative to it, so
    that the names -c records are the same."""
    tmp, co, taxf = sketch_dir
    out = {}
    for dev in ("cuda", "cpu"):
        (tmp / dev).mkdir()
        monkeypatch.chdir(tmp / dev)
        d = {k: k for k in ("pan", "uq", "mk", "u", "s", "c")}
        sketch_cuda.reset_launches()
        for argv in (["-g", taxf, "-o", d["pan"], co],
                     ["-q", "-o", d["uq"], d["pan"]],
                     ["-i", d["uq"], "-o", d["mk"], d["pan"]],
                     ["-u", "-o", d["u"], co],
                     ["-s", d["uq"], "-o", d["s"], co],
                     ["-c", "-o", d["c"], d["u"], d["uq"]]):
            assert cli.main(["set", *argv, "--device", dev]) == 0, argv
        launches = sketch_cuda.LAUNCHES["member"]
        assert launches == (32 if dev == "cuda" else 0), launches
        out[dev] = {k: str(tmp / dev / v) for k, v in d.items()}
    for k in out["cpu"]:
        _same_dir(out["cuda"][k], out["cpu"][k])
    assert CoStat.read(out["cuda"]["mk"]).infile_num == 4


@pytest.fixture
def abv_db(cuda, tmp_path):
    rng = np.random.default_rng(21)
    nspecies, nsamples = 2000, 400
    vdir = tmp_path / "abundance_Vec"
    vdir.mkdir()
    prev = 1.0 / np.arange(1, nspecies + 1)
    prev /= prev.sum()
    for s in range(nsamples):
        nd = int(rng.integers(30, 600))
        d = np.sort(rng.choice(nspecies, nd, replace=False, p=prev))
        pct = rng.lognormal(0.0, 1.0, nd)
        write_abv_file(str(vdir / f"s{s}.abv"), d.astype(np.int32),
                       (pct / pct.sum() * 100).astype(np.float32))
    CoStat(1, False, 16, 4, 1, 0, np.zeros(nspecies, np.uint32),
           [f"sp{i}" for i in range(nspecies)]).write(str(tmp_path))
    index_abv(str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dense_cuda_matches_cpu(abv_db, mode):
    """The dense DB is the same on both devices; overlap masks are equal
    and measures within 2e-3, a query's L2 to itself excepted (the
    rounding residue of ROADMAP.md section 3)."""
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    names = idx.names[::25]
    q = np.zeros((len(names), nspecies), np.float32)
    for i, n in enumerate(names):
        qi, qp = read_abv_file(os.path.join(abv_db, "abundance_Vec", n))
        q[i, qi] = qp
    dc = dense_abv_from_index(idx, nspecies, "cuda")
    dp = dense_abv_from_index(idx, nspecies, "cpu")
    assert torch.equal(dc.mat.cpu(), dp.mat)
    m, o = dense_abv.abv_search_batch(dc, q, mode=mode)
    pm, po = dense_abv.abv_search_batch(dp, q, mode=mode)
    np.testing.assert_array_equal(o, po)
    check = o.copy()
    if mode == 2:
        for i, n in enumerate(names):
            check[i, idx.names.index(n)] = False
    assert np.abs(m[check] - pm[check]).max() < 2e-3
    if mode == 0:
        assert [idx.names[i] for i in m.argmax(1)] == list(names)
