"""The port's copies of the on-disk formats against the JAX package's.

For each format (``.shuf``, ``cofiles.stat``, a sketch dir, an mco dir,
``.abv`` files and the abv index), the same arrays, made from a seed with
numpy, are written by both packages: the files must be byte-identical,
and each package must read the other's files back to the same arrays.
"""

import dataclasses
import os

import numpy as np
import pytest

from metakssd_tpu.formats import abv as jax_abv
from metakssd_tpu.formats import codir as jax_codir
from metakssd_tpu.formats import costat as jax_costat
from metakssd_tpu.formats import mco as jax_mco
from metakssd_tpu.formats import shuf as jax_shuf
from metakssd_tpu import params as jax_params

from metakssd_tpu_torch.formats import abv, codir, costat, mco, shuf
from metakssd_tpu_torch import params

JAX = dict(abv=jax_abv, codir=jax_codir, costat=jax_costat, mco=jax_mco,
           shuf=jax_shuf, params=jax_params)
PORT = dict(abv=abv, codir=codir, costat=costat, mco=mco, shuf=shuf,
            params=params)

NGENOMES, NCOMP = 3, 2


def _stat(pkg, koc=True):
    rng = np.random.default_rng(5)
    ctx = rng.integers(0, 500, NGENOMES).astype(np.uint32)
    return pkg["costat"].CoStat(
        shuf_id=7, koc=koc, kmerlen=16, dim_rd_len=4, comp_num=NCOMP,
        all_ctx_ct=int(ctx.sum()), ctx_ct=ctx,
        names=[f"genomes/g{i}.fa" for i in range(NGENOMES)])


def _per_genome():
    rng = np.random.default_rng(6)
    out = []
    for _ in range(NGENOMES):
        comps = []
        for _ in range(NCOMP):
            ids = np.unique(rng.integers(0, 1 << 16, 300)).astype(np.uint32)
            comps.append((ids, rng.integers(1, 9, ids.size)
                          .astype(np.uint16)))
        out.append(comps)
    return out


def _write(pkg, kind: str, d: str) -> None:
    if kind == "shuf":
        p = pkg["params"].SketchParams(k=8, subk=5, drlevel=2)
        pkg["shuf"].write_shuf(os.path.join(d, "x.shuf"),
                               pkg["shuf"].make_shuf(p, seed=3))
    elif kind == "costat":
        _stat(pkg).write(d)
    elif kind in ("codir", "mco"):
        co = os.path.join(d, "co")
        pkg["codir"].write_codir(co, _stat(pkg), _per_genome())
        if kind == "mco":
            pkg["mco"].build_mco(co, os.path.join(d, "mco"),
                                 component_sz=4)
    else:
        rng = np.random.default_rng(8)
        idx = rng.integers(0, 40, 25).astype(np.int32)
        pct = rng.random(25).astype(np.float32) * 100
        pkg["abv"].write_abv_file(os.path.join(d, "x.abv"), idx, pct)
        order = np.argsort(idx, kind="stable")
        pkg["abv"].AbvIndex(
            names=["a.abv", "b.abv"], y_l2n=rng.random(2),
            abmi=np.cumsum(np.bincount(idx, minlength=40)).astype(np.int32),
            abm_idx=(order % 2).astype(np.int32),
            abm_pct=pct[order]).write(d)


def _read(pkg, kind: str, d: str) -> list:
    """Every value a reader returns, as plain values and numpy arrays."""
    if kind == "shuf":
        s = pkg["shuf"].read_shuf(os.path.join(d, "x.shuf"))
        return [dataclasses.astuple(s.params), s.shuffled_dim,
                *s.accept_table()]
    if kind == "costat":
        return list(dataclasses.astuple(pkg["costat"].CoStat.read(d)))
    if kind == "codir":
        cd = pkg["codir"].CoDir.read(os.path.join(d, "co"))
        return [dataclasses.astuple(cd.stat), *cd.ids, *cd.index,
                *cd.abund]
    if kind == "mco":
        # as dist search reads an mco dir: its stat, then each component's
        # cumulative row index and genome rows, memory-mapped
        m = os.path.join(d, "mco")
        mm = pkg["codir"]._mmap_or_empty
        out = [dataclasses.astuple(pkg["costat"].McoStat.read(m))]
        for c in range(NCOMP):
            out += [np.asarray(mm(os.path.join(m, f"mco.index.{c}"),
                                  np.uint64)),
                    np.asarray(mm(os.path.join(m, f"mco.{c}"), np.uint32))]
        return out
    idx, pct = pkg["abv"].read_abv_file(os.path.join(d, "x.abv"))
    return [idx, pct, *dataclasses.astuple(pkg["abv"].AbvIndex.read(d))]


def _files(d: str) -> dict:
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def _assert_same(a, b) -> None:
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["shuf", "costat", "codir", "mco", "abv"])
def test_format_round_trip(kind, tmp_path):
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(dj)
    os.makedirs(dp)
    _write(JAX, kind, dj)
    _write(PORT, kind, dp)
    fj, fp = _files(dj), _files(dp)
    assert fj and fj.keys() == fp.keys()
    for name in fj:
        assert fj[name] == fp[name], name
    want = _read(JAX, kind, dj)
    _assert_same(_read(PORT, kind, dj), want)
    _assert_same(_read(JAX, kind, dp), want)
    _assert_same(_read(PORT, kind, dp), want)
