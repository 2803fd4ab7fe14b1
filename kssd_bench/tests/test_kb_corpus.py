"""The corpus generator: the same seed gives the same data, and the index
files it writes read back through the program's own reader as the
generated vectors."""

import json

import numpy as np
import pytest

from kssd_bench import abv_corpus
from kb_tiny import SEED, TINY, REPO

from metakssd_tpu_torch.formats.abv import AbvIndex, read_abv_file


# each committed configuration at its tiny size, and one with a species
# pool smaller than the species ids
VARIANTS = {**{name: (name, {}) for name in TINY},
            "pool500": ("abv_mkssd_gtdb_r214_node8", dict(
                species_pool=500, n_samples=400,
                species_per_sample=dict(median=30, sigma=0.7, min=5,
                                        max=200)))}


def _cfg(variant):
    name, upd = VARIANTS[variant]
    cfg = json.loads((REPO / "kssd_bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(TINY[name])
    cfg.update(upd)
    return cfg


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_same_seed_same_data(name):
    a = abv_corpus.make(_cfg(name), 8, SEED)
    b = abv_corpus.make(_cfg(name), 8, SEED)
    c = abv_corpus.make(_cfg(name), 8, SEED + 1)
    for x, y in ((a.db, b.db), (a.queries, b.queries)):
        assert np.array_equal(x.ptr, y.ptr)
        assert np.array_equal(x.species, y.species)
        assert np.array_equal(x.pct, y.pct)
    assert not np.array_equal(a.db.pct[:50], c.db.pct[:50])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_vectors_are_percentages(name):
    cfg = _cfg(name)
    c = abv_corpus.make(cfg, 8, SEED)
    db = c.db
    assert db.n == cfg["n_samples"]
    assert db.pct.dtype == np.float32 and np.all(db.pct > 0)
    sums = np.add.reduceat(db.pct.astype(np.float64), db.ptr[:-1])
    assert np.allclose(sums, 100.0, atol=1e-3)
    for i in range(db.n):      # distinct species, all in the pool
        sp, _ = db.row(i)
        assert np.unique(sp).size == sp.size and sp.size >= 1
    assert np.unique(db.species).size <= cfg["species_pool"]
    assert db.species.max() < cfg["n_species"]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_index_reads_back_through_the_program(tmp_path, name):
    cfg = _cfg(name)
    c = abv_corpus.make(cfg, 4, SEED)
    abv_corpus.write_index(str(tmp_path), c.db, c.names, c.n_species)
    idx = AbvIndex.read(str(tmp_path))
    assert idx.names == c.names
    assert idx.abmi.size == cfg["n_species"]
    dense = np.zeros((c.db.n, c.n_species), np.float32)
    dense[c.db.owner(), c.db.species] = c.db.pct
    starts = np.concatenate([[0], idx.abmi]).astype(np.int64)
    got = np.zeros_like(dense)
    for j in range(c.n_species):
        lo, hi = starts[j], starts[j + 1]
        rows = idx.abm_idx[lo:hi]
        assert np.all(np.diff(rows) > 0)        # sample order
        got[rows, j] = idx.abm_pct[lo:hi]
    assert np.array_equal(got, dense)
    norms = np.sqrt((dense.astype(np.float64) ** 2).sum(1))
    assert np.allclose(idx.y_l2n, norms, rtol=1e-12)
    paths = abv_corpus.write_queries(str(tmp_path / "q"), c.queries)
    for i, p in enumerate(paths):
        sp, pc = read_abv_file(p)
        want_sp, want_pc = c.queries.row(i)
        assert np.array_equal(sp, want_sp) and np.array_equal(pc, want_pc)
