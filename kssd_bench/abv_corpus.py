"""Abundance-vector corpora made from a seed, and their files.

A configuration (``configs/<name>.json``) describes a population of
samples: ``n_species`` species ids, of which ``species_pool`` occur, with
Zipf-like popularity (weight ``1 / rank ** zipf_s``, ranks dealt over the
pool ids at random); ``species_per_sample`` (median, sigma, min, max) of a
log-normal target count; ``abundance_sigma`` of log-normal abundances.
Each sample holds the distinct species of a number of Zipf draws chosen so
that the expected distinct count is its target, with percentages
normalised to sum to 100 in float32, as ``composite -b`` writes them.
The draws, their dedupe and the abundances' normal deviates are made on
the run's device by a ``torch.Generator`` seeded from ``--seed``, in a few
large calls (the same seed gives the same data on the same kind of
device); the small per-sample draws and the normalisation are NumPy's.

The database files are the reference tool's abv index
(command_composite.c:377-431): ``abundance_Vec.abm`` (per species, its
postings as int32 sample id and float32 percentage, in sample order),
``.abmi`` (int32 cumulative posting counts), ``.name`` (one sample file
name a line) and ``.yl2n`` (float64 L2 norm of each sample).  Queries are
``.abv`` files of the same records.  This module writes them itself and
imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

ABV_DTYPE = np.dtype([("ref_idx", "<i4"), ("pct", "<f4")])
INDEX_BASENAME = "abundance_Vec"


@dataclasses.dataclass
class Vectors:
    """Sparse vectors, sample-major: sample ``i`` holds
    ``species[ptr[i]:ptr[i + 1]]`` with percentages ``pct[...]``."""
    ptr: np.ndarray       # int64 [n + 1]
    species: np.ndarray   # int32 [m]
    pct: np.ndarray       # float32 [m]

    @property
    def n(self) -> int:
        return self.ptr.size - 1

    def counts(self) -> np.ndarray:
        return np.diff(self.ptr)

    def owner(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64), self.counts())

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.ptr[i], self.ptr[i + 1]
        return self.species[lo:hi], self.pct[lo:hi]


@dataclasses.dataclass
class Population:
    """The species pool of a configuration, drawn once per seed."""
    n_species: int
    pool_ids: np.ndarray      # int32 [pool], species id of each rank
    cdf: np.ndarray           # float64 [pool], Zipf over ranks
    draws_grid: np.ndarray    # Zipf draws ...
    distinct_grid: np.ndarray  # ... and their expected distinct count


def population(cfg: dict, rng: np.random.Generator) -> Population:
    n_species = int(cfg["n_species"])
    pool = int(cfg["species_pool"])
    pool_ids = rng.permutation(n_species)[:pool].astype(np.int32)
    w = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** float(cfg["zipf_s"])
    p = w / w.sum()
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    draws = np.unique(np.geomspace(1, 64 * pool, 400).astype(np.int64))
    log1m = np.log1p(-p)
    distinct = np.array([np.sum(-np.expm1(k * log1m)) for k in draws])
    return Population(n_species, pool_ids, cdf, draws, distinct)


def vectors(popn: Population, cfg: dict, n: int, rng: np.random.Generator,
            gen) -> Vectors:
    """``n`` samples of the population; ``gen`` is a ``torch.Generator``
    on the device that makes the bulk draws."""
    import torch
    dev = gen.device
    sps = cfg["species_per_sample"]
    target = np.clip(np.rint(float(sps["median"]) * np.exp(
        float(sps["sigma"]) * rng.standard_normal(n))),
        int(sps["min"]), int(sps["max"]))
    draws = np.ceil(np.interp(target, popn.distinct_grid,
                              popn.draws_grid)).astype(np.int64)
    pool = popn.cdf.size
    owner = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev),
        torch.from_numpy(draws).to(dev))
    u = torch.rand(owner.numel(), generator=gen, dtype=torch.float64,
                   device=dev)
    rank = torch.searchsorted(torch.from_numpy(popn.cdf).to(dev), u,
                              right=True).clamp_(max=pool - 1)
    keys = torch.unique(owner * pool + rank)
    del owner, u, rank
    z = torch.randn(keys.numel(), generator=gen, dtype=torch.float32,
                    device=dev)
    a = torch.exp(z * float(cfg["abundance_sigma"])).cpu().numpy()
    owner, rank = np.divmod(keys.cpu().numpy(), pool)
    del keys, z
    counts = np.bincount(owner, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    total = np.add.reduceat(a, ptr[:-1]).astype(np.float32)
    pct = (a * np.float32(100.0) / np.repeat(total, counts)).astype(
        np.float32)
    return Vectors(ptr, popn.pool_ids[rank], pct)


def sample_names(n: int) -> list[str]:
    """Sample file names as ``composite -i`` indexes them."""
    return [f"SRR{10_000_000 + i}.abv" for i in range(n)]


def write_index(refdir: str, db: Vectors, names: list[str],
                n_species: int, device="cpu") -> None:
    """The abv index of ``db`` under ``refdir`` (its postings sorted on
    ``device``)."""
    import torch
    owner = db.owner()
    key = torch.from_numpy(db.species.astype(np.int64) * db.n + owner)
    order = torch.argsort(key.to(device)).cpu().numpy()   # keys distinct
    rec = np.empty(order.size, dtype=ABV_DTYPE)
    rec["ref_idx"] = owner[order]
    rec["pct"] = db.pct[order]
    base = os.path.join(refdir, INDEX_BASENAME)
    rec.tofile(base + ".abm")
    np.cumsum(np.bincount(db.species, minlength=n_species)).astype(
        np.int32).tofile(base + ".abmi")
    with open(base + ".name", "w") as f:
        f.write("".join(n + "\n" for n in names))
    sq = db.pct.astype(np.float64) ** 2
    np.sqrt(np.add.reduceat(sq, db.ptr[:-1])).tofile(base + ".yl2n")


def write_queries(qdir: str, qs: Vectors) -> list[str]:
    """One ``.abv`` file per query; their paths, in order."""
    os.makedirs(qdir, exist_ok=True)
    paths = []
    for i in range(qs.n):
        sp, pc = qs.row(i)
        rec = np.empty(sp.size, dtype=ABV_DTYPE)
        rec["ref_idx"] = sp
        rec["pct"] = pc
        path = os.path.join(qdir, f"Q{i:05d}.abv")
        rec.tofile(path)
        paths.append(path)
    return paths


@dataclasses.dataclass
class Corpus:
    db: Vectors
    queries: Vectors
    names: list[str]
    n_species: int


def make(cfg: dict, n_queries: int, seed: int, device="cpu") -> Corpus:
    """The database and a pool of ``n_queries`` new samples, from
    ``seed`` alone (any integer), the bulk draws made on ``device``."""
    import torch
    ss = np.random.SeedSequence(seed % (1 << 64))
    s_pop, s_db, s_q = ss.spawn(3)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    popn = population(cfg, np.random.default_rng(s_pop))
    db = vectors(popn, cfg, int(cfg["n_samples"]),
                 np.random.default_rng(s_db), gen)
    qs = vectors(popn, cfg, n_queries, np.random.default_rng(s_q), gen)
    if gen.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(gen.device)
    return Corpus(db, qs, sample_names(db.n), popn.n_species)
