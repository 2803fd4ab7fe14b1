"""Runner of the abv search cells: ``composite -s <mode> --dense``.

Set-up makes the configuration's corpus from the seed, writes its abv
index and a pool of query ``.abv`` files under the run's work directory,
and warms up: two calls of the cell's batch shape (the queries of the
pool's last block), the first of which stages the dense database on the
device through the program's own cache (``ops/dense_abv._dense_db``) and
builds the host library that formats the text.  Each call of the window then runs
``ops.dense_abv.abv_search_dense(refdir, queries, mode, out=sink,
device=...)``, the entry point of ``cli composite -s <mode> --dense``,
with the next ``queries_per_call`` queries of a seeded order of the pool.

The sink of a call holds its text while the call runs.  Of the window's
calls, ``compare_calls`` are drawn from the seed as the window runs
(``Records``: reservoir sampling, so that every call has the same chance
whatever the window's length); only those keep their text and what
``abv_search_batch`` returned, and of the others the characters are
counted.  Nothing is written.  A wrapper around the module attribute
``dense_abv.abv_search_batch`` times that layer (its ``.cpu()`` readback
synchronises, so the host clock holds) and hands its output to the
comparison.

What the benchmark reads of the program, beside the entry point:
``dense_abv.abv_search_batch``, called once a call and returning the
measure and the overlap as [B, N] arrays; and the dense matrix that
``dense_abv._dense_db`` caches (``_DENSE_CACHE``: (index, species,
``DenseAbv``) under (refdir, ...), ``DenseAbv.mat`` float32 [N, S]).
Where a run finds either one not so (a route that no longer calls or
caches them), the checks of that layer are not observed and the run says
so; the ranked text, which every route writes, is compared in every run
(``abv_check.judge``).

Traffic keys: ``mode`` (0 cosine, 1 L1, 2 L2), ``queries_per_call``,
``pool`` (queries made at set-up), ``loop`` ("closed") and ``callers``
(1), ``compare_calls`` (how many of the window's calls are drawn from the
seed and compared).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from kssd_bench import abv_corpus, roofline
from kssd_bench.reference import abv_check
from kssd_bench.reference.abv_ref import Reference

SPAN = "abv_search_batch"


class _Sink:
    """The ``out`` of one call: holds the text, writes nothing."""

    def __init__(self):
        self.parts = []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return len(s)

    def text(self) -> str:
        return "".join(self.parts)

    def chars(self) -> int:
        return sum(map(len, self.parts))


class Records:
    """What a window's calls produced: each call's pool ids; the sink and
    search output of ``keep`` calls, drawn by ``rng`` as the calls come
    (reservoir sampling); the characters of the others."""

    def __init__(self, keep: int, rng: np.random.Generator):
        self.keep = keep
        self.rng = rng
        self.ids = []          # per call: its pool ids
        self.kept = {}         # call index -> (sink, search output)
        self.slots = []        # the kept call indices, one a slot
        self.chars = 0         # characters of the calls not kept
        self.batch_seen = 0    # calls in which abv_search_batch ran

    def add(self, ids: list[int], sink: _Sink, out) -> None:
        i = len(self.ids)
        self.ids.append(ids)
        self.batch_seen += out is not None
        if i < self.keep:
            self.slots.append(i)
        else:
            j = int(self.rng.integers(i + 1))
            if j >= self.keep:
                self.chars += sink.chars()
                return
            self.chars += self.kept.pop(self.slots[j])[0].chars()
            self.slots[j] = i
        self.kept[i] = (sink, out)


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: str):
        import torch
        from metakssd_tpu_torch.device import resolve_device
        from metakssd_tpu_torch.ops import dense_abv

        if traffic.get("loop") != "closed" or int(traffic["callers"]) != 1:
            raise ValueError("the abv runner runs one caller, closed loop")
        self.torch = torch
        self.dense_abv = dense_abv
        self.mode = int(traffic["mode"])
        self.batch = int(traffic["queries_per_call"])
        self.compare_calls = int(traffic["compare_calls"])
        pool = int(traffic["pool"])
        self.seed = seed
        self.device = device
        self.dev = resolve_device(device)
        t = time.perf_counter()
        self.stages = {}
        self.corpus = abv_corpus.make(cfg, pool, seed, self.dev)
        t = self._stage("corpus", t)
        self.refdir = os.path.join(workdir, "db")
        os.makedirs(self.refdir)
        abv_corpus.write_index(self.refdir, self.corpus.db,
                               self.corpus.names, self.corpus.n_species,
                               self.dev)
        self.qpaths = abv_corpus.write_queries(
            os.path.join(workdir, "queries"), self.corpus.queries)
        t = self._stage("files", t)
        rng = np.random.default_rng([seed % (1 << 64), 1])
        self.order = rng.permutation(pool)
        self.records = self.new_records()
        self._last = None
        self._orig = getattr(dense_abv, "abv_search_batch", None)
        if self._orig is not None:
            dense_abv.abv_search_batch = self._batch
        self._df = None
        self._pairs = {}
        for k in range(2):           # the pool's last block: not call 0's
            self._run(self._pool_ids(-1))
            t = self._stage(f"warm_up_{k}", t)
        self.records = self.new_records()

    def new_records(self) -> Records:
        """The records of a window: its draw of compared calls is made
        from the seed."""
        return Records(self.compare_calls,
                       np.random.default_rng([self.seed % (1 << 64), 2]))

    def _stage(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.stages[name] = t - t0
        return t

    # -- the window -----------------------------------------------------

    def _batch(self, dense, queries, mode=0):
        t0 = time.perf_counter()
        with self.torch.profiler.record_function("kssd_bench." + SPAN):
            measure, overlap = self._orig(dense, queries, mode=mode)
        self._last = (measure, overlap, time.perf_counter() - t0)
        return measure, overlap

    def _pool_ids(self, i: int) -> list[int]:
        n = self.order.size
        return [int(self.order[(i * self.batch + k) % n])
                for k in range(self.batch)]

    def _run(self, ids: list[int]):
        sink = _Sink()
        self._last = None
        self.dense_abv.abv_search_dense(
            self.refdir, [self.qpaths[j] for j in ids], self.mode,
            out=sink, device=self.device)
        self.records.add(ids, sink, self._last)
        return self._last

    def call(self, i: int) -> tuple[int, dict]:
        """Call ``i`` of the closed loop: (queries, {span: seconds})."""
        last = self._run(self._pool_ids(i))
        return self.batch, ({SPAN: last[2]} if last is not None else {})

    # -- after the window -----------------------------------------------

    def close(self) -> None:
        """Give the program back its own ``abv_search_batch`` and free its
        state (the dense database it cached)."""
        if getattr(self.dense_abv, "abv_search_batch", None) is self._batch:
            self.dense_abv.abv_search_batch = self._orig
        cache = getattr(self.dense_abv, "_DENSE_CACHE", None)
        if isinstance(cache, dict):
            cache.clear()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def staged_matrix(self):
        """The dense float32 [samples, species] matrix that the program
        staged for this run's database and cached, or None where its
        cache holds none so."""
        torch = self.torch
        cache = getattr(self.dense_abv, "_DENSE_CACHE", None)
        want = (self.corpus.db.n, self.corpus.n_species)
        for key, val in (cache.items() if isinstance(cache, dict) else ()):
            if not (isinstance(key, tuple) and key
                    and key[0] == os.path.abspath(self.refdir)):
                continue
            dense = val[2] if isinstance(val, tuple) and len(val) > 2 \
                else None
            mat = getattr(dense, "mat", None)
            if isinstance(mat, torch.Tensor) and tuple(mat.shape) == want \
                    and mat.dtype == torch.float32:
                return mat
        return None

    def db_checksums(self):
        """Row checksums of the staged matrix
        (``abv_check.dense_checksums``), or None where there is none."""
        mat = self.staged_matrix()
        return abv_check.dense_checksums(mat) if mat is not None else None

    def compare(self, limits: dict, checksums, records=None
                ) -> tuple[list, int]:
        """Checks of the kept calls of ``records`` (the window's) against
        the plain reference; and the number of compared queries that
        failed."""
        records = self.records if records is None else records
        qs = self.corpus.queries
        answers, lines = [], 0
        for c in sorted(records.kept):
            sink, out = records.kept[c]
            text = sink.text()
            lines += text.count("\n")
            answers.append(abv_check.Answer(
                [qs.row(j) for j in records.ids[c]],
                out[0] if out else None, out[1] if out else None, text))
        n_q = sum(len(a.queries) for a in answers)
        print(f"kssd_bench: compared {len(answers)} of {len(records.ids)} "
              f"calls, {n_q} queries, {lines / max(n_q, 1):.1f} text lines "
              f"a query; {records.chars} characters of the others "
              f"counted; abv_search_batch ran in {records.batch_seen} "
              f"calls", file=sys.stderr)
        ref = Reference(self.corpus.db, self.corpus.n_species)
        return abv_check.judge(ref, self.corpus.names, answers, self.mode,
                               limits, checksums,
                               batch_observed=records.batch_seen > 0)

    def judge(self, limits: dict) -> tuple[list, int]:
        """Once the window has closed: the staged database's checksums,
        then the program's state freed, then the comparison."""
        checksums = self.db_checksums()
        self.close()
        return self.compare(limits, checksums)

    def work(self, i: int) -> tuple[float, float]:
        """(operations, bytes) that call ``i`` of the window needs
        (``roofline.abv_work``), from the corpus alone."""
        db = self.corpus.db
        if self._df is None:
            self._df = np.bincount(db.species,
                                   minlength=self.corpus.n_species)
        ops = nbytes = 0.0
        for j in self.records.ids[i]:
            sp, _ = self.corpus.queries.row(j)
            if j not in self._pairs:
                hit = np.isin(db.species, sp)
                self._pairs[j] = int(np.count_nonzero(
                    np.logical_or.reduceat(hit, db.ptr[:-1])))
            o, b = roofline.abv_work(int(self._df[sp].sum()), sp.size,
                                     self._pairs[j], self.mode)
            ops += o
            nbytes += b
        return ops, nbytes
