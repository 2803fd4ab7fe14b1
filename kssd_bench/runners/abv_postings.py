"""Runner of the abv search over the index's postings: ``composite -s
<mode>`` on the card (``ops/abv_postings.py``).

Set-up imports the program's module first (a program without it fails
here, before any data is made, and never falls back to another route),
then makes the configuration's corpus from the seed, writes its abv index
and a pool of query ``.abv`` files under the run's work directory, and
warms up: two calls on the pool's last query, the first of which stages
the index on the device through the program's own cache
(``abv_postings._POSTINGS_CACHE``) and builds the kernels.  Each call of
the window then runs ``abv_postings.abv_search_postings(refdir, queries,
mode, out=sink, device=...)``, the entry point of ``cli composite -s
<mode>``, with the next ``queries_per_call`` queries of a seeded order of
the pool.  A wrapper around the module attribute
``abv_postings.postings_search_batch`` times that layer (its readback
synchronises) under the span ``kssd_bench.postings_search_batch`` and
hands its output to the comparison; of the window's calls
``compare_calls`` are drawn from the seed (``abv_search.Records``) and
keep their text and that output.

What the benchmark reads of the program, beside the entry point:
``postings_search_batch(staged, queries, mode)``, returning (measure
float32 [B, N], touch int64 [B, N]); and the staged postings in
``_POSTINGS_CACHE`` (under a key that starts with the index directory:
``starts`` int64 [S + 1], ``ids`` int32 and ``pct`` float32 [nnz] on the
device) for ``index_wrong``.  The comparison is
``reference/abv_post_check.judge``; its control (bfloat16 postings and
query percentages, ``reference/abv_post_control.py``) runs through
``calibrate_postings.py``, which is ``calibrate.py`` with that control.
The traced metrics read the program's spans ``abv.post.walk``
(``abv_post_kernel_ms``), ``abv.post.rank`` (``abv_post_rank_ms``) and
``abv.post.format`` (``abv_post_format_ms``) beside the wrapper's span.

Traffic keys as ``abv_search``'s: ``mode``, ``queries_per_call``,
``pool``, ``loop`` ("closed"), ``callers`` (1), ``compare_calls``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from kssd_bench import abv_corpus, roofline
from kssd_bench.reference import abv_post_check
from kssd_bench.runners.abv_search import Records, _Sink

SPAN = "postings_search_batch"


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: str):
        from metakssd_tpu_torch.ops import abv_postings
        import torch
        from metakssd_tpu_torch.device import resolve_device

        if traffic.get("loop") != "closed" or int(traffic["callers"]) != 1:
            raise ValueError("the abv runner runs one caller, closed loop")
        self.torch = torch
        self.program = abv_postings
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
        print(f"kssd_bench: {self.corpus.db.n} samples, "
              f"{self.corpus.db.species.size} postings over "
              f"{self.corpus.n_species} species", file=sys.stderr)
        rng = np.random.default_rng([seed % (1 << 64), 1])
        self.order = rng.permutation(pool)
        self.records = self.new_records()
        self._last = None
        self._orig = abv_postings.postings_search_batch
        abv_postings.postings_search_batch = self._batch
        self._ref = None
        self._ref_ids = None      # the reference's sample ids, on the device
        self._pairs = {}
        for k in range(2):
            self._run([int(self.order[-1])])
            t = self._stage(f"warm_up_{k}", t)
        self.records = self.new_records()

    def new_records(self) -> Records:
        return Records(self.compare_calls,
                       np.random.default_rng([self.seed % (1 << 64), 2]))

    def _stage(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.stages[name] = t - t0
        return t

    # -- the window -----------------------------------------------------

    def _batch(self, staged, queries, mode=0):
        t0 = time.perf_counter()
        with self.torch.profiler.record_function("kssd_bench." + SPAN):
            measure, touch = self._orig(staged, queries, mode=mode)
        self._last = (measure, touch, time.perf_counter() - t0)
        return measure, touch

    def _pool_ids(self, i: int) -> list[int]:
        n = self.order.size
        return [int(self.order[(i * self.batch + k) % n])
                for k in range(self.batch)]

    def _run(self, ids: list[int]):
        sink = _Sink()
        self._last = None
        self.program.abv_search_postings(
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
        """Give the program back its own ``postings_search_batch`` and free
        its state (the staged index)."""
        if getattr(self.program, "postings_search_batch", None) \
                is self._batch:
            self.program.postings_search_batch = self._orig
        cache = getattr(self.program, "_POSTINGS_CACHE", None)
        if isinstance(cache, dict):
            cache.clear()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self) -> abv_post_check.Postings:
        """The corpus's species-major postings (made once)."""
        if self._ref is None:
            self._ref = abv_post_check.Postings.from_vectors(
                self.corpus.db, self.corpus.n_species, self.dev)
        return self._ref

    def db_checksums(self):
        """(offsets, checksums) of the postings the program staged for this
        run's index (``abv_post_check.species_checksums``), or None where
        its cache holds none."""
        cache = getattr(self.program, "_POSTINGS_CACHE", None)
        for key, staged in (cache.items() if isinstance(cache, dict)
                            else ()):
            if isinstance(key, tuple) and key and \
                    key[0] == os.path.abspath(self.refdir):
                return abv_post_check.species_checksums(
                    staged.starts, staged.ids, staged.pct)
        return None

    def compare(self, limits: dict, checksums, records=None
                ) -> tuple[list, int]:
        """Checks of the kept calls of ``records`` (the window's) against
        the reference; and the number of compared queries that failed."""
        records = self.records if records is None else records
        qs = self.corpus.queries
        t = time.perf_counter()
        answers = []
        for c in sorted(records.kept):
            sink, out = records.kept[c]
            answers.append(abv_post_check.Answer(
                [qs.row(j) for j in records.ids[c]],
                out[0] if out else None, out[1] if out else None,
                sink.text()))
        got = abv_post_check.judge(
            self.reference(), self.corpus.names, answers, self.mode, limits,
            checksums,
            batch_observed=records.batch_seen > 0)
        print(f"kssd_bench: compared {len(answers)} of {len(records.ids)} "
              f"calls, {sum(len(a.queries) for a in answers)} queries, in "
              f"{time.perf_counter() - t:.1f} s; {records.chars} characters "
              f"of the others counted; postings_search_batch ran in "
              f"{records.batch_seen} calls", file=sys.stderr)
        return got

    def judge(self, limits: dict) -> tuple[list, int]:
        """Once the window has closed: the staged index's checksums, then
        the program's state freed, then the comparison."""
        checksums = self.db_checksums()
        self.close()
        return self.compare(limits, checksums)

    def work(self, i: int) -> tuple[float, float]:
        """(operations, bytes) that call ``i`` of the window needs
        (``roofline.abv_work``), from the corpus alone: the query species'
        postings, its nonzeros and the samples it overlaps (marked in a
        bitmap from the species-major postings, on the device)."""
        torch = self.torch
        ref = self.reference()
        ops = nbytes = 0.0
        for j in self.records.ids[i]:
            sp, _ = self.corpus.queries.row(j)
            if j not in self._pairs:
                if self._ref_ids is None:
                    self._ref_ids = torch.from_numpy(ref.ids).to(self.dev)
                sp64 = sp.astype(np.int64)
                lo = torch.from_numpy(ref.starts[sp64]).to(self.dev)
                lens = torch.from_numpy(ref.starts[sp64 + 1]).to(self.dev) \
                    - lo
                at = torch.repeat_interleave(lo - (lens.cumsum(0) - lens),
                                             lens)
                at += torch.arange(at.numel(), device=self.dev)
                mark = torch.zeros(self.corpus.db.n, dtype=torch.bool,
                                   device=self.dev)
                mark[self._ref_ids[at].long()] = True
                self._pairs[j] = (at.numel(), int(mark.sum()))
            walked, pairs = self._pairs[j]
            o, b = roofline.abv_work(walked, sp.size, pairs, self.mode)
            ops += o
            nbytes += b
        return ops, nbytes
