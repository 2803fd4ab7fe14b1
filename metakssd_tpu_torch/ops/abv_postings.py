"""``composite -s <mode>`` on a device, over the abv index's own postings.

The reference tool's abv search (``abv_search``,
command_composite.c:217-348; the host route ``composite.abv_search``)
walks, for each query, the postings of the query's species in the
``.abv`` file's order and adds the mode's term to a float32 accumulator a
sample.  This module stages the index as ``composite -i`` wrote it on the
named device once (``_POSTINGS_CACHE``) and runs that walk there: on a
card the hand-written kernel ``mkssd_abv_post_walk`` (``csrc/abv.cu``),
on the CPU its plain twin ``postings_walk_plain``, the same additions in
PyTorch.  Its text is that of ``composite.abv_search``, byte for byte:
every sample that shares a species with the query, once, ranked by a
stable sort on the float32 measure over the samples in the order the walk
first touched them (reversed for cosine), L2 printed as the float64 root
of the float32 sum, L1 as the sum plus ``(200 - xsum) - ysum`` in
float32, cosine as the float32 dot divided in float64 by ``sqrt(xl2n) *
y_l2n`` and rounded once.  Unlike ``--dense`` it holds the DB in its own
sparse layout: the whole public abv DB (382,016 samples over GTDB r214's
85,205 species) is about 1.2 GB of postings.

What is staged (``StagedPostings``, cached under
``formats/abv.index_cache_key``):

- ``index``: the ``AbvIndex`` as read (host);
- ``starts``: int64 [S + 1] on the device, species j's postings are
  ``[starts[j], starts[j + 1])`` (``.abmi`` with a leading 0);
  ``starts_host`` the same array in NumPy;
- ``ids``: int32 [nnz] on the device, each posting's sample id, strictly
  ascending within a species (checked when staged);
- ``pct``: float32 [nnz] on the device, each posting's percentage;
- ``names``: the sample names for the text's writers
  (``abv_text.StagedNames``; on a card also there, with the text's
  buffers).

``postings_search_batch(staged, queries, mode)``, looked up as a module
attribute once a call, returns (measure float32 [B, N], touch int64
[B, N]) as NumPy: the float32 sum before the mode's final step (L1's
complement term included, cosine's division not) and the walk position of
each sample's first posting, -1 (measure 0) where it shares no species.
Ranking (``rank``, ties by first touch) and the text follow as the dense
route's do (``ops/abv_text``): the text on the card where it is staged.

Each call of ``abv_search_postings`` is one ``TIMER`` stage
``abv.post.search`` holding ``abv.post.db`` (``abv.post.stage`` on a cache
miss), ``abv.post.queries``, ``abv.post.batch`` (``abv.post.walk``: the
queries' upload and the walk; ``abv.post.readback``) and per query
``abv.post.rank`` and ``abv.post.format``; counters ``abv.post.postings``
(postings walked: the query species' posting counts summed; the walk's
launches are ``_build.LAUNCHES["abv_post_walk"]``), ``abv.post.lines``
(the text's data lines) and, on a card, ``abv.post.format.card`` (lines
formatted there) and ``abv.post.format.host`` (lines of queries whose
text fell back to the host writer).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import torch

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.formats.abv import (BINVEC_DIRNAME, AbvIndex,
                                            index_cache_key, read_abv_file)
from metakssd_tpu_torch.ops import _build
from metakssd_tpu_torch.ops.abv_text import HEADERS, StagedNames
# rank's order, under the name kssd_bench's planted fault (a swapped tie)
# replaces
from metakssd_tpu_torch.ops.abv_text import rank_order as _order_key
from metakssd_tpu_torch.utils import TIMER

BATCH_BYTES = 1 << 30     # outputs of one postings_search_batch call
MAX_BATCH = 65535         # queries of one launch (the kernel's grid y)


@dataclasses.dataclass
class StagedPostings:
    """An abv index staged on one device (see the module docstring)."""
    index: AbvIndex
    starts_host: np.ndarray
    starts: torch.Tensor
    ids: torch.Tensor
    pct: torch.Tensor
    names: StagedNames

    @property
    def n_samples(self) -> int:
        return len(self.index.names)


def stage_postings(index: AbvIndex, device) -> StagedPostings:
    """``index`` on ``device``; raises where its postings are not in the
    order ``composite -i`` writes (sample ids strictly ascending within a
    species, each below the sample count)."""
    n = len(index.names)
    starts = np.zeros(index.abmi.size + 1, dtype=np.int64)
    starts[1:] = index.abmi
    nnz = index.abm_idx.size
    if np.any(np.diff(starts) < 0) or starts[-1] != nnz:
        raise ValueError("abv index: .abmi does not count the .abm postings")
    ids = torch.from_numpy(index.abm_idx).to(device)
    pct = torch.from_numpy(index.abm_pct).to(device)
    if nnz:
        cross = torch.zeros(nnz - 1, dtype=torch.bool, device=device)
        inner = starts[1:-1]
        cross[torch.from_numpy(inner[(inner > 0) & (inner < nnz)] - 1)
              .to(device)] = True
        if not bool(((ids[1:] > ids[:-1]) | cross).all()) or \
                int(ids.min()) < 0 or int(ids.max()) >= n:
            raise ValueError("abv index: postings not in sample order within "
                             "a species (search it with --device host)")
    return StagedPostings(index, starts, torch.from_numpy(starts).to(device),
                          ids, pct, StagedNames.stage(index.names, ids.device))


_POSTINGS_CACHE: dict = {}


def _postings_db(refdir: str, device) -> StagedPostings:
    """``refdir``'s index staged on ``device``, cached by
    ``index_cache_key``."""
    with TIMER.stage("abv.post.db"):
        key = index_cache_key(refdir, device)
        got = _POSTINGS_CACHE.get(key)
        if got is None:
            with TIMER.stage("abv.post.stage"):
                got = stage_postings(AbvIndex.read(refdir), device)
            _POSTINGS_CACHE[key] = got
        return got


def query_csr(starts: np.ndarray, queries: list) -> tuple[np.ndarray, ...]:
    """The queries ((species int32, pct float32) each, in file order) as
    CSR: (offsets int32 [B + 1], species int32, values float32, walk
    position int64 of each species' first posting); and the postings the
    walk reads.  Raises on a species outside the index."""
    n_species = starts.size - 1
    lens = [q[0].size for q in queries]
    offsets = np.zeros(len(queries) + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    sp = (np.concatenate([q[0] for q in queries]).astype(np.int32)
          if queries else np.zeros(0, np.int32))
    val = (np.concatenate([q[1] for q in queries]).astype(np.float32)
           if queries else np.zeros(0, np.float32))
    if sp.size and (sp.min() < 0 or sp.max() >= n_species):
        raise ValueError(f"a query names a species outside the index's "
                         f"{n_species}")
    df = starts[sp.astype(np.int64) + 1] - starts[sp]
    # positions over the whole batch, less those of each query's start
    at = np.zeros(sp.size + 1, dtype=np.int64)
    np.cumsum(df, out=at[1:])
    pos = at[:-1] - np.repeat(at[offsets[:-1]], lens)
    return offsets, sp, val, pos, int(at[-1])


def _outputs(b: int, n: int, device):
    """One buffer for both outputs, so that one copy reads them back:
    (buffer, touch int64 [b, n], measure float32 [b, n])."""
    buf = torch.empty(3 * b * n, dtype=torch.int32, device=device)
    return (buf, buf[:2 * b * n].view(torch.int64).view(b, n),
            buf[2 * b * n:].view(torch.float32).view(b, n))


def postings_walk_plain(starts, ids, pct, n_samples: int, q_off, q_sp, q_val,
                        q_pos, mode: int, measure, touch) -> None:
    """``mkssd_abv_post_walk``'s additions in plain PyTorch, into
    ``measure`` and ``touch``: a query's species in order, each adding its
    postings' terms to their samples in float32 (within one species every
    sample is distinct), so the sums are the reference tool's, bit for
    bit."""
    for b in range(q_off.numel() - 1):
        acc = torch.zeros((3 if mode == 1 else 1, n_samples),
                          dtype=torch.float32, device=ids.device)
        first = torch.full((n_samples,), -1, dtype=torch.int64,
                           device=ids.device)
        for k in range(int(q_off[b]), int(q_off[b + 1])):
            j = int(q_sp[k])
            lo, hi = int(starts[j]), int(starts[j + 1])
            s = ids[lo:hi].long()
            y = pct[lo:hi]
            x = q_val[k:k + 1]
            if mode == 2:
                d = y - x
                term = d * d
            elif mode == 1:
                term = (y.double() - x.double()).abs().float()
                acc[1, s] += x
                acc[2, s] += y
            else:
                term = y * x
            acc[0, s] += term
            new = first[s] < 0
            first[s[new]] = int(q_pos[k]) + torch.nonzero(new).flatten()
        m = acc[0]
        if mode == 1:
            m = m + ((200.0 - acc[1]) - acc[2])
        touch[b] = first
        measure[b] = torch.where(first >= 0, m, 0.0)


def postings_walk(staged: StagedPostings, q_off, q_sp, q_val, q_pos,
                  mode: int) -> tuple[torch.Tensor, ...]:
    """(buffer, touch int64 [B, N], measure float32 [B, N]) of the
    queries' CSR (tensors on ``staged``'s device; see ``query_csr``):
    ``mkssd_abv_post_walk`` on a card, ``postings_walk_plain`` on the CPU.
    mode: 0 cosine, 1 L1, 2 L2."""
    if mode not in (0, 1, 2):
        raise ValueError(f"no abv measure of mode {mode}: 0 cosine, 1 L1, "
                         "2 L2")
    dev = staged.ids.device
    for name, t, dtype in (("q_off", q_off, torch.int32),
                           ("q_sp", q_sp, torch.int32),
                           ("q_val", q_val, torch.float32),
                           ("q_pos", q_pos, torch.int64)):
        _build.check_1d(name, t, dtype, dev)
    b, n = q_off.numel() - 1, staged.n_samples
    buf, touch, measure = _outputs(b, n, dev)
    if dev.type == "cpu":
        postings_walk_plain(staged.starts, staged.ids, staged.pct, n, q_off,
                            q_sp, q_val, q_pos, mode, measure, touch)
        return buf, touch, measure
    if dev.type != "cuda":
        raise ValueError(f"no abv postings kernel for device {dev}")
    if b == 0 or n == 0:
        return buf, touch.fill_(-1), measure.zero_()
    lib = _build.library()
    with _build.card_of(staged.ids):
        err = lib.mkssd_abv_post_walk(
            staged.starts.data_ptr(), staged.ids.data_ptr(),
            staged.pct.data_ptr(), n, q_off.data_ptr(), q_sp.data_ptr(),
            q_val.data_ptr(), q_pos.data_ptr(), b, mode, measure.data_ptr(),
            touch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "mkssd_abv_post_walk")
    _build.LAUNCHES["abv_post_walk"] += 1
    return buf, touch, measure


def postings_search_batch(staged: StagedPostings, queries: list,
                          mode: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(measure float32 [B, N], touch int64 [B, N]) as NumPy of the
    queries ((species int32, pct float32) each, in file order) against
    ``staged``: the walk's float32 sums and first touches (see the module
    docstring).  mode: 0 cosine, 1 L1, 2 L2."""
    with TIMER.stage("abv.post.batch"):
        off, sp, val, pos, walked = query_csr(staged.starts_host, queries)
        b, nq = off.size - 1, sp.size
        with TIMER.stage("abv.post.walk"):
            # one upload: positions (int64 first, for their alignment),
            # offsets, species and the values' bits
            packed = torch.from_numpy(np.concatenate(
                [pos.view(np.int32), off, sp, val.view(np.int32)])).to(
                    staged.ids.device)
            at = 2 * nq
            buf, _, _ = postings_walk(
                staged, packed[at:at + b + 1],
                packed[at + b + 1:at + b + 1 + nq],
                packed[at + b + 1 + nq:].view(torch.float32),
                packed[:at].view(torch.int64), mode)
        TIMER.count("abv.post.postings", walked)
        with TIMER.stage("abv.post.readback"):
            host = buf.cpu().numpy()
        bn = b * staged.n_samples
        return (host[2 * bn:].view(np.float32).reshape(b, -1),
                host[:2 * bn].view(np.int64).reshape(b, -1))


def rank(measure: np.ndarray, touch: np.ndarray, mode: int,
         qpct: np.ndarray, y_l2n: np.ndarray
         ) -> tuple[np.ndarray, np.ndarray]:
    """One query's (sample ids in the text's order, their printed values
    as float64) from its row of ``postings_search_batch``, as
    ``composite.abv_search`` ranks them."""
    ids = np.flatnonzero(touch >= 0)
    m = measure[ids]
    if mode == 0:
        q = np.asarray(qpct, dtype=np.float32)
        xl2n = float(np.cumsum(q * q, dtype=np.float32)[-1]) if q.size \
            else 0.0        # sequential float32, as the reference's loop
        m = (m.astype(np.float64)
             / (math.sqrt(xl2n) * y_l2n[ids])).astype(np.float32)
    order = _order_key(m, touch[ids])
    if mode == 0:
        order = order[::-1]
    vals = m[order].astype(np.float64)
    return ids[order], (np.sqrt(vals) if mode == 2 else vals)


def abv_search_postings(refdir: str, queries: list[str], mode: int = 0,
                        out=None, *, device) -> None:
    """``composite -s <mode>`` on ``device`` (``cuda`` or ``cpu``): the
    text of ``composite.abv_search``, byte for byte, the queries walked
    in calls of ``postings_search_batch`` of as many as fit BATCH_BYTES
    of outputs (all of them, unless there are hundreds).  As there, a
    mode other than 1 (L1) or 2 (L2) is cosine, and a non-.abv argument
    is reported, in its place among the queries' blocks, and skipped."""
    out = out or sys.stdout
    mode = mode if mode in (1, 2) else 0
    with TIMER.stage("abv.post.search"):
        staged = _postings_db(refdir, resolve_device(device))
        items, qs = [], []
        with TIMER.stage("abv.post.queries"):
            for qpath in queries:
                if not qpath.endswith(".abv"):
                    items.append(qpath)
                    continue
                items.append(len(qs))
                qs.append(read_abv_file(
                    os.path.join(refdir, BINVEC_DIRNAME, qpath)
                    if "/" not in qpath else qpath))
        per = max(1, min(MAX_BATCH,
                         BATCH_BYTES // (12 * max(staged.n_samples, 1))))
        measure, base = None, 0
        for it in items:
            if isinstance(it, str):
                print(f"argument {it} is not a .abv file, skipped")
                continue
            if measure is None or it >= base + measure.shape[0]:
                base = it
                measure, touch = postings_search_batch(
                    staged, qs[it:it + per], mode=mode)
            with TIMER.stage("abv.post.rank"):
                ids, vals = rank(measure[it - base], touch[it - base], mode,
                                 qs[it][1], staged.index.y_l2n)
            with TIMER.stage("abv.post.format"):
                out.write(f"#Sample\t{HEADERS[mode]}\n")
                if staged.names.write(out, ids, vals):
                    TIMER.count("abv.post.format.card", ids.size)
                elif staged.names.card is not None:
                    TIMER.count("abv.post.format.host", ids.size)
            TIMER.count("abv.post.lines", ids.size)
