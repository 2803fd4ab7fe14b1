"""The comparison that decides ``correct`` for the abv search.

Three layers of the program are held to the plain reference
(``abv_ref.Reference``):

- the dense database that set-up staged on the device: each row's
  checksum (``dense_checksums``) against the reference's, exactly
  (``db_rows_wrong``);
- what ``abv_search_batch`` returned for the compared calls: the overlap
  mask, exactly (``overlap_wrong``, pairs that differ), and the measure
  (``measure_gap``, the widest |program - reference| / max(|reference|, 1)
  over the overlapping samples; NaN or a missing value reads inf);
- the ranked text of those calls: one block a query with the mode's
  header, the names of exactly the overlapping samples, once each, values
  in the mode's order, ties of the program's own measure in sample-id
  order (descending for cosine, whose order is the reversed ascending
  sort, as the reference tool's) (``text_wrong`` counts every fault: a
  missing block or line, an unknown, extra or repeated name, an
  inversion), and the printed values (``text_gap``, as ``measure_gap``).

The ranked text is what every route of the program writes, so it is
compared in every run.  The first two layers are read where the program
exposes them (the runner's ``staged_matrix`` and its wrapper of
``abv_search_batch``); where a run finds no staged matrix (``checksums``
None) or no call of ``abv_search_batch`` in the window
(``batch_observed`` false), those checks are left out of the run's list,
not passed, and the text decides.  A layer seen in some calls and not in
a compared one is a fault of that call.

Nothing here imports the program: it reads the program's outputs only to
judge them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

HEADERS = {0: "CosineXY", 1: "L1norm", 2: "L2norm"}


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)   # NaN fails


@dataclasses.dataclass
class Answer:
    """One compared call: its queries (sparse), what ``abv_search_batch``
    returned and the text ``abv_search_dense`` wrote."""
    queries: list[tuple[np.ndarray, np.ndarray]]
    measure: np.ndarray | None    # float32 [B, N]
    overlap: np.ndarray | None    # bool [B, N]
    text: str


def dense_checksums(mat, rows: int = 1024) -> np.ndarray:
    """Per row of the program's dense float32 matrix (a torch tensor),
    sum over columns j of bits(value) * (j + 1), in int64 on its device,
    ``rows`` rows at a time."""
    import torch
    n, s = mat.shape
    w = torch.arange(1, s + 1, dtype=torch.int64, device=mat.device)
    out = torch.empty(n, dtype=torch.int64, device=mat.device)
    for r0 in range(0, n, rows):
        bits = mat[r0:r0 + rows].contiguous().view(torch.int32)
        out[r0:r0 + rows] = (bits.to(torch.int64) * w).sum(dim=1)
    return out.cpu().numpy()


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.size == 0:
        return 0.0
    d = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1.0)
    d = np.where(np.isfinite(d), d, np.inf)
    return float(d.max())


def _float(v: str) -> float:
    try:
        return float(v)
    except ValueError:
        return math.nan


def _blocks(text: str, header: str) -> tuple[list[list[str]], int]:
    """The text cut into one list of lines a query; and the count of
    faults in its framing (a block whose header is not ``header``)."""
    blocks, faults = [], 0
    for part in text.split("#Sample\t")[1:]:
        lines = part.split("\n")
        if lines[0] != header:
            faults += 1
        if lines[-1] != "":
            faults += 1
        blocks.append(lines[1:-1])
    if text and not text.startswith("#Sample\t"):
        faults += 1
    return blocks, faults


def _text_faults(lines: list[str], ids_ref: np.ndarray, val_ref: np.ndarray,
                 name_id: dict, measure_row, mode: int
                 ) -> tuple[int, float]:
    cells = "\t".join(lines).split("\t")
    faults = 0
    if len(cells) != 2 * len(lines):        # a line without one tab
        faults += len(lines)
        cells = cells[:2 * (len(cells) // 2)]
    ids = np.fromiter((name_id.get(n, -1) for n in cells[0::2]),
                      dtype=np.int64, count=len(cells) // 2)
    try:
        vals = np.asarray(cells[1::2], dtype=np.float64)
    except ValueError:
        vals = np.asarray([_float(v) for v in cells[1::2]],
                          dtype=np.float64)
    good = (ids >= 0) & np.isfinite(vals)
    faults += int(np.sum(~good))
    ids, vals = ids[good], vals[good]
    uniq = np.unique(ids)
    faults += ids.size - uniq.size
    faults += np.setxor1d(uniq, ids_ref, assume_unique=True).size
    step = np.diff(vals)
    faults += int(np.sum(step > 0 if mode == 0 else step < 0))
    if measure_row is not None and ids.size > 1:
        m = measure_row[ids]
        tie = m[1:] == m[:-1]
        down = ids[1:] < ids[:-1]
        faults += int(np.sum(tie & (~down if mode == 0 else down)))
    gap = 0.0
    if ids_ref.size and ids.size:
        pos = np.minimum(np.searchsorted(ids_ref, ids), ids_ref.size - 1)
        known = ids_ref[pos] == ids
        gap = _gap(vals[known], val_ref[pos[known]])
    return faults, gap


def judge(ref, names: list[str], answers: list[Answer], mode: int,
          limits: dict, checksums: np.ndarray | None,
          batch_observed: bool = True) -> tuple[list[Check], int]:
    """The checks of a run that observed their layer, and the number of
    compared queries that failed one of them."""
    name_id = {n: i for i, n in enumerate(names)}
    header = HEADERS[mode]
    db_wrong = (int(np.sum(checksums != ref.row_checksums()))
                if checksums is not None else None)
    overlap_wrong = text_wrong = 0
    measure_gap = text_gap = 0.0
    failed = 0
    n_samples = ref.db.n
    for ans in answers:
        blocks, framing = _blocks(ans.text, header)
        text_wrong += framing + max(0, len(blocks) - len(ans.queries))
        for b, (sp, pc) in enumerate(ans.queries):
            ids_ref, val_ref = ref.search(sp, pc, mode)
            q_over = q_text = 0
            q_mgap = q_tgap = 0.0
            row = None
            if not batch_observed:
                pass
            elif ans.measure is None or b >= ans.measure.shape[0]:
                q_over = n_samples
                q_mgap = math.inf
            else:
                row = ans.measure[b]
                got = np.flatnonzero(ans.overlap[b])
                q_over = int(np.setxor1d(got, ids_ref,
                                         assume_unique=True).size)
                q_mgap = _gap(row[ids_ref], val_ref)
            if b < len(blocks):
                q_text, q_tgap = _text_faults(blocks[b], ids_ref, val_ref,
                                              name_id, row, mode)
            else:
                q_text = 1
            overlap_wrong += q_over
            text_wrong += q_text
            measure_gap = max(measure_gap, q_mgap)
            text_gap = max(text_gap, q_tgap)
            if (q_over or q_text or not q_mgap <= limits["measure_gap"]
                    or not q_tgap <= limits["text_gap"]):
                failed += 1
    got = {"db_rows_wrong": db_wrong,
           "overlap_wrong": overlap_wrong if batch_observed else None,
           "text_wrong": text_wrong,
           "measure_gap": measure_gap if batch_observed else None,
           "text_gap": text_gap}
    return [Check(k, v, limits[k]) for k, v in got.items()
            if v is not None], failed
