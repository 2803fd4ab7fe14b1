"""The comparison that decides ``correct`` for the abv search over the
index's postings (``runners/abv_postings.py``).

The route promises the reference tool's text byte for byte, so it is held
to the tool's own arithmetic, not to a tolerance: ``Postings`` is the
database's species-major postings made here from the generated sparse
vectors (never from the index files or any array of the program), and
``walk`` the tool's search over them (``abv_search``,
command_composite.c:217-348), in NumPy: the query's species in file
order, each adding its postings' terms to a float32 accumulator a sample
(L2 ``(y - x)^2``, L1 ``|y - x|`` rounded from float64 with ``x`` and
``y`` summed apart and ``(200 - xsum) - ysum`` added at the end, cosine
``y * x``, every operation in float32), and the walk position of each
sample's first posting.  ``text`` ranks and prints as the tool does.
Checks:

- ``index_wrong``: species whose staged postings (offsets, then sample
  ids and percentages by ``species_checksums``) differ from the
  reference's, exactly;
- ``measure_wrong``: samples of a compared query's overlap whose
  float32 measure from ``postings_search_batch`` differs in its bits from
  the reference's in-order sum;
- ``touch_wrong``: samples whose first touch differs (a sample on one
  side of the overlap only counts);
- ``text_wrong``: lines of the compared calls' text not byte-equal to the
  reference's (a block's missing or extra lines count);
- ``text_gap``: the printed values against the float64 measures
  (``walk``'s third output: ``abv_ref.Reference``'s formulas, summed over
  the query's postings rather than over a pass of the whole database),
  the widest |printed - reference| / max(|reference|, 1), as
  ``abv_check`` measures it.

The first three are left out of a run that found no staged index or no
call of ``postings_search_batch``; the text is compared in every run.
Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from kssd_bench.reference.abv_check import HEADERS, Check, _gap


@dataclasses.dataclass
class Postings:
    """Species-major postings: species j holds ``ids[starts[j]:starts[j +
    1]]`` (ascending) with percentages ``pct[...]``; NumPy."""
    starts: np.ndarray    # int64 [S + 1]
    ids: np.ndarray       # int32 [nnz]
    pct: np.ndarray       # float32 [nnz]
    y_l2n: np.ndarray     # float64 [N], as abv_corpus.write_index sums
    device: str = "cpu"   # where the checksums are taken

    @classmethod
    def from_vectors(cls, db, n_species: int, device="cpu") -> "Postings":
        """From sample-major vectors (``abv_corpus.Vectors``): a stable
        sort by species, made with torch on ``device``."""
        import torch
        sp = torch.from_numpy(db.species).to(device)
        order = torch.sort(sp, stable=True).indices
        del sp
        owner = torch.repeat_interleave(
            torch.arange(db.n, dtype=torch.int32, device=device),
            torch.from_numpy(db.counts()).to(device))
        ids = owner[order].cpu().numpy()
        del owner
        pct = torch.from_numpy(db.pct).to(device)[order].cpu().numpy()
        starts = np.zeros(n_species + 1, dtype=np.int64)
        np.cumsum(np.bincount(db.species, minlength=n_species),
                  out=starts[1:])
        sq = db.pct.astype(np.float64) ** 2
        return cls(starts, ids, pct,
                   np.sqrt(np.add.reduceat(sq, db.ptr[:-1])), str(device))


def species_checksums(starts, ids, pct):
    """Per species, over its postings j = 0, 1, ...: sum of (j + 1) *
    ((id + 1) * 2^32 + bits(pct)), in int64 (wrapping), with torch on the
    tensors' device; (offsets, checksums) as NumPy."""
    import torch
    starts = starts.to(torch.int64)
    n = ids.numel()
    own = torch.repeat_interleave(
        torch.arange(starts.numel() - 1, device=ids.device),
        starts[1:] - starts[:-1])
    j = torch.arange(n, device=ids.device) - starts[own] + 1
    word = ((ids.to(torch.int64) + 1) << 32) | \
        (pct.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    out = torch.zeros(starts.numel() - 1, dtype=torch.int64,
                      device=ids.device)
    out.index_add_(0, own, word * j)
    return starts.cpu().numpy(), out.cpu().numpy()


def index_wrong(got, ref: Postings) -> int:
    """Species whose staged (offsets, checksums) differ from ``ref``'s."""
    import torch
    want = species_checksums(*(torch.from_numpy(a).to(ref.device)
                               for a in (ref.starts, ref.ids, ref.pct)))
    if got[0].shape != want[0].shape:
        return ref.starts.size - 1
    bad = (got[0][1:] != want[0][1:]) | (got[0][:-1] != want[0][:-1])
    return int(np.sum(bad | (got[1] != want[1])))


def walk(ref: Postings, species: np.ndarray, pct: np.ndarray, mode: int
         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(measure float32 [N], touch int64 [N], measure float64 [N]) of one
    query, as the module docstring says (0, -1 and 0 off the overlap);
    the float64 measure is ``abv_ref.Reference.search``'s formula, its
    terms summed in float64 over the query's postings."""
    n = ref.y_l2n.size
    acc = np.zeros(n, dtype=np.float32)
    xs = np.zeros(n, dtype=np.float32)
    ys = np.zeros(n, dtype=np.float32)
    acc64 = np.zeros(n, dtype=np.float64)
    touch = np.full(n, -1, dtype=np.int64)
    pos = 0
    for sp, x in zip(species.tolist(), pct.astype(np.float32)):
        lo, hi = ref.starts[sp], ref.starts[sp + 1]
        s = ref.ids[lo:hi]
        y = ref.pct[lo:hi]
        y64 = y.astype(np.float64)
        if mode == 2:
            acc[s] += (y - x) * (y - x)
            acc64[s] += (y64 - np.float64(x)) ** 2
        elif mode == 1:
            d = np.abs(y64 - np.float64(x))
            acc[s] += d.astype(np.float32)
            xs[s] += x
            ys[s] += y
            acc64[s] += d - np.float64(x) - y64
        else:
            acc[s] += y * x
            acc64[s] += y64 * np.float64(x)
        new = touch[s] < 0
        touch[s[new]] = pos + np.flatnonzero(new)
        pos += hi - lo
    over = touch >= 0
    if mode == 2:
        acc64 = np.sqrt(acc64)
    elif mode == 1:
        acc += (np.float32(200.0) - xs) - ys
        acc64 += 200.0
    else:
        q = pct.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc64 /= np.sqrt(np.sum(q * q)) * ref.y_l2n
    return (np.where(over, acc, np.float32(0.0)), touch,
            np.where(over, acc64, 0.0))


def text(ref: Postings, names: list[str], measure: np.ndarray,
         touch: np.ndarray, pct: np.ndarray, mode: int
         ) -> tuple[str, np.ndarray]:
    """One query's block as the reference tool prints it, and its samples
    in the block's order."""
    ids = np.flatnonzero(touch >= 0)
    ids = ids[np.argsort(touch[ids], kind="stable")]
    m = measure[ids]
    if mode == 0:
        x2 = np.float32(0.0)
        for x in pct.astype(np.float32):
            x2 = np.float32(x2 + x * x)
        m = (m.astype(np.float64)
             / (math.sqrt(float(x2)) * ref.y_l2n[ids])).astype(np.float32)
    order = np.argsort(m, kind="stable")
    if mode == 0:
        order = order[::-1]
    vals = m[order].astype(np.float64)
    if mode == 2:
        vals = np.sqrt(vals)
    ids = ids[order]
    return f"#Sample\t{HEADERS[mode]}\n" + "".join(
        f"{names[i]}\t{v:f}\n" for i, v in zip(ids.tolist(),
                                               vals.tolist())), ids


@dataclasses.dataclass
class Answer:
    """One compared call: its queries (sparse), what
    ``postings_search_batch`` returned and the text the call wrote."""
    queries: list[tuple[np.ndarray, np.ndarray]]
    measure: np.ndarray | None    # float32 [B, N]
    touch: np.ndarray | None      # int64 [B, N]
    text: str


def _blocks(text_: str) -> tuple[list[str], str]:
    """The text cut into one block a query, and what precedes the
    first."""
    parts = text_.split("#Sample\t")
    return ["#Sample\t" + p for p in parts[1:]], parts[0]


def _line_faults(got: str, want: str) -> int:
    if got == want:
        return 0
    a, b = got.split("\n"), want.split("\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _printed_gap(block: str, want: str, want_ids: np.ndarray,
                 name_id: dict, ids_ref: np.ndarray, val_ref: np.ndarray
                 ) -> float:
    """The widest relative gap of the block's printed values to the
    float64 reference (``ids_ref``, ``val_ref``); a block whose lines do
    not parse reads inf.  A block equal to the reference's (``want``,
    naming ``want_ids``) needs no look-up of its names."""
    lines = block.split("\n")[1:]
    if lines and lines[-1] == "":
        lines.pop()
    if not lines:
        return 0.0
    cells = "\t".join(lines).split("\t")
    if len(cells) != 2 * len(lines):
        return math.inf
    if block == want:
        ids = want_ids
    else:
        ids = np.fromiter((name_id.get(c, -1) for c in cells[0::2]),
                          dtype=np.int64, count=len(lines))
    try:
        vals = np.asarray(cells[1::2], dtype=np.float64)
    except ValueError:
        return math.inf
    if ids_ref.size == 0:
        return 0.0
    pos = np.minimum(np.searchsorted(ids_ref, ids), ids_ref.size - 1)
    known = ids_ref[pos] == ids
    return _gap(vals[known], val_ref[pos[known]])


def judge(ref: Postings, names: list[str], answers: list[Answer],
          mode: int, limits: dict, staged, batch_observed: bool = True
          ) -> tuple[list[Check], int]:
    """The checks of a run (``staged``: the program's (offsets,
    checksums), or None where none was found) and the number of compared
    queries that failed one of them."""
    name_id = {n: i for i, n in enumerate(names)}
    measure_wrong = touch_wrong = text_wrong = failed = 0
    text_gap = 0.0
    for ans in answers:
        want_blocks, q_faults, f64 = [], [], []
        for b, (sp, pc) in enumerate(ans.queries):
            m_ref, t_ref, m64 = walk(ref, sp, pc, mode)
            want_blocks.append(text(ref, names, m_ref, t_ref, pc, mode))
            ids = np.flatnonzero(t_ref >= 0)
            f64.append((ids, m64[ids]))
            q_bad = 0
            if batch_observed:
                if ans.measure is None or b >= ans.measure.shape[0]:
                    q_bad = t_ref.size
                    touch_wrong += t_ref.size
                    measure_wrong += int(np.sum(t_ref >= 0))
                else:
                    over = t_ref >= 0
                    mw = int(np.sum(ans.measure[b][over].view(np.int32)
                                    != m_ref[over].view(np.int32)))
                    tw = int(np.sum(ans.touch[b] != t_ref))
                    measure_wrong += mw
                    touch_wrong += tw
                    q_bad = mw + tw
            q_faults.append(q_bad)
        got_blocks, before = _blocks(ans.text)
        if before:
            text_wrong += before.count("\n") or 1
        for b, (want, want_ids) in enumerate(want_blocks):
            got = got_blocks[b] if b < len(got_blocks) else ""
            tw = _line_faults(got, want)
            gap = _printed_gap(got, want, want_ids, name_id,
                               *f64[b]) if got else math.inf
            text_wrong += tw
            text_gap = max(text_gap, gap)
            if q_faults[b] or tw or not gap <= limits["text_gap"]:
                failed += 1
        for extra in got_blocks[len(want_blocks):]:
            text_wrong += extra.count("\n") or 1
    got = {"index_wrong": (index_wrong(staged, ref)
                           if staged is not None else None),
           "measure_wrong": measure_wrong if batch_observed else None,
           "touch_wrong": touch_wrong if batch_observed else None,
           "text_wrong": text_wrong,
           "text_gap": text_gap}
    return [Check(k, v, limits[k]) for k, v in got.items()
            if v is not None], failed
