"""The one-load filter in front of the sketch kernels' exact search.

Only ``n_accept / 16**subk`` of random windows have an accepted inner
substring ``dim`` (1 in 4096 at k=11, subk=6, drlevel=3), so K1 and K2
(``csrc/sketch.cu``) first test one bit of a bitmap in shared memory per
window and run the exact search only where it is set.  The bitmap has
``2**log2`` bits:

* ``log2 == 4 * subk`` (*direct*): bit ``dim`` itself, so exactly the
  accepted dims pass;
* otherwise (*folded*): bit ``(dim * FOLD_MULT mod 2**32) >> (32 - log2)``.
  Every accepted dim sets its bit, so none is lost; of the other dims
  about ``n_accept / 2**log2`` pass and fail the exact search, which costs
  time and never output.

These are the plain torch functions; the kernels compute the same index.
"""

from __future__ import annotations

import torch

FOLD_MULT = 0x9E3779B1      # odd, so the product permutes the 32-bit words
BITS_PER_ENTRY = 64         # bitmap bits per accepted dim, at least
MAX_LOG2 = 19               # the kernels' largest bitmap (64 KiB)
MIN_LOG2 = 10


def default_log2(n_accept: int, subk: int) -> int:
    """log2 of the bitmap's bits for a table of ``n_accept`` dims: the
    power of two that gives each entry at least BITS_PER_ENTRY bits
    (capped at the kernels' largest, which still gives the largest table
    of the kernel path, 16384 entries, 32 bits each), or ``16**subk``
    bits, a direct bitmap, where that is no more.  So the 4096-entry
    tables of subk >= 5 fold to 2^18 bits (32 KiB, 1.6% of windows pass)
    and subk = 4 is direct (8 KiB).  On an H100 the 32 KiB fold, with
    four blocks to an SM, beat a direct 2^20-bit bitmap of subk = 5,
    which left room for one block (PERF.md, Findings), so the kernels
    take no bitmap of that size."""
    want = max(MIN_LOG2, (BITS_PER_ENTRY * n_accept - 1).bit_length())
    return min(want, MAX_LOG2, 4 * subk)


def is_direct(log2: int, subk: int) -> bool:
    return log2 == 4 * subk


def check_log2(log2: int, subk: int) -> None:
    if not (4 <= log2 <= MAX_LOG2 and log2 <= 4 * subk):
        raise ValueError(f"filter of 2^{log2} bits for subk = {subk}: need "
                         f"4 <= log2 <= min({MAX_LOG2}, 4*subk)")


def filter_index(dim: torch.Tensor, log2: int, subk: int) -> torch.Tensor:
    """Bit index of each ``dim`` (int64 values below 16**subk)."""
    if is_direct(log2, subk):
        return dim
    return ((dim * FOLD_MULT) & 0xFFFFFFFF) >> (32 - log2)


def n_words(log2: int) -> int:
    return max(1, (1 << log2) >> 5)


def build_filter(accept: torch.Tensor, subk: int, log2: int) -> torch.Tensor:
    """The bitmap of a sorted accept table (int32 tensor holding u32
    bits) -> int32 [n_words] on the same device, bit i in word i >> 5 at
    position i & 31 (u32 bits in int32, as the tables travel)."""
    check_log2(log2, subk)
    idx = filter_index(accept.to(torch.int64) & 0xFFFFFFFF, log2, subk)
    bits = torch.zeros(n_words(log2) * 32, dtype=torch.bool,
                       device=accept.device)
    bits[idx] = True
    weights = torch.ones(32, dtype=torch.int64, device=accept.device) \
        << torch.arange(32, device=accept.device)
    words = (bits.view(-1, 32).to(torch.int64) * weights).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def bits_set(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bool: whether bit ``idx`` (int64) is set in the bitmap ``words``."""
    w = words.to(torch.int64)[idx >> 5] & 0xFFFFFFFF
    return ((w >> (idx & 31)) & 1).bool()


# ---------------------------------------------------------------------------
# streams that exercise the filter (for the tests and the smoke run)
# ---------------------------------------------------------------------------

def false_positive_dims(accept: torch.Tensor, words: torch.Tensor, log2: int,
                        subk: int, draws: int, seed: int):
    """Distinct dims (numpy int64) among ``draws`` random ones that pass
    the bitmap and are not accepted: a window holding one goes through the
    exact search and is dropped.  Empty for a direct bitmap."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dims = torch.from_numpy(np.unique(rng.integers(0, 1 << (4 * subk),
                                                   draws)))
    acc = (accept.cpu().to(torch.int64) & 0xFFFFFFFF)
    passed = bits_set(words.cpu(), filter_index(dims, log2, subk))
    return dims[passed & ~torch.isin(dims, acc)].numpy()


def codes_with_dims(dims, p, seed: int):
    """A uint8 code stream of k-mers laid end to end, one per entry of
    ``dims`` whose k-mer can carry it: random outer bases around the inner
    substring ``dim``, kept where the forward tuple is the canonical one
    (so the window at each multiple of 2k has exactly that dim).  Returns
    (codes, the dims kept, in stream order)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dims = np.asarray(dims, np.int64)
    TL, oc = p.kmer_len, p.outctx
    inner = (dims[:, None] >> (2 * np.arange(2 * p.subk - 1, -1, -1))) & 3
    kmers = np.concatenate([rng.integers(0, 4, (dims.size, oc)), inner,
                            rng.integers(0, 4, (dims.size, oc))], axis=1)
    place = 2 * np.arange(TL - 1, -1, -1)
    fwd = (kmers << place).sum(axis=1)
    rc = ((3 - kmers[:, ::-1]) << place).sum(axis=1)
    keep = fwd <= rc
    return kmers[keep].astype(np.uint8).reshape(-1), dims[keep]
