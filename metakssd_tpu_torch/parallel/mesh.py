"""One-device counterparts of ``metakssd_tpu/parallel/mesh.py``.

``device_union`` ports ``_union_step``/``device_union``
(``mesh.py:541-631``): the distinct values of a u32 multiset, with exact
counts when asked, by one sort on the device.  The JAX step pads with
0xFFFFFFFF, masks it out on the device and puts it back on the host, and
caps each device's counts at 2; here no value is a pad and every count is
exact.

``sharded_shared_counts`` is the ``--shard-db`` route of dist search: the
port of ``sharded_shared_counts`` with a db axis of 1, which takes
``_expansion_shared_counts`` (``mesh.py:268-358``).

Query membership runs on the host against each component's distinct
k-mers, as in the JAX step.  The device expands only the matched rows'
postings into the port's [subrows, SUBW] tile (``ops/profile_device.py``
``SubrowTable``/``_expand_tile``) and adds each posting's query
multiplicity into its genome's count with an int64 ``index_add_``: exact
for any count, where the JAX step sorts and differences a u32 prefix sum.
A query k-mer counts once per occurrence (per-read sketches repeat
k-mers; reference command_dist.c:1044-1049).

``ShardedMatchIndex`` is the ``--shard-db`` route of ``composite`` and
``profile``: the port of ``ShardedMatchIndex`` (``mesh.py:449-535``) for
one shard.  A component's sorted distinct k-mers stay on the device as a
``StaticHaystack`` with K3's index, and K3 (``ops/merge.member``) gives
each query id's lower-bound row and member flag, where the JAX step runs
``jnp.searchsorted`` on its shard; the posting expansion is the JAX
package's, on the host.  K3 needs no pad, so a query id 0xFFFFFFFF
matches when the MarkerDB holds it, as on the serial path.

More than one db shard needs torch.distributed and is ROADMAP.md's port
queue item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.dist import MAX_NEEDLES
from metakssd_tpu_torch.formats import mco as mco_fmt
from metakssd_tpu_torch.formats.codir import CoDir
from metakssd_tpu_torch.ops.merge import (StaticHaystack, sorted_membership,
                                          u32_tensor)
from metakssd_tpu_torch.ops.profile_device import SubrowTable, _expand_tile

# XOR with the sign bit maps the u32 order onto the int32 order, so the
# keys sort as 4-byte ints (a plain int32 bit view puts keys >= 2^31 first).
_U32_FLIP = -(1 << 31)


def device_union(ids, device, return_counts: bool = False):
    """``np.unique(ids)`` of a uint32 array, sorted on ``device``: the
    distinct values ascending, and with ``return_counts`` their exact
    occurrence counts (int64)."""
    dev = resolve_device(device)
    if np.size(ids) == 0:
        empty = np.zeros(0, np.uint32)
        return (empty, np.zeros(0, np.int64)) if return_counts else empty
    x = u32_tensor(ids).to(dev) ^ _U32_FLIP
    got = torch.unique(x, sorted=True, return_counts=return_counts)
    vals, counts = got if return_counts else (got, None)
    vals = (vals ^ _U32_FLIP).cpu().numpy().view(np.uint32)
    if not return_counts:
        return vals
    return vals, counts.cpu().numpy().astype(np.int64)


def _subrow_counts(sub: SubrowTable, subs: np.ndarray, weight: np.ndarray,
                   nref: int, device) -> np.ndarray:
    """int64 [nref]: the weights of the matched subrows' postings, summed
    per genome on the device."""
    g, valid = _expand_tile(sub, torch.from_numpy(subs).to(device),
                            subs.size, nref)
    w = torch.from_numpy(weight.astype(np.int64)).to(device)
    w = torch.where(valid, w[:, None], torch.zeros_like(g))
    counts = torch.zeros(nref + 1, dtype=torch.int64, device=device)
    counts.index_add_(0, g.reshape(-1), w.reshape(-1))
    return counts[:nref].cpu().numpy()


def check_shards(n_db: int) -> None:
    """Raise for a db axis of more than one shard (ROADMAP.md item 8)."""
    if n_db > 1:
        raise NotImplementedError(
            f"--shard-db {n_db} is not ported to metakssd_tpu_torch yet "
            "(ROADMAP.md, port queue item 8); --shard-db 1 runs on one "
            "device")


def sharded_shared_counts(ref, qry, n_db: int, device) -> np.ndarray:
    """uint32 [qry_num, ref_num] shared-k-mer counts by matched-row
    expansion, ``--shard-db n_db``: one shard, on one device, for now."""
    check_shards(n_db)
    dev = resolve_device(device)
    if isinstance(ref, str):
        ref = CoDir.read(ref, want_abund=False)
    if isinstance(qry, str):
        qry = CoDir.read(qry, want_abund=False)
    num_refs = ref.stat.infile_num
    nqry = qry.stat.infile_num
    out = np.zeros((nqry, num_refs), dtype=np.uint32)
    for c in range(ref.stat.comp_num):
        inv = mco_fmt.InvertedIndex.from_codir(ref, c)
        if inv.kmers.size == 0:
            continue
        sub = SubrowTable(inv.offsets.astype(np.int64), inv.gids, dev)
        rk = np.asarray(inv.kmers)
        for q in range(nqry):
            uq, mult = np.unique(qry.genome_ids(c, q), return_counts=True)
            pos = np.minimum(np.searchsorted(rk, uq), rk.size - 1)
            member = rk[pos] == uq
            subs, wsub = sub.expand_rows(pos[member], mult[member])
            if subs.size:
                out[q] += _subrow_counts(sub, subs, wsub, num_refs,
                                         dev).astype(np.uint32)
    return out


class ShardedMatchIndex:
    """A MarkerDB component's match index for ``--shard-db n_db`` (one
    shard, on one device, for now): drop-in for ``composite._CompIndex``.
    ``match`` returns the matched postings' genomes and the matching
    query ids' abundances, the JAX package's (``mesh.py:506-535``)."""

    def __init__(self, rk, starts, gid_sorted, device, n_db: int = 1):
        check_shards(n_db)
        self.starts = np.asarray(starts)
        self.gid_sorted = np.asarray(gid_sorted)
        self.nk = np.size(rk)
        self.hay = StaticHaystack(rk, None, device)

    def match(self, qids_s: np.ndarray, qab_s: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        if qids_s.size == 0 or self.nk == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.uint16))
        # K3 on the haystack's device, one call per MAX_NEEDLES ids
        member = np.zeros(qids_s.size, bool)
        rows = np.zeros(qids_s.size, np.int64)
        for lo in range(0, qids_s.size, MAX_NEEDLES):
            m, pos = sorted_membership(self.hay, None,
                                       qids_s[lo:lo + MAX_NEEDLES])
            member[lo:lo + m.size] = m
            rows[lo:lo + m.size] = pos
        rows, ab = rows[member], qab_s[member]
        st, en = self.starts[rows], self.starts[rows + 1]
        lens = en - st
        total = int(lens.sum())
        if total == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.uint16))
        bnd = np.zeros(rows.size, dtype=np.int64)
        np.cumsum(lens[:-1], out=bnd[1:])
        flat = (np.arange(total, dtype=np.int64)
                - np.repeat(bnd, lens) + np.repeat(st, lens))
        return (self.gid_sorted[flat].astype(np.int32),
                np.repeat(ab, lens))
