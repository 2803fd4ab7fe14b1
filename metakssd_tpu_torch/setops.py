"""Lossless sketch set algebra on a device: the port of
``metakssd_tpu/setops.py`` (reference command_set.c).

* ``sketch_union`` (-u) and ``uniq_sketch_union`` (-q): a device sort per
  component and data shard (``parallel.mesh.device_union`` over every
  visible device and every rank), with exact counts for the k-mers present
  in exactly one genome.
* ``sketch_operate`` (-s / -i): the membership of every genome's ids in the
  sorted pan is one K3 call (``ops.merge``) per component, in identity
  mode, through the pan's ``StaticHaystack`` index; the per-genome kept
  counts are a prefix sum read at the index bounds.
* ``grouping_genomes`` (-g): ``organize_taxf`` gives the
  reference's taxon order, then one device sort and unique over 64-bit
  ``(taxon << 32) | id`` keys yields every taxon's pan at once.
* ``combine_pans`` (-c), ``combine_queries``, ``organize_taxf`` and
  ``print_gnames`` (-P) do host work only and are copied from the JAX
  package.

The device is explicit (``"cuda"``, ``"cpu"`` or ``"host"``): the JAX
package's ``MKSSD_DEVICE_SETOPS`` switch, its 4M-id floor and its backend
policy do not carry over.  ``"host"`` takes the JAX package's host routes:
the unions through ``host_unique`` (the native radix sort from 2^20 ids),
``-s/-i`` membership through ``np.searchsorted``
(``merge.host_membership``); ``-g`` runs as on ``"cpu"``.  Every file is
byte-identical to ``metakssd_tpu.setops``'s.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from metakssd_tpu_torch.device import engine, resolve_device
from metakssd_tpu_torch.formats.codir import (IDX_PREFIX, PAN_PREFIX,
                                              SKCH_PREFIX, UNIQ_PAN_PREFIX,
                                              CoDir)
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.io import native
from metakssd_tpu_torch.ops import merge
from metakssd_tpu_torch.ops.sketch_cuda import _as_u32_bits
from metakssd_tpu_torch.params import LD_FCTR
from metakssd_tpu_torch.parallel.mesh import device_union, make_mesh
from metakssd_tpu_torch.utils import TIMER, sorted_first_idx

_LOW32 = 0xFFFFFFFF
# ids from which host_unique sorts by the native radix sort
# (metakssd_tpu/setops.py:67)
HOST_RADIX_MIN = 1 << 20


def host_unique(ids: np.ndarray, return_counts: bool):
    """``np.unique`` of ``ids`` on the host: the native radix sort and one
    boundary pass from HOST_RADIX_MIN ids, where the ids are at most 32
    bits wide (wider ones would merge ids sharing their low 32 bits), else
    ``np.unique`` (``metakssd_tpu.setops._host_unique``)."""
    ids = np.asarray(ids)
    if ids.size < HOST_RADIX_MIN or ids.dtype.itemsize > 4:
        return np.unique(ids, return_counts=return_counts)
    sk = np.empty(ids.size, np.uint32)
    np.copyto(sk, ids, casting="unsafe")
    native.radix_sort_u32(sk)
    idx = sorted_first_idx(sk)
    vals = sk[idx]
    if not return_counts:
        return vals
    counts = np.empty(idx.size, np.int64)
    counts[:-1] = np.diff(idx)
    counts[-1] = sk.size - idx[-1]
    return vals, counts


def _union_on(device):
    """The union verbs' unique for ``device``: ``host_unique`` where the
    host engine takes them, else ``device_union`` on a one-device mesh."""
    if engine(device):
        return host_unique
    mesh = make_mesh(None, 1, device)
    return lambda ids, counts: device_union(ids, mesh, return_counts=counts)


def sketch_union(insketch: str, outdir: str, *, device) -> None:
    """-u: the union of all sketches -> ``pan.c``."""
    union = _union_on(device)
    with TIMER.stage("set.union"):
        cd = CoDir.read(insketch, want_abund=False)
        os.makedirs(outdir, exist_ok=True)
        cd.stat.write(outdir)
        for c in range(cd.stat.comp_num):
            union(cd.ids[c], False).tofile(
                os.path.join(outdir, f"{PAN_PREFIX}.{c}"))


def uniq_sketch_union(insketch: str, outdir: str, *, device) -> None:
    """-q: the k-mers present in exactly one genome -> ``uniq_pan.c``."""
    union = _union_on(device)
    with TIMER.stage("set.uniq_union"):
        cd = CoDir.read(insketch, want_abund=False)
        os.makedirs(outdir, exist_ok=True)
        cd.stat.write(outdir)
        for c in range(cd.stat.comp_num):
            vals, counts = union(cd.ids[c], True)
            vals[counts == 1].tofile(
                os.path.join(outdir, f"{UNIQ_PAN_PREFIX}.{c}"))


def _read_pan(pan_dir: str, c: int) -> np.ndarray:
    for prefix in (PAN_PREFIX, UNIQ_PAN_PREFIX):
        p = os.path.join(pan_dir, f"{prefix}.{c}")
        if os.path.exists(p):
            return np.fromfile(p, dtype=np.uint32)
    raise FileNotFoundError(f"no pan.{c} / uniq_pan.{c} in {pan_dir}")


def sketch_operate(insketch: str, pan_dir: str, outdir: str,
                   intersect: bool, *, device) -> None:
    """-s (subtract) / -i (intersect) every genome against a pan sketch,
    keeping each genome's entries in their order."""
    host = engine(device)
    dev = resolve_device(device)
    with TIMER.stage("set.operate"):
        cd = CoDir.read(insketch, want_abund=False)
        pan_stat = CoStat.read(pan_dir)
        if pan_stat.shuf_id != cd.stat.shuf_id:
            raise ValueError(f"sketching id not match ({cd.stat.shuf_id} "
                             f"vs. {pan_stat.shuf_id})")
        os.makedirs(outdir, exist_ok=True)
        new_ctx = np.zeros(cd.stat.infile_num, dtype=np.uint64)
        for c in range(cd.stat.comp_num):
            pan = np.sort(_read_pan(pan_dir, c))
            ids = merge.u32_tensor(cd.ids[c]).to(dev)
            if host:
                member = torch.from_numpy(
                    merge.host_membership(pan, cd.ids[c])[0])
            else:
                hay = merge.StaticHaystack(pan, None, dev)
                member, _ = merge.member(hay.hay, None, ids, hay.index)
            keep = member.bool() if intersect else member == 0
            ids[keep].cpu().numpy().view(np.uint32).tofile(
                os.path.join(outdir, f"{SKCH_PREFIX}.{c}"))
            kept_cum = torch.zeros(ids.numel() + 1, dtype=torch.int64,
                                   device=dev)
            kept_cum[1:] = torch.cumsum(keep, 0)
            bounds = torch.from_numpy(
                cd.index[c].astype(np.int64)).to(dev)
            index = (kept_cum[bounds] - kept_cum[bounds[0]]).cpu().numpy()
            index.astype(np.uint64).tofile(
                os.path.join(outdir, f"{IDX_PREFIX}.{c}"))
            new_ctx += np.diff(index).astype(np.uint64)
        # the reference keeps the original header (all_ctx_ct included)
        # but re-counts ctx_ct (command_set.c:345-346,402)
        CoStat(cd.stat.shuf_id, cd.stat.koc, cd.stat.kmerlen,
               cd.stat.dim_rd_len, cd.stat.comp_num, cd.stat.all_ctx_ct,
               new_ctx.astype(np.uint32), list(cd.stat.names)).write(outdir)


def combine_pans(pan_dirs: list[str], outdir: str) -> None:
    """-c: each pan dir becomes one genome of a combined sketch
    (reference command_set.c:515-608)."""
    with TIMER.stage("set.combine_pans"):
        st0 = CoStat.read(pan_dirs[0])
        os.makedirs(outdir, exist_ok=True)
        ctx = np.zeros(len(pan_dirs), dtype=np.uint32)
        for c in range(st0.comp_num):
            chunks = []
            for i, d in enumerate(pan_dirs):
                sti = CoStat.read(d)
                if sti.shuf_id != st0.shuf_id:
                    raise ValueError("combin_pans: shuf_id mismatch")
                arr = _read_pan(d, c)
                chunks.append(arr)
                ctx[i] += arr.size
            index = np.zeros(len(pan_dirs) + 1, dtype=np.uint64)
            np.cumsum([ch.size for ch in chunks], out=index[1:])
            np.concatenate(chunks).astype(np.uint32).tofile(
                os.path.join(outdir, f"{SKCH_PREFIX}.{c}"))
            index.tofile(os.path.join(outdir, f"{IDX_PREFIX}.{c}"))
        stat = CoStat(st0.shuf_id, st0.koc, st0.kmerlen, st0.dim_rd_len,
                      st0.comp_num, int(ctx.sum()), ctx, list(pan_dirs))
        stat.write(outdir)


def combine_queries(co_dirs: list[str], outdir: str) -> None:
    """Merge multiple sketch dirs, concatenating genomes
    (reference combine_queries, command_dist.c:1718-1919)."""
    stats = [CoStat.read(d) for d in co_dirs]
    st0 = stats[0]
    for st in stats[1:]:
        if st.shuf_id != st0.shuf_id or st.comp_num != st0.comp_num:
            raise ValueError("combine_queries: incompatible sketch dirs")
    cds = [CoDir.read(d) for d in co_dirs]
    koc = all(st.koc for st in stats)
    os.makedirs(outdir, exist_ok=True)
    names, ctx = [], []
    for st in stats:
        names.extend(st.names)
        ctx.extend(st.ctx_ct.tolist())
    for c in range(st0.comp_num):
        ids = np.concatenate([cd.ids[c] for cd in cds])
        counts = np.concatenate(
            [np.diff(cd.index[c].astype(np.int64)) for cd in cds])
        index = np.zeros(len(ctx) + 1, dtype=np.uint64)
        np.cumsum(counts, out=index[1:])
        ids.astype(np.uint32).tofile(os.path.join(outdir, f"{SKCH_PREFIX}.{c}"))
        index.tofile(os.path.join(outdir, f"{IDX_PREFIX}.{c}"))
        if koc:
            np.concatenate([cd.abund[c] for cd in cds]).astype(
                np.uint16).tofile(os.path.join(outdir, f"{SKCH_PREFIX}.{c}.a"))
    stat = CoStat(st0.shuf_id, koc, st0.kmerlen, st0.dim_rd_len,
                  st0.comp_num, int(np.sum(ctx)),
                  np.asarray(ctx, dtype=np.uint32), names)
    stat.write(outdir)


def next_prime(n: int) -> int:
    """reference global_basic.c:453."""
    while True:
        for j in range(2, int(math.isqrt(n)) + 1):
            if n % j == 0:
                break
        else:
            return n
        n += 1


def organize_taxf(taxfile: str) -> list[tuple[int, str | None, list[int]]]:
    """Parse 'taxid<TAB>[name]' lines; group genome line-numbers by taxid.

    Returns taxa in the reference's hash-slot iteration order
    (command_set.c:635-705) so grouped-genome indexes match across
    toolchains.
    """
    with open(taxfile) as f:
        lines = f.read().splitlines()
    ln = len(lines)
    hashsz = next_prime(int(ln / LD_FCTR))
    slots: list[tuple[int, str | None, list[int]] | None] = [None] * hashsz

    def h(key: int, i: int) -> int:
        return (key % hashsz + i * (1 + key % (hashsz - 1))) % hashsz

    for i, line in enumerate(lines):
        parts = line.split("\t")
        taxid = int(parts[0])
        taxname = parts[1] if len(parts) > 1 and parts[1] else None
        for n in range(hashsz):
            hv = h(taxid, n)
            if slots[hv] is None:
                slots[hv] = (taxid, taxname, [i])
                break
            if slots[hv][0] == taxid:
                if slots[hv][1] != taxname:
                    raise ValueError(
                        f"taxid {taxid} has different taxnames")
                slots[hv][2].append(i)
                break
    return [s for s in slots if s is not None]


def grouping_genomes(insketch: str, taxfile: str, outdir: str, *,
                     device) -> None:
    """-g: one union pan-sketch per taxon, in the reference's taxon
    order; taxid 0 is dropped."""
    dev = resolve_device(device)
    with TIMER.stage("set.grouping"):
        taxa = organize_taxf(taxfile)
        cd = CoDir.read(insketch, want_abund=False)
        gn = sum(len(t[2]) for t in taxa)
        if cd.stat.infile_num != gn:
            raise ValueError(
                f"genome number {cd.stat.infile_num} does not match taxfile "
                f"genome number {gn}")
        os.makedirs(outdir, exist_ok=True)
        out_taxa = [t for t in taxa if t[0] != 0]
        taxon_of = np.full(gn, -1, dtype=np.int64)
        for ti, (_, _, gids) in enumerate(out_taxa):
            taxon_of[gids] = ti
        taxon_of = torch.from_numpy(taxon_of).to(dev)
        ctx = np.zeros(len(out_taxa), dtype=np.uint64)
        for c in range(cd.stat.comp_num):
            lens = torch.from_numpy(
                np.diff(cd.index[c].astype(np.int64))).to(dev)
            taxon = torch.repeat_interleave(taxon_of, lens)
            ids = merge.u32_tensor(cd.ids[c]).to(dev).to(torch.int64) \
                & _LOW32
            mine = taxon >= 0
            keys = torch.unique((taxon[mine] << 32) | ids[mine], sorted=True)
            del taxon, ids, mine
            counts = torch.bincount(keys >> 32, minlength=len(out_taxa))
            _as_u32_bits(keys & _LOW32).cpu().numpy().view(np.uint32).tofile(
                os.path.join(outdir, f"{SKCH_PREFIX}.{c}"))
            counts = counts.cpu().numpy().astype(np.uint64)
            index = np.zeros(len(out_taxa) + 1, dtype=np.uint64)
            np.cumsum(counts, out=index[1:])
            index.tofile(os.path.join(outdir, f"{IDX_PREFIX}.{c}"))
            ctx += counts
        names = [f"{t[0]}_{t[1]}" if t[1] else str(t[0]) for t in out_taxa]
        CoStat(cd.stat.shuf_id, False, cd.stat.kmerlen, cd.stat.dim_rd_len,
               cd.stat.comp_num, int(ctx.sum()), ctx.astype(np.uint32),
               names).write(outdir)


def print_gnames(insketch: str) -> None:
    st = CoStat.read(insketch)
    for i in range(st.infile_num):
        print(f"{int(st.ctx_ct[i])}\t{st.names[i]}")
