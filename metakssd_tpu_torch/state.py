"""State carried from the host structures onto the device.

Four pieces of state cross over unchanged in content:

* the sketch filter tables, ``DimShuffle.device_tables()``'s
  ``(accept_tups, pfilters)`` (numpy uint32), which become int32 tensors
  with the same bits (``formats/shuf.py:63-74``): accepted substrings are
  below 2^28 and pfilters below 2^28 on every supported config, so no
  value changes sign;
* the staged MarkerDB, the per-component ``(rk, starts, gid_sorted)``
  arrays that ``composite.stage_markerdb`` builds or mmaps from its
  ``.mkssd_stage/c{c}.{rk,st,gs}.npy`` sidecars, which become the port's
  device profile index;
* a sketch dir's per-component inverted index,
  ``mco_fmt.InvertedIndex.from_codir``'s ``(kmers, offsets, gids)``,
  whose sorted distinct k-mers become the dist search haystack (u32 bits
  in int32, as above) with K3's search index (``ops/merge.MemberIndex``);
  offsets and gids stay on the host, where the postings are counted;
* an abv index, ``AbvIndex`` (``formats/abv.py``), whose postings become
  the dense [nsamples, nspecies] float32 matrix of ``ops/dense_abv.py``,
  equal to the JAX ``DenseAbv.from_index``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metakssd_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AcceptTables:
    """The sorted accept table and its aligned pfilters on one device."""
    accept: torch.Tensor        # int32 [n], ascending
    pfilter: torch.Tensor       # int32 [n]
    shuf_len: int               # 16**subk, the substring space
    filter: torch.Tensor        # int32 [words]: the kernels' filter bitmap
    filter_log2: int            # log2 of its bits (ops/sketch_filter.py)

    @property
    def size(self) -> int:
        return int(self.accept.numel())


def make_accept_tables(accept: np.ndarray, pfilter: np.ndarray, subk: int,
                       device, filter_log2: int | None = None
                       ) -> AcceptTables:
    """Tables and their filter bitmap from a sorted uint32 accept array
    and its aligned pfilters.  ``filter_log2`` overrides the bitmap's
    default size (``sketch_filter.default_log2``)."""
    from metakssd_tpu_torch.ops import sketch_filter
    dev = resolve_device(device)
    acc = torch.from_numpy(np.asarray(accept, np.uint32)
                           .astype(np.int32)).to(dev)
    if filter_log2 is None:
        filter_log2 = sketch_filter.default_log2(int(acc.numel()), subk)
    return AcceptTables(
        accept=acc,
        pfilter=torch.from_numpy(np.asarray(pfilter, np.uint32)
                                 .astype(np.int32)).to(dev),
        shuf_len=1 << (4 * subk),
        filter=sketch_filter.build_filter(acc, subk, filter_log2),
        filter_log2=filter_log2)


def accept_tables(shuf, device) -> AcceptTables:
    tups, pf = shuf.device_tables()[:2]
    return make_accept_tables(tups, pf, shuf.params.subk, device)


def profile_index_from_staged(comp_idx: list, nref: int, device):
    """The port's ``DeviceProfileIndex`` from ``stage_markerdb``'s
    per-component indexes (``None`` for empty components): the exact
    arrays the JAX package stages, whether built or mmapped."""
    from metakssd_tpu_torch.ops.profile_device import DeviceProfileIndex
    comps = [None if ci is None else
             (np.asarray(ci.rk), np.asarray(ci.starts),
              np.asarray(ci.gid_sorted))
             for ci in comp_idx]
    return DeviceProfileIndex(comps, nref, device)


def haystack_from_inverted(inv, device):
    """The port's ``StaticHaystack`` of one component's inverted index, in
    identity mode (the value of a hit is its posting row), with K3's
    search index built once on ``device``."""
    from metakssd_tpu_torch.ops.merge import StaticHaystack
    return StaticHaystack(inv.kmers, None, device)


def dense_abv_from_index(idx, nspecies: int, device):
    """The port's ``DenseAbv`` of an abv index, built on ``device``: the
    arrays of ``metakssd_tpu``'s ``DenseAbv.from_index(idx, nspecies)``.

    ``idx`` is an ``AbvIndex`` (its postings are scattered into the dense
    matrix on the device), or a JAX ``DenseAbv`` whose ``names``, ``mat``
    and ``y_l2n`` are taken as numpy arrays."""
    from metakssd_tpu_torch.ops.dense_abv import DenseAbv
    dev = resolve_device(device)
    if hasattr(idx, "mat"):
        mat = np.array(idx.mat, np.float32)
        y_l2n = np.array(idx.y_l2n, np.float32)
        return DenseAbv(list(idx.names), torch.from_numpy(mat).to(dev),
                        torch.from_numpy(y_l2n).to(dev))
    counts = np.diff(np.concatenate([[0], idx.abmi]).astype(np.int64))
    mat = torch.zeros((len(idx.names), nspecies), dtype=torch.float32,
                      device=dev)
    dims = torch.repeat_interleave(
        torch.arange(nspecies, device=dev),
        torch.from_numpy(counts).to(dev))
    mat[torch.from_numpy(idx.abm_idx.astype(np.int64)).to(dev), dims] = \
        torch.from_numpy(idx.abm_pct.astype(np.float32)).to(dev)
    return DenseAbv(list(idx.names), mat, torch.from_numpy(
        idx.y_l2n.astype(np.float32)).to(dev))
