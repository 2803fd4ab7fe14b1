"""Shards, processes and the sharded steps: the port of
``metakssd_tpu/parallel/mesh.py``.

A :class:`Mesh` (``make_mesh``) is a grid of ``n_data x n_db`` shards, each
with the rank that owns it and its ``torch.device``.  In one process the
shards are dealt round-robin over the devices that ``--device`` names
(``cuda``: shard i on ``cuda:(i % device_count)``; ``cpu``: all on the
CPU).  Across processes (``init_distributed``, the ``MKSSD_COORDINATOR``
launch) the data axis spans the ranks and the db axis stays within one,
as the JAX mesh puts the data axis over hosts; rank r works on
``cuda:(r % device_count)``.

The collectives stand in for ``all_gather``/``psum`` (``gather_arrays``:
sizes first, then padded bytes; ``all_sum``: an int64 all-reduce).  The
join (``init_distributed``) forms a gloo group for the store, the barrier,
numpy arrays and CPU tensors and, where the job runs on CUDA and every
rank holds a card of its own, an NCCL group for card tensors
(``choose_backend``), which the JAX package gets from its device mesh
(``mesh.py:14-20, 107``).  So the merges below keep their parts on the
rank's card and cross over NCCL; where ranks share a card (NCCL refuses
that) the same card tensors cross over gloo on the host.  Where a group
was joined every collective crosses it, one rank included; without one
they are the identity.  Only merged results cross: per-shard sketches,
count rows, distinct-value runs.  ``COLLECTIVES`` counts the calls and
bytes by backend.

* ``sharded_sketch`` (``mesh.py:634-704``, ``--mesh N``): the code stream
  cut into ``n_data`` shards of ``ceil(nwin / n_data)`` windows with the
  TL-1 overlap, K1 (K2 where a chunk overflows) on each shard's device,
  and the exact multiset merge.
* ``ShardedMatchIndex`` (``:449-535``, ``composite``/``profile
  --shard-db N``): a component's sorted distinct k-mers in ``n_db``
  contiguous slices, each a ``StaticHaystack`` with K3's index on its
  shard's device; K3 gives each query id's member flag and local lower
  bound, and the row is the slice offset plus that, in int64.  K3 needs no
  pad, so a query id 0xFFFFFFFF matches when the MarkerDB holds it, as on
  the serial path.
* ``sharded_shared_counts`` (``:332-446``, ``dist -r --shard-db N``): per
  db shard, K3 in values mode with the query's distinct ids as haystack,
  their multiplicities as values and the shard's postings, genome-major,
  as needles; each genome's count is an int64 prefix difference at its
  bounds, for every db axis (one shard too, where the JAX package takes
  its matched-row expansion, ``:268-329``).  Queries are dealt over the
  data axis.
* ``make_sharded_profile_step`` (``:179-227``): K1 per data shard, a
  distinct merge, K3 per db shard against the postings, the per-genome sum.
* ``device_union`` (``:541-631``, ``set -u/-q``): ``torch.unique`` per data
  shard on its device, the runs gathered on the card across ranks and
  merged on the host; every count is exact, where the JAX step caps each
  device's at 2.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
import time

import numpy as np
import torch

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.dist import MAX_NEEDLES
from metakssd_tpu_torch.formats.codir import CoDir
from metakssd_tpu_torch.ops import merge, sketch, sketch_cuda
from metakssd_tpu_torch.ops.golden import window_drtuples
from metakssd_tpu_torch.ops.merge import (StaticHaystack, sorted_membership,
                                          u32_tensor)
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.state import accept_tables, make_accept_tables
from metakssd_tpu_torch.utils import TIMER

# XOR with the sign bit maps the u32 order onto the int32 order, so the
# keys sort as 4-byte ints (a plain int32 bit view puts keys >= 2^31 first).
_U32_FLIP = -(1 << 31)
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

# Calls and bytes of the collectives by backend since reset_collectives();
# the bytes of a call are its output buffers' on this rank (the sizes'
# too).  cli.main reports them in TIMER.meta["collective_counts"].
COLLECTIVES = {"gloo_calls": 0, "gloo_bytes": 0,
               "nccl_calls": 0, "nccl_bytes": 0}


@dataclasses.dataclass(frozen=True)
class _Join:
    """What ``init_distributed`` formed: the description of the backend
    for card tensors, and the NCCL group with its card (None on gloo)."""
    describe: str
    card_group: object = None
    card: torch.device | None = None


_JOINED: _Join | None = None


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def choose_backend(layout: list, device) -> tuple[str, str]:
    """(backend for card tensors, description) from every rank's ``(host,
    card index, card UUID)``, index and UUID None where the rank holds no
    card: ``nccl`` where the job runs on ``cuda`` and no two ranks share
    a card, else ``gloo`` (``--device cpu``, a verb without a device, a
    rank without a card, or ranks on one card, which NCCL refuses)."""
    n = len(layout)
    ranks = f"{n} rank" + ("s" if n > 1 else "")
    if device is None:
        return "gloo", f"gloo ({ranks}, no device)"
    if torch.device(device).type == "cpu":
        return "gloo", f"gloo ({ranks}, --device cpu)"
    cards = [(host, uuid) for host, _, uuid in layout]
    if any(uuid is None for _, uuid in cards):
        return "gloo", f"gloo ({ranks}, a rank holds no card)"
    for host, idx, uuid in layout:
        share = cards.count((host, uuid))
        if share > 1:
            return "gloo", f"gloo ({share} ranks share cuda:{idx})"
    return "nccl", f"nccl ({ranks}, {n} card" + ("s)" if n > 1 else ")")


def _local_card(device, rank: int) -> tuple[int | None, str | None]:
    """(index, UUID) of the card this rank works on, made the current
    device: the index that ``device`` names, else ``rank % device_count``;
    (None, None) off CUDA or for ``--device cpu``."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return None, None
    idx = torch.device(device).index if device is not None else None
    if idx is None:
        idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return idx, str(torch.cuda.get_device_properties(idx).uuid)


def _nccl_group(card: torch.device):
    """An NCCL group of every rank, its communicator formed now by one
    int64 all-reduce on ``card``, so that a failure is the join's."""
    import torch.distributed as tdist
    if not tdist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this PyTorch build")
    group = tdist.new_group(backend="nccl")
    try:
        probe = torch.ones(1, dtype=torch.int64, device=card)
        tdist.all_reduce(probe, group=group)
        torch.cuda.synchronize(card)
    except BaseException:
        tdist.distributed_c10d._abort_process_group(group)
        raise
    return group


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> bool:
    """Join the other processes of a multi-process run.

    Arguments default to ``MKSSD_COORDINATOR`` (host:port of rank 0),
    ``MKSSD_NPROCS`` and ``MKSSD_PROCID``; no coordinator: no-op, False.
    Ranks other than 0 first probe the coordinator's socket until
    ``MKSSD_COORD_TIMEOUT`` seconds (default 300) pass, so a dead or wrong
    address is a one-line RuntimeError, not a hang; the probe's time counts
    against the same budget, with at least half of it kept for the join.
    The budget bounds the rendezvous only (an explicit ``TCPStore``); the
    collectives keep torch's default deadline.

    Every rank joins a gloo group (the store, the barrier, numpy and CPU
    tensors), works on ``cuda:(rank % device_count)`` (or the card
    ``device`` names) where CUDA is present, and publishes its host and
    card.  Where ``device`` is CUDA and no two ranks share a card
    (``choose_backend``), the ranks also form an NCCL group for card
    tensors; where NCCL is unavailable or its group cannot be formed, the
    join fails: it never falls back to gloo."""
    global _JOINED
    import torch.distributed as tdist
    if tdist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("MKSSD_COORDINATOR")
    if not coordinator:
        return False
    try:
        if num_processes is None:
            num_processes = int(os.environ["MKSSD_NPROCS"])
        if process_id is None:
            process_id = int(os.environ["MKSSD_PROCID"])
    except (KeyError, ValueError) as e:
        raise RuntimeError(
            "multi-host join failed: MKSSD_COORDINATOR is set but "
            "MKSSD_NPROCS / MKSSD_PROCID are missing or non-integer "
            f"({e!r}): the launcher must export all three") from e
    timeout = int(os.environ.get("MKSSD_COORD_TIMEOUT", "300"))
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise RuntimeError(
            f"multi-host join failed: MKSSD_COORDINATOR must be "
            f"host:port, got {coordinator!r}")
    t0 = time.time()
    if process_id != 0:
        deadline = t0 + timeout
        while True:
            try:
                socket.create_connection((host, int(port)), timeout=2).close()
                break
            except OSError:
                if time.time() >= deadline:
                    raise RuntimeError(
                        f"multi-host join failed: coordinator {coordinator} "
                        f"unreachable within {timeout}s (process "
                        f"{process_id}/{num_processes}): check that process "
                        "0 is up and the address is correct") from None
                time.sleep(0.5)
    remaining = max(int(timeout - (time.time() - t0)), timeout // 2, 10)
    # the join budget bounds the rendezvous alone; the collectives keep
    # torch's own deadline, so ranks that drift apart in a long step (as
    # with uneven I/O) still meet
    try:
        store = tdist.TCPStore(host, int(port), num_processes,
                               is_master=process_id == 0,
                               timeout=datetime.timedelta(seconds=remaining))
        tdist.init_process_group("gloo", store=store,
                                 world_size=num_processes, rank=process_id,
                                 timeout=tdist.default_pg_timeout)
        store.set_timeout(tdist.default_pg_timeout)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"multi-host join failed: process {process_id}/{num_processes} "
            f"could not join {coordinator} within {remaining}s "
            f"({_first_line(e)})") from None
    try:
        idx, uuid = _local_card(device, process_id)
        layout = [None] * num_processes
        tdist.all_gather_object(layout, (socket.gethostname(), idx, uuid))
        backend, describe = choose_backend(layout, device)
        if backend == "gloo":
            _JOINED = _Join(describe)
        else:
            card = torch.device("cuda", idx)
            _JOINED = _Join(describe, _nccl_group(card), card)
    except (RuntimeError, ValueError) as e:
        tdist.destroy_process_group()
        raise RuntimeError(
            f"multi-host join failed: process {process_id}/{num_processes} "
            f"could not form the collectives' groups at {coordinator} "
            f"({_first_line(e)})") from None
    if backend == "gloo" and device is not None \
            and torch.device(device).type == "cuda":
        # a job on cards whose card tensors cross on the host: say why
        print(f"metakssd_tpu_torch: collectives over {describe}",
              file=sys.stderr)
    return True


def _first_line(e: BaseException) -> str:
    text = str(e).strip()
    return text.splitlines()[0] if text else type(e).__name__


def collectives_backend() -> str | None:
    """The description of the joined backend (``nccl (1 rank, 1 card)``,
    ``gloo (2 ranks share cuda:0)``), or None without a join."""
    return None if _JOINED is None else _JOINED.describe


def leave_distributed(ok: bool) -> None:
    """Leave the process groups, if this process joined them.  After a
    run that went well every rank waits for the others first, so none
    tears down a connection that another still reads; after a failure it
    leaves at once (the NCCL group aborted, so that no rank waits in a
    collective for its watchdog), and the others' pending collectives fail
    on the closed connections rather than wait.  Leaving before the
    interpreter exits keeps gloo's threads from being torn down live (an
    abort)."""
    global _JOINED
    import torch.distributed as tdist
    joined, _JOINED = _JOINED, None
    if not _grouped():
        return
    try:
        if ok:
            tdist.barrier()
    finally:
        if joined is not None and joined.card_group is not None:
            if ok:
                tdist.destroy_process_group(joined.card_group)
            else:
                tdist.distributed_c10d._abort_process_group(
                    joined.card_group)
        tdist.destroy_process_group()


def _grouped() -> bool:
    """Whether this process joined a process group (at any size)."""
    import torch.distributed as tdist
    return tdist.is_available() and tdist.is_initialized()


def world() -> tuple[int, int]:
    """(processes, this rank): (1, 0) without a joined process group."""
    import torch.distributed as tdist
    if _grouped():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def _route(x: torch.Tensor):
    """(group, device the bytes cross on, backend) for a tensor: a card
    tensor takes the NCCL group on this rank's card where one was formed;
    anything else gloo on the host (where the ranks share a card, the
    layout's choice)."""
    j = _JOINED
    if x.device.type == "cuda" and j is not None and j.card_group is not None:
        return j.card_group, j.card, "nccl"
    return None, torch.device("cpu"), "gloo"


def _count(backend: str, calls: int, nbytes: int) -> None:
    COLLECTIVES[f"{backend}_calls"] += calls
    COLLECTIVES[f"{backend}_bytes"] += nbytes


def _gather_tensor(x: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's 1-D tensor (sizes may differ), in rank order, back on
    ``x``'s device: the byte sizes first, then the bytes padded to the
    largest, rounded up to 8 so that each rank's slice views as the dtype
    again.  NCCL runs after the current stream's work on the card: a
    tensor made on another stream must be waited on before it comes
    here."""
    import torch.distributed as tdist
    group, dev, backend = _route(x)
    # (an empty tensor may carry a stride that refuses the byte view)
    raw = x.contiguous().reshape(-1).view(torch.uint8).to(dev) \
        if x.numel() else torch.zeros(0, dtype=torch.uint8, device=dev)
    nproc = world()[0]
    sizes = torch.empty(nproc, dtype=torch.int64, device=dev)
    tdist.all_gather_into_tensor(
        sizes, torch.tensor([raw.numel()], dtype=torch.int64, device=dev),
        group=group)
    sizes = sizes.tolist()
    width = max(8, -(-max(sizes) // 8) * 8)
    buf = torch.zeros(width, dtype=torch.uint8, device=dev)
    buf[:raw.numel()] = raw
    out = torch.empty(nproc * width, dtype=torch.uint8, device=dev)
    tdist.all_gather_into_tensor(out, buf, group=group)
    _count(backend, 2, 8 * nproc + out.numel())
    return [out[r * width:r * width + s].view(x.dtype).to(x.device)
            for r, s in enumerate(sizes)]


def gather_arrays(arr):
    """Every rank's 1-D array, in rank order (sizes may differ): the JAX
    package's ``all_gather``.  A numpy array comes back as numpy arrays
    (over gloo); a tensor as tensors on its device, a card tensor over
    NCCL (on this rank's card) where the join formed an NCCL group, else
    over gloo.  Where a group was joined the bytes cross it even at one
    rank; without one this is the identity."""
    if isinstance(arr, torch.Tensor):
        return _gather_tensor(arr) if _grouped() else [arr]
    arr = np.ascontiguousarray(arr)
    if not _grouped():
        return [arr]
    got = _gather_tensor(torch.from_numpy(arr.reshape(-1).view(np.uint8)))
    return [g.numpy().view(arr.dtype) for g in got]


def all_sum(arr):
    """The int64 sum of ``arr`` over every rank (``psum``), numpy for
    numpy (over gloo), a tensor on its device for a tensor (a card tensor
    over NCCL, on this rank's card, where the join formed an NCCL group,
    else over gloo; uint64 bits sum as int64).  Where a group was joined
    the sum crosses it even at one rank; without one this is the
    identity."""
    import torch.distributed as tdist
    if not isinstance(arr, torch.Tensor):
        arr = np.ascontiguousarray(arr, dtype=np.int64)
        if not _grouped():
            return arr
        return all_sum(torch.from_numpy(arr)).numpy()
    x = arr.view(torch.int64) if arr.dtype == torch.uint64 else \
        arr.to(torch.int64)
    if not _grouped():
        return x
    group, dev, backend = _route(x)
    t = x.to(dev, copy=True)
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    _count(backend, 1, t.numel() * 8)
    return t.to(arr.device)


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    data: int
    db: int
    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_db`` shards, row-major; ``rank`` is this process."""
    n_data: int
    n_db: int
    shards: tuple
    rank: int = 0

    def row(self, d: int) -> tuple:
        return self.shards[d * self.n_db:(d + 1) * self.n_db]

    @property
    def local_rows(self) -> list[int]:
        """The data rows this process owns (every db shard of a row lies
        in one process)."""
        return [d for d in range(self.n_data)
                if self.shards[d * self.n_db].rank == self.rank]

    @property
    def key(self) -> tuple:
        """What identifies the layout for a cache: the grid, this rank and
        its shards' devices."""
        return (self.n_data, self.n_db, self.rank,
                tuple(str(s.device) for s in self.shards
                      if s.rank == self.rank))

    def describe(self) -> str:
        return " ".join(f"{s.data}.{s.db}@{s.rank}:{s.device}"
                        for s in self.shards)


def make_mesh(n_data: int | None = None, n_db: int = 1,
              device="cuda") -> Mesh:
    """The ``n_data x n_db`` grid on ``device`` (``mesh.py:119-135``).

    ``n_data`` None takes one data row per visible device (cuda) or one
    (cpu).  In one process shard i lies on ``cuda:(i % device_count)``, or
    on the one device that ``device`` names with an index, or on the CPU.
    Across P processes the data axis spans them: ``n_data`` rounds up to a
    multiple of P, rank r owns the consecutive rows ``r * n_data / P ...``
    with all their db shards, on ``cuda:(r % device_count)`` or the CPU.
    The layout goes into ``TIMER.meta``."""
    dev = resolve_device(device)
    if n_db < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"a mesh needs n_data, n_db >= 1, got "
                         f"{n_data} x {n_db}")
    pinned = dev.type == "cpu" or dev.index is not None
    ncard = 1 if pinned else torch.cuda.device_count()
    nproc, rank = world()
    if n_data is None:
        n_data = max(1, ncard // n_db) if nproc == 1 else nproc
    if nproc == 1:
        devs = [dev] if pinned else [torch.device("cuda", i)
                                     for i in range(ncard)]
        shards = tuple(Shard(i // n_db, i % n_db, 0, devs[i % len(devs)])
                       for i in range(n_data * n_db))
    else:
        per = -(-n_data // nproc)
        n_data = per * nproc

        def rank_dev(r: int) -> torch.device:
            return dev if pinned else torch.device("cuda", r % ncard)
        shards = tuple(Shard(i // n_db, i % n_db, i // n_db // per,
                             rank_dev(i // n_db // per))
                       for i in range(n_data * n_db))
    mesh = Mesh(n_data, n_db, shards, rank)
    TIMER.meta["mesh"] = f"{n_data}x{n_db} over {nproc} process" \
                         + ("es" if nproc > 1 else "")
    TIMER.meta["mesh_shards"] = mesh.describe()
    return mesh


def _as_mesh(mesh) -> Mesh:
    """A Mesh as given, or one shard on a device."""
    return mesh if isinstance(mesh, Mesh) else make_mesh(1, 1, mesh)


def _home(mesh: Mesh) -> torch.device:
    """The device this rank's parts join on before they cross: its first
    data row's (over NCCL, the card the join chose)."""
    return mesh.row(mesh.local_rows[0])[0].device


# ---------------------------------------------------------------------------
# --mesh: the data-parallel sketch
# ---------------------------------------------------------------------------

def _shard_windows(seg: np.ndarray, shuf, dev, tables: dict, **kw):
    """All kept drtuples of one shard's codes: on the kernel path K1/K2's
    on ``dev``, an int32 tensor (u32 bits) left there; off it golden's,
    uint64 numpy."""
    if not sketch.on_device_path(shuf):
        return np.asarray(window_drtuples(seg, shuf), np.uint64)
    if dev not in tables:
        tables[dev] = accept_tables(shuf, dev)
    return sketch_cuda.sketch_windows(seg, shuf.params, tables[dev],
                                      devices=[dev], on_device=True,
                                      **kw)[0]


def sharded_sketch(codes: np.ndarray, shuf, mesh, tables=None,
                   **kw) -> np.ndarray:
    """Sketch one code stream data-parallel over the mesh's data axis: the
    sorted uint64 drtuple multiset, duplicates kept, identical to
    ``sketch.sketch_codes``.  Shard d holds windows ``[d * nwin, (d + 1) *
    nwin)`` of ``nwin = ceil(windows / n_data)`` (its codes overlap the next
    shard's by TL-1), so every window is counted once; a shard past the
    stream's end is empty.  Each rank sketches its rows; on the kernel
    path their drtuples stay on the card, join on the rank's card and are
    gathered there (``mesh.py:674-676``), then read back once and sorted
    on the host, as the JAX package does (``:702-703``).  ``tables``, the
    sketch tables on one device, are reused for the shards on it.  ``kw``
    reaches the chunk loop (``chunk_windows``, ``capacity``)."""
    mesh = _as_mesh(mesh)
    codes = np.asarray(codes, np.uint8)
    TL = shuf.params.kmer_len
    nwin_total = max(codes.size - TL + 1, 0)
    nwin = max(-(-nwin_total // mesh.n_data), 1)
    tables = {} if tables is None else {tables.accept.device: tables}
    parts = []
    for d in mesh.local_rows:
        seg = codes[d * nwin:d * nwin + nwin + TL - 1]
        if seg.size >= TL:
            parts.append(_shard_windows(seg, shuf, mesh.row(d)[0].device,
                                        tables, **kw))
    if sketch.on_device_path(shuf):
        home = _home(mesh)
        mine = torch.cat([torch.zeros(0, dtype=torch.int32, device=home)]
                         + [x.to(home) for x in parts])
        out = torch.cat(gather_arrays(mine)).cpu().numpy() \
            .view(np.uint32).astype(np.uint64)
    else:
        out = np.concatenate(gather_arrays(
            np.concatenate([np.zeros(0, np.uint64)] + parts)))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# --shard-db: composite / profile
# ---------------------------------------------------------------------------

class ShardedMatchIndex:
    """A MarkerDB component's match index over the mesh's db axis: drop-in
    for ``composite._CompIndex``.  ``mesh`` is a Mesh, or a device for one
    shard on it.  Each process holds every slice (on the shards
    of its first data row), so ``match`` needs no collective; it returns
    the matched postings' genomes and the matching query ids' abundances,
    the JAX package's (``mesh.py:501-535``)."""

    def __init__(self, rk, starts, gid_sorted, mesh):
        mesh = _as_mesh(mesh)
        rk = np.asarray(rk, np.uint32)
        self.starts = np.asarray(starts)
        self.gid_sorted = np.asarray(gid_sorted)
        self.nk = rk.size
        row = mesh.row(mesh.local_rows[0])
        self.per = -(-max(self.nk, 1) // len(row))
        self.hays = [StaticHaystack(rk[j * self.per:(j + 1) * self.per],
                                    None, s.device)
                     for j, s in enumerate(row)]

    def match(self, qids_s: np.ndarray, qab_s: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        if qids_s.size == 0 or self.nk == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.uint16))
        # K3 per slice, one call per MAX_NEEDLES ids; an id lies in at
        # most one slice, and its row is the slice offset + local bound
        member = np.zeros(qids_s.size, bool)
        rows = np.zeros(qids_s.size, np.int64)
        for j, hay in enumerate(self.hays):
            if hay.hay.numel() == 0:
                continue
            for lo in range(0, qids_s.size, MAX_NEEDLES):
                m, pos = sorted_membership(hay, None,
                                           qids_s[lo:lo + MAX_NEEDLES])
                hit = np.flatnonzero(m) + lo
                member[hit] = True
                rows[hit] = j * self.per + pos[m].astype(np.int64)
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


# ---------------------------------------------------------------------------
# --shard-db: dist search
# ---------------------------------------------------------------------------

def _my_queries(mesh: Mesh, nqry: int) -> list[tuple[int, tuple]]:
    """(query, its data row's shards) for the queries this process owns:
    query q goes to row q % n_data, as the JAX step batches them."""
    mine = set(mesh.local_rows)
    return [(q, mesh.row(q % mesh.n_data)) for q in range(nqry)
            if q % mesh.n_data in mine]


def _posting_counts(hay: StaticHaystack, needles: torch.Tensor,
                    bounds: torch.Tensor) -> torch.Tensor:
    """int64 [len(bounds) - 1] on the needles' device: per genome, the
    summed values (query multiplicities) of its postings, one K3 call per
    MAX_NEEDLES needles; ``bounds`` are the genomes' posting bounds,
    relative to ``needles``."""
    out = torch.zeros(bounds.numel() - 1, dtype=torch.int64,
                      device=needles.device)
    for lo in range(0, needles.numel(), MAX_NEEDLES):
        piece = needles[lo:lo + MAX_NEEDLES]
        _, val = merge.member(hay.hay, hay.values, piece, hay.index)
        cs = torch.zeros(piece.numel() + 1, dtype=torch.int64,
                         device=piece.device)
        torch.cumsum(val.to(torch.int64) & _U32, 0, out=cs[1:])
        b = (bounds - lo).clamp(0, piece.numel())
        out += cs[b[1:]] - cs[b[:-1]]
    return out


def sharded_shared_counts(ref, qry, mesh) -> np.ndarray:
    """uint32 [qry_num, ref_num] shared-k-mer counts, ``--shard-db``
    (``mesh.py:332-446``): ``mesh`` is a Mesh, or a device for one shard.

    Per component the postings are the sketch dir's ids in genome-major
    order (each genome's ids between its index bounds), cut into n_db
    contiguous slices staged once on their shards' devices.  Per query and
    shard, K3 in values mode (the query's distinct ids as haystack, their
    multiplicities as values) gives each posting its multiplicity, 0 where
    the query lacks it; a genome's count is the prefix difference at its
    bounds, summed over the shards.  Counts are exact int64 and stay on
    the rank's card (a shard on another card of the process adds in by a
    peer copy) until one sum over the ranks there (the ``psum`` of
    ``mesh.py:391``) and one read back; they wrap to uint32 as the serial
    path's do."""
    mesh = _as_mesh(mesh)
    if isinstance(ref, str):
        ref = CoDir.read(ref, want_abund=False)
    if isinstance(qry, str):
        qry = CoDir.read(qry, want_abund=False)
    num_refs = ref.stat.infile_num
    home = _home(mesh)
    out = torch.zeros((qry.stat.infile_num, num_refs), dtype=torch.int64,
                      device=home)
    mine = _my_queries(mesh, qry.stat.infile_num)
    for c in range(ref.stat.comp_num):
        post = np.asarray(ref.ids[c], np.uint32)
        if post.size == 0 or not mine:
            continue
        bounds = np.asarray(ref.index[c], np.int64)
        per = -(-post.size // mesh.n_db)
        staged: dict = {}                # (row, db) -> (needles, bounds)
        for d in {row[0].data for _, row in mine}:
            for s in mesh.row(d):
                lo = s.db * per
                staged[d, s.db] = (
                    u32_tensor(post[lo:lo + per]).to(s.device),
                    torch.from_numpy(bounds - lo).to(s.device))
        for q, row in mine:
            uq, mult = np.unique(qry.genome_ids(c, q), return_counts=True)
            if uq.size == 0:
                continue
            hays: dict = {}
            for s in row:
                needles, b = staged[s.data, s.db]
                if needles.numel() == 0:
                    continue
                if s.device not in hays:
                    hays[s.device] = StaticHaystack(
                        uq, mult.astype(np.uint32), s.device)
                out[q] += _posting_counts(hays[s.device], needles,
                                          b).to(home)
    return all_sum(out).cpu().numpy().astype(np.uint32)


def make_sharded_profile_step(mesh, *, k: int, subk: int, drlevel: int,
                              nwin: int, num_refs: int):
    """The multi-shard profiling step (``mesh.py:179-227``) as a plain
    function ``step(codes, accept_tups, pfilters, ref_ids, ref_gid)``:

    * ``codes`` uint8 [n_data, nwin + 2k - 1], one read shard per data row;
    * ``accept_tups``, ``pfilters`` uint32: the sketch tables;
    * ``ref_ids`` uint32 [R], ``ref_gid`` int [R]: postings (k-mer, genome)
      in n_db equal slices, each sorted;

    returns uint32 [num_refs]: per genome, its postings found in the
    distinct union of the shards' sketches.  K1 (K2 on overflow) sketches
    each data row on its device, the rows' sketches stay there for the
    union (``_union_rows``), and K3 tests db slice j against it on shard
    (j % n_data, j), in the process that owns that row; the slices'
    counts add up on the rank's card and one sum over the ranks there
    gives every rank the whole (the ``psum`` of ``mesh.py:218``)."""
    mesh = _as_mesh(mesh)
    p = SketchParams(k=k, subk=subk, drlevel=drlevel)
    tl = p.kmer_len

    def step(codes, accept_tups, pfilters, ref_ids, ref_gid) -> np.ndarray:
        codes = np.asarray(codes, np.uint8)
        if codes.shape != (mesh.n_data, nwin + tl - 1):
            raise ValueError(f"codes must be [{mesh.n_data}, "
                             f"{nwin + tl - 1}], got {codes.shape}")
        tables: dict = {}
        parts = []
        for d in mesh.local_rows:
            dev = mesh.row(d)[0].device
            if dev not in tables:
                tables[dev] = make_accept_tables(accept_tups, pfilters, subk,
                                                 dev)
            parts.append(sketch_cuda.sketch_windows(
                codes[d], p, tables[dev], devices=[dev], on_device=True)[0])
        uniq = _union_rows(parts, mesh, False)
        # 0xFFFFFFFF is the JAX step's pad: it never matches there
        uniq = uniq[uniq != _U32]
        ref_ids = np.asarray(ref_ids, np.uint32)
        ref_gid = np.asarray(ref_gid, np.int64)
        per = -(-ref_ids.size // mesh.n_db)
        home = _home(mesh)
        counts = torch.zeros(num_refs, dtype=torch.int64, device=home)
        mine = set(mesh.local_rows)
        for j in range(mesh.n_db):
            if j % mesh.n_data not in mine:
                continue
            s = mesh.row(j % mesh.n_data)[j]
            sl = slice(j * per, (j + 1) * per)
            hay = StaticHaystack(uniq, None, s.device)
            hit, _ = merge.member(hay.hay, None,
                                  u32_tensor(ref_ids[sl]).to(s.device),
                                  hay.index)
            got = torch.zeros(num_refs, dtype=torch.int64, device=s.device)
            got.index_add_(0, torch.from_numpy(ref_gid[sl]).to(s.device),
                           hit.to(torch.int64))
            counts += got.to(home)
        return all_sum(counts).cpu().numpy().astype(np.uint32)

    return step


# ---------------------------------------------------------------------------
# set -u / -q
# ---------------------------------------------------------------------------

def _unique_on(x: torch.Tensor, return_counts: bool):
    """(distinct values ascending, exact int64 counts or None) of an int32
    tensor of u32 bits, sorted on its device; the values as u32 bits."""
    got = torch.unique(x ^ _U32_FLIP, sorted=True,
                       return_counts=return_counts)
    vals, counts = got if return_counts else (got, None)
    return vals ^ _U32_FLIP, counts


def _union_rows(parts: list, mesh: Mesh, return_counts: bool):
    """The distinct values (uint32, ascending) and, with ``return_counts``,
    the exact int64 counts of every rank's ``parts`` (int32 tensors of u32
    bits, each on its data row's device): each part's ``torch.unique`` on
    its device; the runs and counts join on the rank's card and are
    gathered there (the ``all_gather`` of ``mesh.py:576``), read back once
    and merged on the host."""
    home = _home(mesh)
    runs = [torch.zeros(0, dtype=torch.int32, device=home)]
    cnts = [torch.zeros(0, dtype=torch.int64, device=home)]
    for x in parts:
        if x.numel():
            vals, counts = _unique_on(x, return_counts)
            runs.append(vals.to(home))
            if return_counts:
                cnts.append(counts.to(home))
    vals = torch.cat(gather_arrays(torch.cat(runs))).cpu().numpy() \
        .view(np.uint32)
    uniq, inv = np.unique(vals, return_inverse=True)
    if not return_counts:
        return uniq
    counts = torch.cat(gather_arrays(torch.cat(cnts))).cpu().numpy()
    tot = np.bincount(inv.reshape(-1), weights=counts.astype(np.float64),
                      minlength=uniq.size)
    return uniq, tot.astype(np.int64)


def device_union(ids, mesh, return_counts: bool = False):
    """``np.unique(ids)`` of a uint32 array: the distinct values ascending
    and, with ``return_counts``, their exact occurrence counts (int64).
    ``mesh`` is a Mesh, or a device for one shard.  Each data row takes
    ``ceil(n / n_data)`` ids and sorts them on its device, and the rows'
    runs merge (``_union_rows``); one row in a process that joined no
    group is read back as it is."""
    mesh = _as_mesh(mesh)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    if ids.size == 0:
        empty = np.zeros(0, np.uint32)
        return (empty, np.zeros(0, np.int64)) if return_counts else empty
    if mesh.n_data == 1 and not _grouped():
        vals, counts = _unique_on(u32_tensor(ids).to(mesh.shards[0].device),
                                  return_counts)
        vals = vals.cpu().numpy().view(np.uint32)
        return (vals, counts.cpu().numpy()) if return_counts else vals
    per = -(-ids.size // mesh.n_data)
    return _union_rows([u32_tensor(ids[d * per:(d + 1) * per])
                        .to(mesh.row(d)[0].device)
                        for d in mesh.local_rows], mesh, return_counts)
