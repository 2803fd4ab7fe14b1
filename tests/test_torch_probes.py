"""The probe path P1-P4 against the TPU probe kernels, on the CPU.

Each variant of ``metakssd_tpu_torch.probes`` is built small (2 blocks,
the files' own RWIN and EXT), and its plain version must equal
the Pallas kernel of ``benchmarks/<file>.py`` in interpret mode, exactly,
on the variant's own input and on an XOR-varied copy (codes up to 7, so
half the bases are invalid).  The Pallas kernels are taken from the
benchmark files with ``ast``: only their ``def``s run, in a namespace
whose ``pl.pallas_call`` interprets, so the files' module-level code
(which allocates GiBs) never runs.
"""

import ast
import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from metakssd_tpu.formats.shuf import make_shuf as jax_make_shuf
from metakssd_tpu.ops import sketch_pallas, sketch_xla
from metakssd_tpu.params import SketchParams as JaxSketchParams

from metakssd_tpu_torch.ops import probe
from metakssd_tpu_torch.probes import (probe_floor_chunk, probe_floor_noread,
                                       probe_kernel_cost, probe_r4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NWIN = 1 << 16
LANES = 128

_PL = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl)
                               if not n.startswith("_")})
_PL.pallas_call = functools.partial(pl.pallas_call, interpret=True)


def _tpu_defs(fname: str, **globs) -> dict:
    """The top-level ``def``s of a benchmark file, run in a namespace of
    ``globs`` plus the modules they name."""
    path = os.path.join(REPO, "benchmarks", fname)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    ns = dict(np=np, jax=jax, jnp=jnp, pl=_PL, pltpu=pltpu,
              functools=functools, sketch_pallas=sketch_pallas, **globs)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def _inputs(v):
    """The variant's input, and a copy with codes up to 7."""
    rng = np.random.default_rng(11)
    noise = torch.from_numpy(rng.integers(0, 8, tuple(v.tiles.shape))
                             .astype(np.int64))
    varied = (v.tiles.to(torch.int64) ^ noise).to(v.tiles.dtype)
    return [v.tiles, varied]


def _assert_equal(port: torch.Tensor, tpu) -> None:
    want = np.asarray(tpu)
    assert want.dtype == np.int32 and port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), want)


def _by_name(variants):
    return {v.name: v for v in variants}


# --------------------------------------------------------------------------
# P1: probe_kernel_cost
# --------------------------------------------------------------------------

def _p1_namespace(p, a_tups, nb):
    return _tpu_defs(
        "probe_kernel_cost.py", RWIN=sketch_pallas.RWIN, LANES=LANES,
        NBLOCKS=nb, TL=p.kmer_len, p=p, a_tups=a_tups,
        a2d=jnp.asarray(a_tups.reshape(-1, LANES)),
        p2d=jnp.asarray(np.zeros(a_tups.size, np.uint32).reshape(-1, LANES)),
        lev2d=jnp.asarray(sketch_pallas._bfs_levels(a_tups)),
        sig2d=jnp.asarray(sketch_pallas._sig_tables(a_tups)))


@pytest.fixture(scope="module")
def p1():
    vs = _by_name(probe_kernel_cost.variants("cpu", nwin=NWIN))
    shuf = jax_make_shuf(JaxSketchParams(k=11, subk=6, drlevel=3), seed=1234)
    nb = vs["floor (read+sum)"].tiles.shape[0]
    return vs, _p1_namespace(shuf.params, shuf.device_tables()[0], nb)


@pytest.mark.parametrize("name", [
    "floor (read+sum)", "window math only", "winmath + exact search",
    "winmath + sig-probe search"])
def test_p1_plain_equals_tpu_kernel(p1, name):
    vs, ns = p1
    v = vs[name]
    fn = {"floor (read+sum)": ns["floor_fn"],
          "window math only": ns["winmath_fn"],
          "winmath + exact search": ns["make_search_fn"](False),
          "winmath + sig-probe search": ns["make_search_fn"](True)}[name]
    for t in _inputs(v):
        _assert_equal(v.run(t), fn(_jnp(t)))


@pytest.mark.parametrize("use_sig", [False, True])
def test_p1_search_dense_hits(use_sig):
    """The search at a config where 1 window in 16 is kept (k=5, subk=3,
    drlevel=1: 256 accepted of 4096 substrings, R = 2), so base | pos of
    many hits is summed."""
    jp = JaxSketchParams(k=5, subk=3, drlevel=1)
    a_tups = jax_make_shuf(jp, seed=3).device_tables()[0]
    rwin = sketch_pallas.RWIN
    ext = probe_kernel_cost._ext(jp.kmer_len)
    nb = 2
    rng = np.random.default_rng(4)
    tiles = torch.from_numpy(rng.integers(0, 5, (nb, rwin + ext, LANES))
                             .astype(np.int32))
    ns = _p1_namespace(jp, a_tups, nb)
    tpu = ns["make_search_fn"](use_sig)(_jnp(tiles))
    acc = torch.from_numpy(a_tups.view(np.int32))
    if use_sig:
        lev = torch.from_numpy(probe.bfs_levels(a_tups).view(np.int32))
        sig = torch.from_numpy(np.ascontiguousarray(
            probe.sig_tables(a_tups)).view(np.int32))
        port = probe.search(tiles, rwin, 5, 3, 1, lev=lev, sig=sig)
    else:
        port = probe.search(tiles, rwin, 5, 3, 1, accept=acc)
    assert np.count_nonzero(np.asarray(tpu)) > LANES
    _assert_equal(port, tpu)


def test_tiles_from_codes_matches_restructure():
    TL = 22
    ext = probe_kernel_cost._ext(TL)
    rwin, nb = sketch_pallas.RWIN, 2
    rng = np.random.default_rng(5)
    n = nb * LANES * rwin + rwin + ext
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, n, 500)] = 255
    codes[rng.integers(0, n, 500)] = 4
    packed, vmask = sketch_xla.pack_codes(codes)
    want = sketch_pallas._restructure_packed(
        jnp.asarray(packed), jnp.asarray(vmask), nblocks=nb, TL=TL, n=n)
    got = probe.tiles_from_codes(torch.from_numpy(codes), rwin, ext, nb)
    _assert_equal(got, want)


def test_search_tables_match():
    a_tups = jax_make_shuf(JaxSketchParams(k=11, subk=6, drlevel=3),
                           seed=1234).device_tables()[0]
    np.testing.assert_array_equal(probe.bfs_levels(a_tups),
                                  sketch_pallas._bfs_levels(a_tups))
    np.testing.assert_array_equal(probe.sig_tables(a_tups),
                                  sketch_pallas._sig_tables(a_tups))


# --------------------------------------------------------------------------
# P2: probe_r4
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p2():
    vs = _by_name(probe_r4.variants("cpu", nwin=NWIN))
    nb = vs["floor i32"].tiles.shape[0]
    ns = _tpu_defs("probe_r4.py", RWIN=probe_r4.RWIN, LANES=LANES,
                   EXT=probe_r4.EXT, NBLOCKS=nb, TLk=probe_r4.TLK)
    return vs, ns


def _p2_fn(ns, v):
    dt = {torch.int32: jnp.int32, torch.int8: jnp.int8,
          torch.uint16: jnp.uint16}[v.tiles.dtype]
    if v.name.startswith("floor"):
        return ns["make_floor"](dt)
    if v.name.startswith("winmath"):
        return ns["make_winmath"](dt)
    tab = v.tables["table"]
    tab = jnp.asarray(tab.numpy().view(np.uint32) if tab.dtype == torch.int32
                      else tab.numpy())
    if "1-row" in v.name:
        return ns["make_gather_1row"](probe_r4.NG, tab, tab.dtype)
    return ns["make_gather"](probe_r4.NG, tab, tab.dtype)


@pytest.mark.parametrize("name", [
    "floor i32", "floor i8", "floor u16", "winmath i32", "winmath i8",
    "30x 32-row gather u32", "30x 32-row gather u16",
    "30x 1-row gather u32"])
def test_p2_plain_equals_tpu_kernel(p2, name):
    vs, ns = p2
    v = vs[name]
    fn = _p2_fn(ns, v)
    for t in _inputs(v):
        _assert_equal(v.run(t), fn(_jnp(t)))


# --------------------------------------------------------------------------
# P3: probe_floor_chunk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows", probe_floor_chunk.ROWS)
@pytest.mark.parametrize("kind", ["floor", "winmath"])
def test_p3_plain_equals_tpu_kernel(rows, kind):
    variants = probe_floor_chunk.variants("cpu", nwin=2 * rows * LANES,
                                          rows_list=(rows,))
    (v,) = [v for v in variants if v.name.startswith(kind)]
    assert v.tiles.shape[0] == 2
    ns = _tpu_defs("probe_floor_chunk.py", LANES=LANES,
                   EXT=probe_floor_chunk.EXT, CH=512, TLk=probe_floor_chunk.TLK,
                   NWIN=v.nwin)
    fn, nb = ns[f"make_{kind}"](rows)
    assert nb == v.tiles.shape[0]
    for t in _inputs(v):
        _assert_equal(v.run(t), fn(_jnp(t)))


# --------------------------------------------------------------------------
# P4: probe_floor_noread
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["noread", "touch8", "sumall", "xorfold"])
def test_p4_plain_equals_tpu_kernel(name):
    v = _by_name(probe_floor_noread.variants(
        "cpu", nwin=2 * probe_floor_noread.RWIN * LANES))[name]
    ns = _tpu_defs("probe_floor_noread.py", LANES=LANES,
                   RWIN=probe_floor_noread.RWIN, EXT=probe_floor_noread.EXT,
                   NBLOCKS=v.tiles.shape[0])
    fn = ns["mk"](ns[f"k_{name}"])
    for t in _inputs(v):
        _assert_equal(v.run(t), fn(_jnp(t)))


# --------------------------------------------------------------------------
# the wrappers' contract on the CPU
# --------------------------------------------------------------------------

def test_library_calls_equal_the_floors():
    """Each floor variant's library yardstick computes the same function."""
    for mod in (probe_kernel_cost, probe_r4, probe_floor_chunk,
                probe_floor_noread):
        for v in mod.variants("cpu", nwin=NWIN):
            if v.library is not None:
                assert torch.equal(v.library(v.tiles), v.run(v.tiles)), \
                    v.name


def _exact_inputs():
    """Small tiles and the L3K11 accept table, on the CPU."""
    v = _by_name(probe_kernel_cost.variants("cpu", nwin=NWIN))[
        probe_kernel_cost.EXACT]
    return v.tiles, v.tables["accept"]


def test_search_checks_its_index():
    """The exact search's index is checked before any dispatch, so on the
    CPU too: a table of another size than nb + 1, on another device or of
    another type, a bucket count the kernel does not take, or an index
    beside the signature form raises; the right one gives the plain
    result."""
    tiles, accept = _exact_inputs()
    ix = probe.exact_index(accept)
    assert ix.nb == 2048 and ix.table.numel() == 2049
    args = (tiles, 8, 11, 6, 3)
    want = probe.search_plain(*args, accept=accept)
    assert torch.equal(probe.search(*args, accept=accept, index=ix), want)
    assert torch.equal(probe.search(*args, accept=accept), want)
    bad = {
        "size": dataclasses.replace(ix, table=ix.table[:-1].contiguous()),
        "device": dataclasses.replace(ix, table=ix.table.to("meta")),
        "dtype": dataclasses.replace(ix, table=ix.table.to(torch.int64)),
        "buckets": dataclasses.replace(
            ix, nb=4096, table=torch.zeros(4097, dtype=torch.int32)),
        "shift": dataclasses.replace(ix, shift=33),
    }
    for b in bad.values():
        with pytest.raises(ValueError, match="search"):
            probe.search(*args, accept=accept, index=b)
    lev = torch.from_numpy(probe.bfs_levels(
        accept.numpy().view(np.uint32)).view(np.int32))
    with pytest.raises(ValueError, match="exact form"):
        probe.search(*args, lev=lev, sig=lev, index=ix)


@pytest.mark.parametrize("n,nb", [(4096, 2048), (4097, 4096), (11, 8),
                                  (2, 1), (1, 0)])
def test_exact_index_is_the_densest(n, nb):
    """The exact search's index takes the most buckets with nb + 1 <= n
    (K3's 1/8 rule would give 256 for 4096 keys and none below 16)."""
    keys = torch.arange(0, 7 * n, 7, dtype=torch.int32)
    ix = probe.exact_index(keys)
    assert ix.nb == nb
    assert ix.table.numel() == (nb + 1 if nb else 0)


def test_wrappers_raise_off_cpu_and_cuda():
    t = torch.zeros((1, 8, LANES), dtype=torch.int32, device="meta")
    for call in (lambda: probe.floor(t, 0, 8), lambda: probe.winmath(t, 4, 4),
                 lambda: probe.gather(t, 4, t, 128, 37, 1),
                 lambda: probe.search(t, 4, 2, 2, 1, accept=t)):
        with pytest.raises(ValueError, match="device"):
            call()
