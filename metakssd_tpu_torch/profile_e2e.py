"""One-command metagenome profiling on a device: fastq -> abundance
sketch -> MarkerDB profile -> Poisson abundance.

The port of ``metakssd_tpu/profile_e2e.py``: the same stages, artifacts
and report dict.  Stage I and the profile reduction run on ``device``;
Poisson normalisation (and the optional CAMI conversion) is host code,
copied from the JAX package (``postprocess/``).
"""

from __future__ import annotations

import dataclasses
import os
import time

from metakssd_tpu_torch import composite, pipeline
from metakssd_tpu_torch.formats.shuf import read_shuf
from metakssd_tpu_torch.pipeline import SketchOptions
from metakssd_tpu_torch.postprocess import poisson
from metakssd_tpu_torch.utils import TIMER


def profile_fastq(fastqs: list[str], markerdb: str, shuf, outdir: str,
                  shkm_thr: int = 6, opts=None,
                  cami: tuple[str, str] | None = None,
                  min_km_s: int | None = None, shard_db: int = 0, *,
                  device) -> dict:
    """fastq sample(s) -> species relative-abundance profile.

    ``shuf``: a DimShuffle or a path to the ``.shuf`` used to build the
    MarkerDB.  Writes under ``outdir``: ``qry.co/`` (abundance sketch),
    ``species_coverage.tsv``, ``abundance.tsv`` and, with
    ``cami=(psid2ncbi, nodes)``, ``cami.profile``.

    Returns ``{"stages": {name: seconds}, "total_s": float,
    "artifacts": {...}}``."""
    if isinstance(shuf, str):
        shuf = read_shuf(shuf)
    opts = opts or SketchOptions()
    if not opts.abundance:
        opts = dataclasses.replace(opts, abundance=True)
    os.makedirs(outdir, exist_ok=True)
    qry_co = os.path.join(outdir, "qry.co")
    tsv_path = os.path.join(outdir, "species_coverage.tsv")
    abund_path = os.path.join(outdir, "abundance.tsv")
    artifacts = {"sketch": qry_co, "coverage_tsv": tsv_path,
                 "abundance_tsv": abund_path}

    mark = len(TIMER.stages)
    t0 = time.time()
    with TIMER.stage("e2e.sketch"):
        pipeline.run_stage1(fastqs, shuf, qry_co, opts, device=device)
    with TIMER.stage("e2e.profile"):
        kw = {} if min_km_s is None else {"min_km_s": min_km_s}
        with open(tsv_path, "w") as f:
            composite.get_species_abundance(markerdb, qry_co,
                                            outdir=outdir, out=f,
                                            shard_db=shard_db,
                                            device=device, **kw)
    with TIMER.stage("e2e.poisson"):
        with open(tsv_path) as f, open(abund_path, "w") as g:
            poisson.poisson_abundance(f, shkm_thr=shkm_thr, out=g)
    if cami is not None:
        from metakssd_tpu_torch.postprocess import cami as cami_pp
        cami_path = os.path.join(outdir, "cami.profile")
        with TIMER.stage("e2e.cami"):
            psid_map = cami_pp.load_psid_map(cami[0])
            node2rank, node2pa, node2name = cami_pp.load_nodes(cami[1])
            with open(tsv_path) as f, open(cami_path, "w") as g:
                cami_pp.composite_to_cami_profile(
                    f, psid_map, node2rank, node2pa, node2name,
                    shkm_thr=float(shkm_thr), out=g)
        artifacts["cami_profile"] = cami_path
    total = time.time() - t0

    stages: dict[str, float] = {}
    for name, dt in TIMER.stages[mark:]:   # includes nested sub-stages
        stages[name] = round(stages.get(name, 0.0) + dt, 4)
    return {"stages": stages, "total_s": round(total, 4),
            "artifacts": artifacts}
