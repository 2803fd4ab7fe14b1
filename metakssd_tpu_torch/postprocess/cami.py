"""CAMI taxonomic-profile conversion
(port of reference src/universal.kssdcomposite2taxonomy_profilefmt.pl;
the sh8/sh18/sh48/thr2/small01 variants differ only in the
shkm/avgpct9899 threshold constants, exposed here as arguments).
"""

from __future__ import annotations

import sys

RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus",
         "species")


def load_nodes(path: str):
    """ncbitaxid <TAB> rank <TAB> parent <TAB> name table."""
    node2rank: dict[int, str] = {}
    node2pa: dict[int, int] = {}
    node2name: dict[int, str] = {}
    with open(path) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            node = int(parts[0])
            node2rank[node] = parts[1]
            node2pa[node] = int(parts[2])
            node2name[node] = parts[3]
    return node2rank, node2pa, node2name


def load_psid_map(path: str) -> dict[str, int]:
    out = {}
    with open(path) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def _sanitize(sample: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "_." else "_"
                   for ch in sample)


def composite_to_cami_profile(lines, psid_map: dict[str, int],
                              node2rank, node2pa, node2name,
                              shkm_thr: float = 18,
                              avgpct9899_thr: float = 3,
                              low_thr: float = 1, small_val: float = 0.1,
                              out=None) -> None:
    out = out or sys.stdout
    data: dict[str, dict[str, float]] = {}
    sums: dict[str, float] = {}
    for ln in lines:
        ln = ln.rstrip("\n")
        if not ln:
            continue
        parts = ln.split("\t")
        sample = _sanitize(parts[0])
        ref, shkm, avgpct = parts[1], float(parts[2]), float(parts[4])
        psid = ref.split("_")[0]
        if shkm > shkm_thr:
            dev = avgpct - avgpct9899_thr
            depth = dev if dev > small_val else 10 ** (dev - small_val)
            data.setdefault(sample, {})[psid] = depth
            sums[sample] = sums.get(sample, 0.0) + depth

    for sample in sorted(data):
        rank_cate: dict[str, list[int]] = {r: [] for r in RANKS}
        nctax_ab: dict[int, float] = {}
        for psid in sorted(data[sample]):
            nc = psid_map[psid]
            if nc not in nctax_ab:
                rank_cate.setdefault(node2rank[nc], []).append(nc)
            nctax_ab[nc] = data[sample][psid] / sums[sample] * 100
            node = node2pa[nc]
            while node != 1:
                if node not in nctax_ab:
                    rank_cate.setdefault(node2rank[node], []).append(node)
                    nctax_ab[node] = 0.0
                nctax_ab[node] += nctax_ab[nc]
                node = node2pa[node]

        out.write("# Taxonomic Profiling Output\n")
        out.write(f"@SampleID:{sample}\n")
        out.write("@Version:0.9.1\n")
        out.write("@Ranks:superkingdom|phylum|class|order|family|genus|"
                  "species\n")
        out.write("@TaxonomyID:ncbi-taxonomy_2021.07.19\n")
        out.write(f"@__program__:kssd2; Pars:shkm_thr:{shkm_thr:g};"
                  f"low_avgpct9899_thr ={low_thr:g}\n")
        out.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")
        for rank in RANKS:
            for taxid in sorted(rank_cate.get(rank, []),
                                key=lambda t: (-nctax_ab[t], t)):
                node = taxid
                path: list[int] = []
                names: list[str] = []
                while node2pa[node] != 1:
                    if node2rank.get(node) in RANKS:
                        path.append(node)
                        names.append(node2name[node])
                    node = node2pa[node]
                out.write("%d\t%s\t%s\t%s\t%.4f\n"
                          % (taxid, rank,
                             "|".join(str(p) for p in reversed(path)),
                             "|".join(reversed(names)), nctax_ab[taxid]))


def krona_taxonomy(psid_species: list[str], gtdb_taxonomy: list[str],
                   out=None) -> None:
    """Port of src/gtdb_psid_species2krona_taxonomy.pl: join
    '<psid>_<species>' rows with a GTDB taxonomy list into rank columns."""
    out = out or sys.stdout
    byspecies = {}
    for ln in gtdb_taxonomy:
        ln = ln.rstrip("\n")
        if ";s__" in ln:
            spn = ln.split(";s__", 1)[1].split(";", 1)[0]
            byspecies[spn] = ln
    for line in psid_species:
        line = line.rstrip("\n")
        if not line:
            continue
        psid, rest = line.split("_", 1)
        if rest not in byspecies:
            raise KeyError(f"{rest} does not exist in taxonomy")
        ranks = byspecies[rest].split(";")
        cols = [psid] + [r.split("__", 1)[-1] for r in ranks]
        out.write("\t".join(cols) + "\n")


def abv_match_metadata(abv_lines, metadata_csv_lines, out=None) -> None:
    """Port of src/abv_match_metaData.pl: join abv-search output with a
    run->project/sample/organism metadata csv."""
    out = out or sys.stdout
    it = iter(metadata_csv_lines)
    head = next(it).rstrip("\n").split(",")
    c2, c3, c4 = head[1], head[2], head[3]
    meta: dict[str, str] = {}
    for ln in it:
        parts = ln.rstrip("\n").split(",")
        if len(parts) >= 4 and parts[2] and parts[3]:
            meta[parts[0]] = f"{parts[1]}\t{parts[2]}\t{parts[3]}"
    for ln in abv_lines:
        ln = ln.rstrip("\n")
        if not ln:
            continue
        name, measure = ln.split("\t")[:2]
        if not name.endswith(".abv"):
            out.write(f"{name}\t{measure}\t{c2}\t{c3}\t{c4}\n")
        else:
            key = name.replace(".fastq", "")[:-4]
            out.write(f"{key}\t{measure}\t{meta.get(key, 'NA\tNA\tNA')}\n")
