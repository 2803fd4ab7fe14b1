"""A copy of the benchmark at a size the CPU runs in seconds, for the
tests: the cells' own files with the configurations shrunk."""

import json
import shutil
from pathlib import Path

from kssd_bench import run

REPO = Path(__file__).resolve().parents[2]
TINY = {
    "abv_mkssd_gtdb_r214_node8": dict(
        n_species=3000, species_pool=3000, n_samples=600,
        species_per_sample=dict(median=150, sigma=0.7, min=5, max=1000)),
}
SEED = 2**31 + 11


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and kssd_bench/ with tiny configs."""
    shutil.copytree(REPO / "kssd_bench", tmp / "kssd_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, upd in TINY.items():
        p = tmp / "kssd_bench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(upd)
        p.write_text(json.dumps(cfg))
    return tmp


def add_cell(root: Path, workload: str, config: str, traffic: str,
             traffic_params: dict, limits_from: str) -> None:
    """A new cell as files only: its traffic file, its limits file and
    its entry in BENCHMARK.json."""
    (root / "kssd_bench" / "traffic" / f"{traffic}.json").write_text(
        json.dumps(traffic_params))
    shutil.copy(root / "kssd_bench" / "limits" / f"{limits_from}.json",
                root / "kssd_bench" / "limits" / f"{workload}.json")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": workload, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def run_cell(root: Path, workload: str, capsys, *, seed: int = SEED,
             seconds: float = 0.3, trace: int = 0):
    """(exit code, the result's JSON or None, standard error)."""
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  root=root, device="cpu")
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err
