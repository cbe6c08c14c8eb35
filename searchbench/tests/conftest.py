"""Fixtures of the harness's CPU tests: a copy of the benchmark in a
temporary root with tiny cells added to its BENCHMARK.json, run on the CPU
with the kernels' plain versions.

    python -m pytest searchbench/tests -q
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny",
    "source": "a 3,000-document corpus for the harness's CPU tests",
    "n_docs": 3000,
    "mean_tokens": 20,
    "vocab": 2000,
    "zipf_s": 1.07,
    "query_terms": [1, 4],
    "k": 10,
    "mode": "fused",
    "env": {},
    "metadata": {"seed": 7, "title_words": 13, "abstract_words": 40,
                 "authors": 6, "journal_words": 3},
    "reduced": ["n_docs"],
    "assumed": [],
}
# the same deployment without a metadata.csv (as MS MARCO's passages,
# which have no title, url or author, would be served)
BARE = dict({k: v for k, v in TINY.items() if k != "metadata"},
            name="tiny-bare")
MIXES = {
    "tiny-closed": {"loop": "closed", "clients": 2, "queries_per_request": 64,
                    "stream": 4096, "warm_seconds": 0.3},
}


def add_cell(root: Path, name: str, config: dict, mix_name: str, mix: dict,
             metrics=()):
    """Add a cell to the benchmark under `root` by new files and new
    BENCHMARK.json entries only: its configuration, its traffic mix and
    the per-layer metrics `metrics` ({name: reader source, or None for a
    reader file that is there})."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg_file = f"searchbench/configs/{config['name']}.json"
    if not (root / cfg_file).exists():
        (root / cfg_file).write_text(json.dumps(config))
        bench["configs"].append({
            "name": config["name"], "source": config["source"],
            "file": cfg_file, "reduced": config["reduced"],
            "why": "tiny"})
    mix_file = root / "searchbench" / "traffic" / f"{mix_name}.json"
    if not mix_file.exists():
        mix_file.write_text(json.dumps(mix))
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": mix_name, "chips": 1,
                               "why": "tiny"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "qps")["workloads"].append(name)
    for m in bench["per_layer"]:
        if m["name"].startswith("setup.") or m["name"] == (
                "engine.cache_flush_share.closed"):
            m["workloads"].append(name)
    for metric, source in dict(metrics).items():
        if source is not None:
            (root / "searchbench" / "metrics" / f"{metric}.py").write_text(
                source)
        entry = next((m for m in bench["per_layer"]
                      if m["name"] == metric), None)
        if entry is None:
            entry = {"name": metric, "unit": "count", "better": "higher",
                     "source": "program_counter", "layer": "Engine",
                     "moves": "setup_s", "workloads": []}
            bench["per_layer"].append(entry)
        entry["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


@pytest.fixture()
def bench_root(tmp_path):
    """A copy of BENCHMARK.json and searchbench/ with tiny.closed (with a
    metadata.csv) and tiny-bare.closed (without) added as files and
    entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "searchbench", tmp_path / "searchbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  ".data"))
    add_cell(tmp_path, "tiny.closed", TINY, "tiny-closed",
             MIXES["tiny-closed"])
    add_cell(tmp_path, "tiny-bare.closed", BARE, "tiny-closed",
             MIXES["tiny-closed"])
    return tmp_path
