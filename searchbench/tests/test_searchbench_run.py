"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): sound runs come out correct; the control and planted faults
come out not correct; a cell added by files and entries alone is found
and run; the command fails without a card; nothing loads jax or the JAX
package, and the reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import MIXES, ROOT, TINY, add_cell
from searchbench import judge
from searchbench.reference import Bm25Reference
from searchbench.run import load_cell, run_cell

SEED = 3_000_000_019  # wider than 32 bits


def quiet(*_a, **_k):
    pass


def run_tiny(root, name, trace=False, seconds=1.0):
    return run_cell(load_cell(name, root), SEED, seconds, trace, "cpu",
                    log=quiet)


CELLS = ["tiny.closed", "tiny-bare.closed"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench_root, name):
    res = run_tiny(bench_root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"qps", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_span_metrics(bench_root, name):
    res = run_tiny(bench_root, name, trace=True, seconds=2.5)
    assert res["correct"]
    # the CPU has no device trace: only the span and counter readers read
    assert set(res["metrics"]) == {"setup.index_build_s", "setup.warmup_s",
                                   "engine.cache_flush_share.closed"}
    assert 0 < res["metrics"]["engine.cache_flush_share.closed"]["value"] < 100
    assert "device_ops" not in res.get("breakdown", {})


def test_rendered_results_carry_their_metadata(bench_root):
    """The deployment's metadata.csv is written once, linked into the index
    directory, and each sampled result's fields come from its doc's row."""
    from searchbench.metadata import Metadata

    cell = load_cell("tiny.closed", bench_root)
    res = run_cell(cell, SEED, 0.5, False, "cpu", log=quiet)
    assert res["correct"] and res["checks"]["meta_err"]["value"] == 0
    meta = Metadata(cell["cfg"], bench_root / "searchbench" / ".data")
    assert len(meta.offsets) == TINY["n_docs"] + 1
    stamp = meta.path.stat().st_mtime_ns
    run_cell(cell, SEED + 1, 0.5, False, "cpu", log=quiet)
    assert meta.path.stat().st_mtime_ns == stamp
    row = meta.expected(17)
    assert row["cord_uid"] == "doc17" and row["author"].endswith(" et al.")
    assert row["title"] and row["url"].startswith("https://doi.org/")


@pytest.mark.parametrize("precision", ["tf32", "bfloat16"])
def test_control_is_not_correct(precision):
    """The reference in TF32 or bfloat16, put in the program's place, fails
    score_err's limit on the same queries."""
    from searchbench.corpus import generate
    from searchbench.traffic import query_stream

    cfg = dict(TINY, n_docs=20000, vocab=5000)
    corpus = generate(cfg, SEED, "cpu")
    ref = Bm25Reference(corpus.term_offsets, corpus.post_doc,
                        corpus.post_tf, corpus.doc_len, "cpu")
    qs = query_stream(cfg, 300, np.random.default_rng(5))
    items = [(t, text, None) for t, text in qs]
    exact = judge.judge(judge.control_answers(items, ref, 10, "float64"),
                        ref, 10)
    assert judge.verdict(exact), exact
    c = judge.judge(judge.control_answers(items, ref, 10, precision), ref, 10)
    assert not judge.verdict(c), c
    assert c["score_err"] > 3 * judge.LIMITS["score_err"]


def _shift_docs(results):
    """An answer altered where it is produced: every doc slot moved by 1."""
    for r in results:
        r.doc_slots[:] = r.doc_slots + 1
    return results


def _drop_half(results):
    """Half of the batch left out: the second half's answers empty."""
    from nextsearch_tpu_torch.index.planner import QueryResult

    h = len(results) // 2
    return results[:h] + [QueryResult(np.empty(0, np.float32),
                                      np.empty(0, np.int32), 0)
                          for _ in results[h:]]


@pytest.mark.parametrize("fault", [_shift_docs, _drop_half],
                         ids=["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(bench_root, monkeypatch, fault, name):
    from nextsearch_tpu_torch.index.segment import TorchIndex

    real = TorchIndex.search_batch_gather
    monkeypatch.setattr(TorchIndex, "search_batch_gather",
                        lambda self, h: fault(real(self, h)))
    res = run_tiny(bench_root, name)
    assert not res["correct"], res["checks"]


def test_metadata_of_another_doc_is_not_correct(bench_root, monkeypatch):
    """A fault where the metadata is produced: each cord_uid mapped to the
    next row of metadata.csv, so every result renders its neighbour's
    title, url, date and author."""
    from nextsearch_tpu_torch.index import metadata as md

    real = md.load_metadata_uid_meta

    def shifted(path):
        m = real(path)
        vals = list(m.values())
        return dict(zip(m, vals[1:] + vals[:1]))

    monkeypatch.setattr(md, "load_metadata_uid_meta", shifted)
    res = run_tiny(bench_root, "tiny.closed")
    assert not res["correct"]
    assert res["checks"]["meta_err"]["value"] > 0
    assert res["checks"]["score_err"]["value"] <= judge.LIMITS["score_err"]


def test_cell_added_by_files_alone(bench_root):
    """A new configuration, mix, cell and per-layer metric, as new files and
    new BENCHMARK.json entries, run without a change to any file that was
    there."""
    before = {p: p.read_bytes() for p in (bench_root / "searchbench").rglob("*")
              if p.is_file()}
    cfg = dict(TINY, name="tiny2", n_docs=2500, mode="sparse",
               env={"NEXTSEARCH_POSTING_BLOCK": "64"},
               metadata=dict(TINY["metadata"], title_words=5))
    add_cell(bench_root, "tiny2.closed", cfg, "tiny-closed-3x32",
             {"loop": "closed", "clients": 3, "queries_per_request": 32,
              "stream": 2048, "warm_seconds": 0.2},
             metrics={"engine.answers_seen": (
                 "def read(run):\n"
                 "    return float(len(run.window.answers))\n")})
    for p, data in before.items():
        assert p.read_bytes() == data, p
    cell = load_cell("tiny2.closed", bench_root)
    assert cell["mix"]["clients"] == 3 and cell["cfg"]["mode"] == "sparse"
    res = run_cell(cell, SEED, 1.0, True, "cpu", log=quiet)
    assert res["correct"]
    assert res["metrics"]["engine.answers_seen"]["value"] > 0


def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "searchbench.run", "--workload",
         "cord19-1m.closed", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and searchbench/ the run
    cannot import the program and prints no result (a tiny cell, added
    there, is run on the CPU past the look for a card)."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "searchbench", tmp_path / "searchbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".data"))
    add_cell(tmp_path, "tiny.closed", TINY, "tiny-closed",
             MIXES["tiny-closed"])
    code = ("import sys, searchbench.run as r; "
            "sys.exit(r.run_cell(r.load_cell('tiny.closed'), 1, 1, "
            "False, 'cpu') and 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


FORBIDDEN_CHECK = (
    "import sys; top = {m.split('.')[0] for m in sys.modules}; "
    "print(json.dumps(sorted(top & {'jax', 'jaxlib', 'flax', "
    "'nextsearch_tpu', 'nextsearch_tpu_torch'})))")


def test_reference_and_judge_load_nothing_of_the_program():
    code = ("import json, searchbench.reference, searchbench.judge, "
            "searchbench.corpus, searchbench.roofline; " + FORBIDDEN_CHECK)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "JAX_PLATFORMS"})
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_a_whole_run_loads_no_jax(bench_root):
    """A whole tiny run in a fresh process: the program loads, and neither
    jax, jaxlib, flax nor the JAX package does (top-level names whole)."""
    code = ("import json, sys; from pathlib import Path; "
            "import searchbench.run as r; "
            f"r.run_cell(r.load_cell('tiny.closed', Path({str(bench_root)!r})),"
            " 5, 0.5, True, 'cpu', log=lambda *a, **k: None); "
            "print(json.dumps(r.forbidden_modules())); " + FORBIDDEN_CHECK)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert json.loads(lines[-1]) == ["nextsearch_tpu_torch"]


def test_pin_host_pins_the_threads_started_later():
    """pin_host pins the process's threads to CPUs on cores of their own,
    and a thread started afterwards inherits them (in a fresh process, so
    that the tests' own process stays unpinned)."""
    code = (
        "import json, os, threading; from searchbench.run import pin_host; "
        "n = min(2, len(os.sched_getaffinity(0))); cpus = pin_host(n); "
        "seen = []; t = threading.Thread(target=lambda: seen.append("
        "sorted(os.sched_getaffinity(0)))); t.start(); t.join(); "
        "print(json.dumps([n, cpus, seen[0], pin_host(None)]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    n, cpus, seen, none = json.loads(p.stdout.strip().splitlines()[-1])
    assert len(cpus) == n and seen == cpus and none == []
