"""The port's offline CLI tools (make_synthetic -> forwardindex -> lexicon,
adddocument, slice_cord19, backup_data) on the CPU: the cases of
tests/test_tools.py on the port's modules, each tool's output held byte for
byte to the JAX package's tool on the same input, and an index built with
the port's forwardindex + lexicon served by the port's Engine."""

import json
import zipfile

import numpy as np
import pytest
import torch

from nextsearch_tpu.tools import backup_data as jbackup
from nextsearch_tpu.tools import forwardindex as jforward
from nextsearch_tpu.tools import lexicon as jlexicon
from nextsearch_tpu.tools import make_synthetic as jsynthetic
from nextsearch_tpu.tools import slice_cord19 as jslice
from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.oracle import oracle_search
from nextsearch_tpu_torch.index.segmentio import (discover_segments,
                                                  load_forward_stage,
                                                  load_segment, save_manifest)
from nextsearch_tpu_torch.tools import (adddocument, backup_data, forwardindex,
                                        lexicon, make_synthetic, slice_cord19)
from nextsearch_tpu_torch.utils.csvutil import csv_row

torch.set_num_threads(1)


def _files(root):
    """relative path -> bytes of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    assert make_synthetic.main([str(root), "--n", "40", "--vocab", "300",
                                "--seed", "3"]) == 0
    return root


def test_make_synthetic_equals_jax(corpus, tmp_path):
    ref = tmp_path / "ref"
    assert jsynthetic.main([str(ref), "--n", "40", "--vocab", "300",
                            "--seed", "3"]) == 0
    got, want = _files(corpus), _files(ref)
    assert len(got) == 41 and got == want


def test_pipeline_end_to_end(corpus, tmp_path):
    segdir = tmp_path / "segments" / "seg_000001"
    assert forwardindex.run(str(corpus), str(segdir)) == 0
    for f in ("docs.bin", "stats.bin", "forward.bin", "terms.bin"):
        assert (segdir / f).exists(), f
    assert not (segdir / "barrels.bin").exists()  # stage 1 only

    assert lexicon.run(str(segdir)) == 0
    assert (segdir / "barrels.bin").exists()

    seg = load_segment(segdir)
    assert seg.N == 40
    assert np.array_equal(np.diff(seg.term_offsets), seg.term_df)
    fwd = load_forward_stage(segdir)
    assert fwd.terms == seg.terms
    assert np.array_equal(fwd.post_doc, seg.post_doc)
    assert np.array_equal(fwd.post_tf, seg.post_tf)

    # the JAX package's two stages write the same bytes
    ref = tmp_path / "ref" / "seg_000001"
    assert jforward.run(str(corpus), str(ref)) == 0
    assert jlexicon.run(str(ref)) == 0
    got, want = _files(segdir), _files(ref)
    assert len(got) > 60 and got == want


def test_lexicon_usage_and_missing_stage(tmp_path, capsys):
    assert lexicon.main([]) == 1
    assert "nextsearch_tpu_torch.tools.lexicon" in capsys.readouterr().err
    assert lexicon.run(str(tmp_path)) == 1
    assert "Missing forward.bin" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["fused", "sparse"])
def test_built_index_serves(corpus, tmp_path, mode):
    """The verify skill's index build: forwardindex + lexicon + a manifest,
    then the port's Engine answers as the oracle does, and suggests."""
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig

    index_dir = tmp_path / "index"
    segdir = index_dir / "segments" / "seg_000001"
    assert forwardindex.run(str(corpus), str(segdir)) == 0
    assert lexicon.run(str(segdir)) == 0
    save_manifest(index_dir / "manifest.bin", ["seg_000001"])
    eng = Engine(index_dir, config=EngineConfig(device=DeviceConfig(mode=mode)),
                 cache_dir=tmp_path, device="cpu")
    assert eng.reload()
    oseg = [load_segment(segdir).to_oracle_segment()]
    for q in ("covid", "virus vaccine", "protein cell lung", "w00250"):
        body = eng.search(q, 10)
        hits, found = oracle_search(oseg, [(t, 1.0) for t in q.split()], k=10)
        assert body["found"] == found, q
        assert [(np.float32(r["score"]), r["docId"]) for r in body["results"]] == [
            (np.float32(s), d) for s, _g, d in hits], q
    assert eng.suggest("cov", 5)["suggestions"][0] == "covid"


def test_adddocument_and_search(corpus, tmp_path):
    index_dir = tmp_path / "index"
    segdir = index_dir / "segments" / "seg_000001"
    forwardindex.run(str(corpus), str(segdir))
    lexicon.run(str(segdir))
    save_manifest(index_dir / "manifest.bin", ["seg_000001"])

    doc = {
        "paper_id": "nd",
        "title": "axolotl research",
        "body_text": [{"text": "axolotl regeneration axolotl covid"}],
    }
    rel = "document_parses/pmc_json/nd.xml.json"
    (corpus / rel).write_text(json.dumps(doc))
    try:
        rc = adddocument.run(str(index_dir), str(corpus), rel, "nd",
                             "axolotl research")
    finally:
        (corpus / rel).unlink()  # the module-scoped corpus stays as made
    assert rc == 0
    assert discover_segments(index_dir) == ["seg_000001", "seg_000002"]
    seg2 = load_segment(index_dir / "segments" / "seg_000002")
    assert seg2.N == 1 and seg2.cord_uids == ["nd"]
    docs, tfs = seg2.postings("axolotl")
    assert docs.tolist() == [0] and tfs.tolist() == [3]


def test_slice_cord19(corpus, tmp_path):
    out = tmp_path / "slice"
    args = ["--in_root", str(corpus), "--n", "10", "--seed", "7",
            "--prefer", "pmc"]
    rc = slice_cord19.main(args + ["--out_root", str(out)])
    assert rc == 0
    lines = (out / "metadata.csv").read_text().strip().split("\n")
    assert len(lines) == 11  # header + 10
    cols = csv_row(lines[0])
    i_pmc = cols.index("pmc_json_files")
    for line in lines[1:]:
        rel = csv_row(line)[i_pmc]
        assert (out / rel).exists()
    # the JAX tool picks and writes the same slice
    assert jslice.main(args + ["--out_root", str(tmp_path / "ref")]) == 0
    assert _files(out) == _files(tmp_path / "ref")
    assert slice_cord19.main(["--in_root", str(tmp_path), "--out_root",
                              str(tmp_path / "x"), "--n", "1"]) == 1


def test_backup_data(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "stats.json").write_text("{}")
    (tmp_path / "feedback.json").write_text("{}")
    assert backup_data.main(["b.zip", str(tmp_path)]) == 0
    assert jbackup.main(["ref.zip", str(tmp_path)]) == 0
    with zipfile.ZipFile(tmp_path / "b.zip") as z, \
            zipfile.ZipFile(tmp_path / "ref.zip") as ref:
        assert set(z.namelist()) == {"stats.json", "feedback.json"}
        assert z.namelist() == ref.namelist()
        assert all(z.read(n) == ref.read(n) for n in z.namelist())
