"""A deployment's metadata.csv, and the fields a served result should carry.

The NextSearch server renders each result's title, url (cut at the first
';'), publish_time and first author ("Surname et al.") from the rows of
metadata.csv that its index directory holds, read by byte offset. A
configuration with a "metadata" group gets such a file: one row per
document, its cord_uid the one the segment gives the document ("doc<i>"),
in CORD-19's columns (those the engine reads among them) and with the
group's field lengths. The rows are drawn from the group's own seed, not
the run's, so a checkout writes the file once, under
searchbench/.data/<config>-<digest>/ (git-ignored; other digests of the
configuration are removed), and every later run links it.

expected(doc) works the rendered fields out again from the file's row, by
the rules above; it reads the file with Python's csv module and imports
nothing of the program.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

HEADER = ("cord_uid", "sha", "source_x", "title", "doi", "license",
          "abstract", "publish_time", "authors", "journal", "url")
SOURCES = ("PMC", "Medline", "Medline; PMC", "WHO", "Elsevier; PMC",
           "MedRxiv", "ArXiv")
LICENSES = ("cc-by", "els-covid", "no-cc", "cc-by-nc", "medrxiv", "arxiv")
CHUNK = 65536


class _Pool:
    """Random items joined by `sep`; a field of w items is a slice of the
    text that starts and ends on an item."""

    def __init__(self, items: np.ndarray, sep: str):
        lens = np.fromiter((len(x) for x in items), np.int64, len(items))
        self.ends = np.cumsum(lens + len(sep))  # one past each separator
        self.starts = self.ends - lens - len(sep)
        self.sep = len(sep)
        self.text = sep.join(items.tolist()) + sep

    def field(self, at: int, n: int) -> str:
        return self.text[self.starts[at]:self.ends[at + n - 1] - self.sep]


def _words(rng, n: int) -> np.ndarray:
    """n random lowercase words of 2 to 10 letters (6 on average)."""
    lens = rng.integers(2, 11, size=n)
    buf = rng.integers(97, 123, size=int(lens.sum()), dtype=np.uint8)
    text = buf.tobytes().decode("ascii")
    ends = np.cumsum(lens)
    return np.array([text[e - n_:e] for e, n_ in zip(ends, lens)], object)


def _rows(meta: dict, n_docs: int, first: int, rng, words: _Pool,
          authors: _Pool):
    """The CSV rows of documents first .. first + CHUNK - 1."""
    n = min(CHUNK, n_docs - first)
    title_w = rng.poisson(meta["title_words"] - 1, n) + 1
    abs_w = np.maximum(1, rng.poisson(meta["abstract_words"], n))
    n_auth = rng.poisson(meta["authors"] - 1, n) + 1
    jour_w = np.maximum(1, rng.poisson(meta["journal_words"], n))
    limit = len(words.starts) - 1024
    at = rng.integers(0, limit, size=(n, 4)).tolist()
    who = rng.integers(0, len(authors.starts) - 256, size=n).tolist()
    date = (rng.integers(2000, 2023, size=n) * 10000
            + rng.integers(1, 13, size=n) * 100
            + rng.integers(1, 29, size=n)).tolist()
    sha = rng.integers(0, 1 << 62, size=(n, 3)).tolist()
    pmc = rng.integers(1_000_000, 9_999_999, size=n).tolist()
    src = rng.integers(0, len(SOURCES), size=n).tolist()
    lic = rng.integers(0, len(LICENSES), size=n).tolist()
    out = []
    for j, (tw, aw, na, jw) in enumerate(zip(title_w.tolist(),
                                             abs_w.tolist(), n_auth.tolist(),
                                             jour_w.tolist())):
        a = at[j]
        doi = f"10.{1000 + pmc[j] % 9000}/{words.field(a[3], 1)}"
        d = date[j]
        out.append(
            f"doc{first + j},{sha[j][0]:016x}{sha[j][1]:016x}"
            f"{sha[j][2] & 0xFFFFFFFF:08x},{SOURCES[src[j]]},"
            f"{words.field(a[0], tw)},"
            f"{doi},{LICENSES[lic[j]]},{words.field(a[1], aw)},"
            f"{d // 10000}-{d // 100 % 100:02d}-{d % 100:02d},"
            f"\"{authors.field(who[j], na)}\",{words.field(a[2], jw)},"
            f"https://doi.org/{doi}; "
            f"https://www.ncbi.nlm.nih.gov/pmc/articles/PMC{pmc[j]}/\n")
    return out


def write(meta: dict, n_docs: int, path: Path) -> np.ndarray:
    """Write the metadata.csv of `meta` for n_docs documents at `path`;
    returns the byte offset of each row (and the file's end)."""
    rng = np.random.default_rng([int(meta["seed"]), n_docs])
    words = _Pool(_words(rng, 1 << 20), " ")
    surnames = _words(rng, 1 << 16)
    initials = rng.integers(65, 91, size=surnames.shape[0])
    authors = _Pool(np.array([f"{s.capitalize()}, {chr(i)}." for s, i in
                              zip(surnames, initials.tolist())], object),
                    "; ")
    offsets = np.empty(n_docs + 1, np.int64)
    head = (",".join(HEADER) + "\n").encode("ascii")
    pos = len(head)
    with open(path, "wb") as f:
        f.write(head)
        for first in range(0, n_docs, CHUNK):
            rows = _rows(meta, n_docs, first, rng, words, authors)
            lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
            offsets[first:first + len(rows)] = pos + np.concatenate(
                [[0], np.cumsum(lens)[:-1]])
            pos += int(lens.sum())
            f.write("".join(rows).encode("ascii"))
    offsets[n_docs] = pos
    return offsets


class Metadata:
    """A configuration's metadata.csv in the checkout's data directory,
    written on first use."""

    def __init__(self, cfg: dict, data_dir: Path):
        meta = cfg["metadata"]
        n = int(cfg["n_docs"])
        key = hashlib.sha256(json.dumps([meta, n], sort_keys=True)
                             .encode()).hexdigest()[:12]
        name = cfg["name"]
        self.dir = Path(data_dir) / f"{name}-{key}"
        self.path = self.dir / "metadata.csv"
        offsets = self.dir / "offsets.npy"
        if not offsets.exists():
            data_dir = Path(data_dir)
            data_dir.mkdir(parents=True, exist_ok=True)
            for old in data_dir.glob(f"{name}-*"):
                if old.name.rsplit("-", 1)[0] == name and old != self.dir:
                    shutil.rmtree(old, ignore_errors=True)
            self.dir.mkdir(exist_ok=True)
            part = self.dir / "metadata.csv.part"
            np.save(self.dir / "offsets.part.npy", write(meta, n, part))
            os.replace(part, self.path)
            os.replace(self.dir / "offsets.part.npy", offsets)
        self.offsets = np.load(offsets)
        self.n_docs = n

    def row(self, doc: int) -> dict:
        lo, hi = int(self.offsets[doc]), int(self.offsets[doc + 1])
        with open(self.path, "rb") as f:
            f.seek(lo)
            line = f.read(hi - lo).decode("ascii")
        return dict(zip(HEADER, next(csv.reader([line]))))

    def expected(self, doc: int) -> dict:
        """The fields a served result for `doc` should carry."""
        r = self.row(doc)
        first = r["authors"].split(";")[0].strip()
        return {
            "cord_uid": r["cord_uid"],
            "title": r["title"],
            "url": r["url"].split(";")[0],
            "publish_time": r["publish_time"],
            "author": first.split(",")[0].strip() + " et al.",
        }
