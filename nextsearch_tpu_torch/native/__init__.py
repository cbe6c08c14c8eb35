"""ctypes bindings for the C++ host runtime (libnextsearch_native.so).

Build on first use via the Makefile (g++ is in the image), into the
package's build/ directory; every entry point
has a pure-Python fallback, so the package works without a toolchain. Parity
between the two paths is enforced by tests/test_native.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import log

_HERE = Path(__file__).parent
_SO = _HERE.parent / "build" / "libnextsearch_native.so"
_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def _try_build() -> bool:
    global _build_attempted
    if _build_attempted:
        return _SO.exists()
    _build_attempted = True
    try:
        subprocess.run(
            ["make", "-s", "-C", str(_HERE)],
            check=True,
            capture_output=True,
            timeout=180,
        )
        return _SO.exists()
    except (OSError, subprocess.SubprocessError) as e:
        log("native", f"build failed, using Python fallback: {e}")
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if absent."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() and not _try_build():
            return None
        lib = ctypes.CDLL(str(_SO))

        lib.ns_builder_new.restype = ctypes.c_void_p
        lib.ns_builder_free.argtypes = [ctypes.c_void_p]
        lib.ns_builder_add_doc.restype = ctypes.c_uint32
        lib.ns_builder_add_doc.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ns_builder_finalize.restype = ctypes.c_uint64
        lib.ns_builder_finalize.argtypes = [ctypes.c_void_p]
        for fn in ("ns_builder_num_terms", "ns_builder_num_docs"):
            getattr(lib, fn).restype = ctypes.c_uint32
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.ns_builder_total_len.restype = ctypes.c_uint64
        lib.ns_builder_total_len.argtypes = [ctypes.c_void_p]
        lib.ns_builder_terms_blob_size.restype = ctypes.c_uint64
        lib.ns_builder_terms_blob_size.argtypes = [ctypes.c_void_p]
        lib.ns_builder_export.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ns_tokenize.restype = ctypes.c_uint64
        lib.ns_tokenize.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ns_scan_csv_offsets.restype = ctypes.c_uint64
        lib.ns_scan_csv_offsets.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ]
        lib.nsr_new.restype = ctypes.c_void_p
        lib.nsr_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.nsr_free.argtypes = [ctypes.c_void_p]
        lib.nsr_add_segment.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.nsr_render.restype = ctypes.c_int64
        lib.nsr_render.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nsr_buf.restype = ctypes.c_void_p
        lib.nsr_buf.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def tokenize_native(text: str | bytes) -> List[str]:
    """Native tokenizer (parity with utils.textutil.tokenize)."""
    lib = get_lib()
    assert lib is not None
    data = text.encode("utf-8", errors="surrogatepass") if isinstance(text, str) else text
    n_tokens = ctypes.c_uint64(0)
    needed = lib.ns_tokenize(data, len(data), None, 0, ctypes.byref(n_tokens))
    buf = ctypes.create_string_buffer(int(needed))
    lib.ns_tokenize(data, len(data), buf, needed, ctypes.byref(n_tokens))
    out: List[str] = []
    pos = 0
    raw = buf.raw
    for _ in range(n_tokens.value):
        ln = int.from_bytes(raw[pos : pos + 4], "little")
        out.append(raw[pos + 4 : pos + 4 + ln].decode("ascii"))
        pos += 4 + ln
    return out


class NativeForwardBuilder:
    """Streaming native forward-index builder (doc texts in, CSR out)."""

    def __init__(self):
        self._lib = get_lib()
        assert self._lib is not None, "native library unavailable"
        self._h = self._lib.ns_builder_new()

    def add_doc(self, text: str | bytes) -> int:
        data = (
            text.encode("utf-8", errors="surrogatepass")
            if isinstance(text, str)
            else text
        )
        return int(self._lib.ns_builder_add_doc(self._h, data, len(data)))

    def finish(self):
        """Invert and export: (terms, legacy_ids, term_df, term_offsets,
        post_doc, post_tf, doc_len, total_len)."""
        lib = self._lib
        P = int(lib.ns_builder_finalize(self._h))
        T = int(lib.ns_builder_num_terms(self._h))
        N = int(lib.ns_builder_num_docs(self._h))
        total_len = int(lib.ns_builder_total_len(self._h))
        blob_size = int(lib.ns_builder_terms_blob_size(self._h))

        terms_blob = ctypes.create_string_buffer(max(blob_size, 1))
        term_lens = np.zeros(max(T, 1), np.uint32)
        legacy_ids = np.zeros(max(T, 1), np.int32)
        term_df = np.zeros(max(T, 1), np.int32)
        term_offsets = np.zeros(T + 1, np.int64)
        post_doc = np.zeros(max(P, 1), np.int32)
        post_tf = np.zeros(max(P, 1), np.int32)
        doc_len = np.zeros(max(N, 1), np.int32)

        def ptr(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        lib.ns_builder_export(
            self._h, terms_blob,
            ptr(term_lens, ctypes.c_uint32), ptr(legacy_ids, ctypes.c_int32),
            ptr(term_df, ctypes.c_int32), ptr(term_offsets, ctypes.c_int64),
            ptr(post_doc, ctypes.c_int32), ptr(post_tf, ctypes.c_int32),
            ptr(doc_len, ctypes.c_int32),
        )
        terms: List[str] = []
        pos = 0
        raw = terms_blob.raw
        for i in range(T):
            ln = int(term_lens[i])
            terms.append(raw[pos : pos + ln].decode("ascii"))
            pos += ln
        return (
            terms, legacy_ids[:T], term_df[:T], term_offsets,
            post_doc[:P], post_tf[:P], doc_len[:N], total_len,
        )

    def close(self):
        if self._h:
            self._lib.ns_builder_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeRenderer:
    """Native batch-response JSON serializer (render_native.cpp).

    Registered once per reload with the index's doc tables + metadata.csv
    byte offsets; render() turns one batch's flat result arrays into
    per-query compact JSON fragments (the exact per-query object shape of
    the Python render in engine.search_batch_gather) without touching a
    Python dict — the measured ~28 ms/512-batch render+dumps host cost
    drops to ~2-4 ms. Field parity with the Python renderer is enforced
    by tests/test_native.py."""

    def __init__(self, metadata_csv_path: str):
        self._lib = get_lib()
        assert self._lib is not None, "native library unavailable"
        p = str(metadata_csv_path).encode("utf-8")
        self._h = self._lib.nsr_new(p, len(p))

    def add_segment(
        self,
        name: str,
        base: int,
        cord_uids: List[str],
        meta_off: np.ndarray,
        meta_len: np.ndarray,
    ) -> None:
        n = len(cord_uids)
        blob = "".join(cord_uids).encode("utf-8")
        offs = np.zeros(n + 1, np.int64)
        if n:
            np.cumsum(
                [len(u.encode("utf-8")) for u in cord_uids], out=offs[1:]
            )
        meta_off = np.ascontiguousarray(meta_off, np.int64)
        meta_len = np.ascontiguousarray(meta_len, np.int32)
        nm = name.encode("utf-8")
        self._lib.nsr_add_segment(
            self._h, nm, len(nm), base, n, blob, len(blob),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            meta_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            meta_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def render(
        self,
        queries: List[str],
        seg_count: int,
        ks: np.ndarray,
        founds: np.ndarray,
        counts: np.ndarray,
        scores: np.ndarray,
        slots: np.ndarray,
    ) -> List[bytes]:
        """Per-query compact JSON response objects, one bytes each."""
        nq = len(queries)
        encoded = [q.encode("utf-8") for q in queries]
        q_blob = b"".join(encoded)
        q_offs = np.zeros(nq + 1, np.int64)
        np.cumsum(list(map(len, encoded)), out=q_offs[1:])
        ks = np.ascontiguousarray(ks, np.int32)
        founds = np.ascontiguousarray(founds, np.int32)
        counts = np.ascontiguousarray(counts, np.int32)
        scores = np.ascontiguousarray(scores, np.float32)
        slots = np.ascontiguousarray(slots, np.int32)
        frag_offs = np.zeros(nq + 1, np.int64)

        def ptr(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        total = self._lib.nsr_render(
            self._h, nq, seg_count, q_blob,
            ptr(q_offs, ctypes.c_int64),
            ptr(ks, ctypes.c_int32), ptr(founds, ctypes.c_int32),
            ptr(counts, ctypes.c_int32),
            ptr(scores, ctypes.c_float), ptr(slots, ctypes.c_int32),
            ptr(frag_offs, ctypes.c_int64),
        )
        buf = ctypes.string_at(self._lib.nsr_buf(self._h), int(total))
        offs = frag_offs.tolist()
        return [buf[a:b] for a, b in zip(offs, offs[1:])]

    def close(self):
        if self._h:
            self._lib.nsr_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def scan_csv_offsets_native(
    data: bytes, uid_col: int, max_rows: Optional[int] = None
) -> List[Tuple[str, int, int]]:
    """Native metadata.csv scan: [(uid, offset, row_length)] in file order."""
    lib = get_lib()
    assert lib is not None
    cap = max_rows if max_rows is not None else data.count(b"\n") + 2
    offsets = np.zeros(cap, np.uint64)
    lengths = np.zeros(cap, np.uint32)
    blob_cap = len(data) + 4 * cap + 16
    blob = ctypes.create_string_buffer(blob_cap)
    used = ctypes.c_uint64(0)
    rows = int(
        lib.ns_scan_csv_offsets(
            data, len(data), uid_col,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            blob, blob_cap, ctypes.byref(used), cap,
        )
    )
    out: List[Tuple[str, int, int]] = []
    raw = blob.raw
    pos = 0
    for i in range(rows):
        ln = int.from_bytes(raw[pos : pos + 4], "little")
        uid = raw[pos + 4 : pos + 4 + ln].decode("utf-8", errors="replace")
        pos += 4 + ln
        out.append((uid, int(offsets[i]), int(lengths[i])))
    return out
