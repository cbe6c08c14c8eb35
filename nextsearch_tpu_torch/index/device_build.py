"""Dense heavy-term score rows built on the device from the uploaded
postings (port of nextsearch_tpu/index/device_build.py
build_heavy_on_device for the sparse mode's f32 rows).

Each dense row is a pure function of its term's postings: row[doc] = the
doc's eager BM25 score for that term, 0 elsewhere. The host passes one
(posting start, df, target row) entry per (heavy term, segment); the device
expands the entries into posting positions and writes them with one indexed
store per group of entries. The JAX version's grouping into <= 512 rows per
program was a TPU compiler limit and has no counterpart here; entries are
grouped only to bound the expansion's scratch memory.
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_EXPAND = 1 << 24  # postings expanded per store (bounds int64 scratch)


def build_heavy_on_device(post_doc: torch.Tensor, post_score: torch.Tensor,
                          starts, dfs, *, rows=None, n_rows_pad: int,
                          n_slots: int) -> torch.Tensor:
    """f32 dense rows [n_rows_pad, n_slots] on post_doc's device.

    starts/dfs: host int arrays, one entry each; rows maps each entry to its
    target row (many-to-one for merged multi-segment rows), None meaning
    entry i -> row i. Rows without an entry (the sentinel row n_dense and
    the padding up to n_rows_pad) stay zero. Equal row for row to the JAX
    table's first n_rows_pad rows."""
    dev = post_doc.device
    dense = torch.zeros((n_rows_pad, n_slots), dtype=torch.float32, device=dev)
    starts = np.asarray(starts, np.int64)
    dfs = np.asarray(dfs, np.int64)
    if dfs.size == 0:
        return dense
    rows = (np.arange(dfs.size, dtype=np.int64) if rows is None
            else np.asarray(rows, np.int64))
    flat = dense.view(-1)
    lo = 0
    while lo < dfs.size:
        # one group: as many entries as fit the expansion budget (>= 1)
        hi = lo + 1
        total = int(dfs[lo])
        while hi < dfs.size and total + int(dfs[hi]) <= _MAX_EXPAND:
            total += int(dfs[hi])
            hi += 1
        if total:
            g_dfs = torch.as_tensor(dfs[lo:hi], device=dev)
            g_starts = torch.as_tensor(starts[lo:hi], device=dev)
            g_rows = torch.as_tensor(rows[lo:hi], device=dev)
            ent = torch.repeat_interleave(
                torch.arange(hi - lo, device=dev), g_dfs, output_size=total
            )
            cum = torch.cumsum(g_dfs, 0)
            within = torch.arange(total, device=dev) - (cum - g_dfs)[ent]
            pos = g_starts[ent] + within
            doc = post_doc[pos].to(torch.int64).clamp(0, n_slots - 1)
            flat[g_rows[ent] * n_slots + doc] = post_score[pos]
        lo = hi
    return dense
