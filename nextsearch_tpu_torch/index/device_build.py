"""Dense heavy-term score rows, and the heavy bucket table, built on the
device from the uploaded postings (port of
nextsearch_tpu/index/device_build.py build_heavy_on_device for the sparse
mode).

Each dense row is a pure function of its term's postings: row[doc] = the
doc's eager BM25 score for that term (f32, or rounded to bf16 to nearest
even), 0 elsewhere. The host passes one (posting start, df, target row)
entry per (heavy term, segment); the device expands the entries into
posting positions and writes them with one indexed store per group of
entries. The JAX version's grouping into <= 512 rows per program was a TPU
compiler limit and has no counterpart here; entries are grouped only to
bound the expansion's scratch memory.

The bucket table (with_buckets, for the bf16-rows configuration's v2
rescore) gives, per row, the offset from the row's first posting of the
first posting in each 2^BUCKET_LOG2-doc bucket: a per-(row, bucket)
posting count, then a running sum along the row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bm25_sparse import BUCKET_LOG2

_MAX_EXPAND = 1 << 24  # postings expanded per store (bounds int64 scratch)


def build_heavy_on_device(post_doc: torch.Tensor, post_score: torch.Tensor,
                          starts, dfs, *, rows=None, n_rows_pad: int,
                          n_slots: int, bf16: bool = False,
                          with_buckets: bool = False):
    """(dense rows [n_rows_pad, n_slots], bucket table or None, max bucket
    occupancy) on post_doc's device.

    starts/dfs: host int arrays, one entry each; rows maps each entry to its
    target row (ascending; many-to-one for merged multi-segment rows), None
    meaning entry i -> row i. Rows without an entry (the sentinel row
    n_dense and the padding up to n_rows_pad) stay zero. The rows are f32,
    or bf16 when `bf16` (the f32 score rounded to nearest even). Equal row
    for row to the JAX table's first n_rows_pad rows. with_buckets also
    returns the heavy bucket table int32 [n_rows_pad, NB + 1], NB =
    ceil(n_slots / 2^BUCKET_LOG2), and its largest bucket's posting count,
    equal to the JAX _build_buckets'; otherwise (dense, None, 0)."""
    dev = post_doc.device
    dtype = torch.bfloat16 if bf16 else torch.float32
    dense = torch.zeros((n_rows_pad, n_slots), dtype=dtype, device=dev)
    nb = (n_slots + (1 << BUCKET_LOG2) - 1) >> BUCKET_LOG2
    buckets = (torch.zeros((n_rows_pad, nb + 1), dtype=torch.int32, device=dev)
               if with_buckets else None)
    starts = np.asarray(starts, np.int64)
    dfs = np.asarray(dfs, np.int64)
    if dfs.size == 0:
        return dense, buckets, 0
    rows = (np.arange(dfs.size, dtype=np.int64) if rows is None
            else np.asarray(rows, np.int64))
    flat = dense.view(-1)
    counts = buckets.view(-1) if with_buckets else None
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
            row = g_rows[ent]
            flat[row * n_slots + doc] = post_score[pos].to(dtype)
            if with_buckets:
                # bucket b's count lands in column b + 1; the running sum
                # below turns counts into first-posting offsets
                cell = row * (nb + 1) + 1 + (doc >> BUCKET_LOG2)
                counts.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
        lo = hi
    occ = 0
    if with_buckets:
        occ = int(buckets.max())
        buckets.cumsum_(dim=1)
    return dense, buckets, occ
