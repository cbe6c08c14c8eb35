"""Index tables built on the device from the uploaded postings (port of
nextsearch_tpu/index/device_build.py): the dense heavy-term score rows with
the heavy bucket table, the light bucket table, and the row top-k of the
df-head dense rows.

Each dense row is a pure function of its term's postings: row[doc] = the
doc's eager BM25 score for that term (f32, or rounded to bf16 to nearest
even), 0 elsewhere. The host passes one (posting start, df, target row)
entry per (heavy term, segment); the device expands the entries into
posting positions and writes them with one indexed store per group of
entries. The JAX version's grouping into <= 512 rows per program was a TPU
compiler limit and has no counterpart here; entries are grouped only to
bound the expansion's scratch memory.

A bucket table (the heavy one for the bf16-rows configuration's v2
rescore, the light one for every light (term, segment) row) gives, per
row, the offset from the row's first posting of the first posting in each
2^bucket_log2-doc bucket: a per-(row, bucket) posting count, then a running
sum along the row. Both builders count through _build_buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bm25 import f32_order_key
from ..ops.bm25_sparse import BUCKET_LOG2, LIGHT_BUCKET_LOG2

_MAX_EXPAND = 1 << 24  # postings expanded per store (bounds int64 scratch)


def _expand_groups(post_doc, starts, dfs, rows, n_slots: int):
    """Yield (row, pos, doc) int64 tensors on post_doc's device, one group
    of entries at a time: for every posting of every entry, its target row,
    its posting position and its doc slot (clamped to n_slots - 1). A group
    holds as many entries as fit _MAX_EXPAND postings (at least one)."""
    dev = post_doc.device
    lo = 0
    while lo < dfs.size:
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
            yield g_rows[ent], pos, doc
        lo = hi


def _cells(row, col, width: int):
    """Flat int64 offsets row * width + col into a [rows, width] table:
    the dense rows of a large corpus hold more than 2^31 elements."""
    return row.to(torch.int64) * width + col.to(torch.int64)


def _entries(starts, dfs, rows):
    starts = np.asarray(starts, np.int64)
    dfs = np.asarray(dfs, np.int64)
    rows = (np.arange(dfs.size, dtype=np.int64) if rows is None
            else np.asarray(rows, np.int64))
    return starts, dfs, rows


def _build_buckets(post_doc, starts, dfs, rows, *, n_rows_pad: int,
                   n_slots: int, bucket_log2: int):
    """(bucket table int32 [n_rows_pad, NB + 1], its largest bucket's
    posting count), NB = ceil(n_slots / 2^bucket_log2): the port of the
    JAX _build_buckets. Cell indices are int64 (the 1M light table has
    ~391M cells)."""
    nb = (n_slots + (1 << bucket_log2) - 1) >> bucket_log2
    table = torch.zeros((n_rows_pad, nb + 1), dtype=torch.int32,
                        device=post_doc.device)
    counts = table.view(-1)
    for row, _pos, doc in _expand_groups(post_doc, starts, dfs, rows, n_slots):
        # bucket b's count lands in column b + 1; the running sum below
        # turns counts into first-posting offsets
        cell = _cells(row, 1 + (doc >> bucket_log2), nb + 1)
        counts.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    occ = int(table.max()) if table.numel() else 0
    table.cumsum_(dim=1)
    return table, occ


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
    dtype = torch.bfloat16 if bf16 else torch.float32
    dense = torch.zeros((n_rows_pad, n_slots), dtype=dtype,
                        device=post_doc.device)
    starts, dfs, rows = _entries(starts, dfs, rows)
    flat = dense.view(-1)
    for row, pos, doc in _expand_groups(post_doc, starts, dfs, rows, n_slots):
        flat[_cells(row, doc, n_slots)] = post_score[pos].to(dtype)
    if not with_buckets:
        return dense, None, 0
    buckets, occ = _build_buckets(
        post_doc, starts, dfs, rows, n_rows_pad=n_rows_pad, n_slots=n_slots,
        bucket_log2=BUCKET_LOG2,
    )
    return dense, buckets, occ


def build_light_on_device(post_doc: torch.Tensor, starts, dfs, *,
                          n_rows_pad: int, n_slots: int,
                          bucket_log2: int = LIGHT_BUCKET_LOG2):
    """(light bucket table int32 [n_rows_pad, NB + 1], its largest bucket's
    posting count) on post_doc's device, entry i -> row i: the port of the
    JAX build_light_on_device. bucket_log2 is the index's granularity,
    coarsened when the table would exceed its byte budget."""
    starts, dfs, rows = _entries(starts, dfs, None)
    return _build_buckets(post_doc, starts, dfs, rows, n_rows_pad=n_rows_pad,
                          n_slots=n_slots, bucket_log2=bucket_log2)


def _desc_key(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys whose ascending order is (x desc, ids asc), unique per
    id: the f32 order key inverted, over a 24-bit id (< 2^24 doc slots)."""
    return (((1 << 32) - 1 - f32_order_key(x)) << 24) | ids


def _row_topk_group(rows: torch.Tensor, k: int):
    """Exact canonical top-k per row of a [g, nblk * 128] f32 block, in the
    JAX _row_topk_group's two phases: order the 128-lane blocks by (block
    max desc, block id asc) and keep the first min(k, nblk) (a lane of an
    unpicked block loses to one distinct lane of every picked block), then
    order the candidate lanes by (score desc, slot asc). Both orders use
    unique int64 keys, so equal scores (the zero lanes past a row's df)
    fall in slot order, as the reference's two-key sort leaves them."""
    g = rows.shape[0]
    rows3 = rows.view(g, -1, 128)
    nblk = rows3.shape[1]
    kb = min(k, nblk)
    ar_b = torch.arange(nblk, dtype=torch.int64, device=rows.device)
    bkey = torch.sort(_desc_key(rows3.amax(dim=2), ar_b[None, :]), dim=1).values
    blocks = bkey[:, :kb] & ((1 << 24) - 1)
    cand = torch.gather(rows3, 1, blocks[:, :, None].expand(-1, -1, 128))
    lane = torch.arange(128, dtype=torch.int64, device=rows.device)
    slots = (blocks[:, :, None] * 128 + lane).reshape(g, kb * 128)
    flat = cand.reshape(g, kb * 128)
    skey, order = torch.sort(_desc_key(flat, slots), dim=1)
    kk = min(k, kb * 128)
    return torch.gather(flat, 1, order[:, :kk]), skey[:, :kk] & ((1 << 24) - 1)


def build_row_topk_on_device(dense_rows: torch.Tensor, n_rows: int, *,
                             k: int, n_slots: int, group: int = 64):
    """Host (vals f32 [n_rows, k], slots int32 [n_rows, k]) for the first
    n_rows of the f32 dense table [rows, n_slots] (n_slots a multiple of
    128, viewed as 128-lane blocks without a copy), each row's exact
    canonical top-k by (score desc, slot asc), as the JAX
    build_row_topk_on_device: a row with fewer than k nonzeros ends in
    zero-valued lanes with their real slot ids (the host path pads slot
    2^30 instead).

    Groups of `group` rows are sliced at their own offsets. The JAX
    function slices with lax.dynamic_slice_in_dim, which clamps a last
    partial group that would run past the table back inside it and so
    reads the wrong rows there; this one reads the right rows."""
    if n_rows <= 0 or k <= 0:
        return (np.zeros((0, max(k, 1)), np.float32),
                np.zeros((0, max(k, 1)), np.int32))
    assert dense_rows.shape[1] == n_slots and n_slots % 128 == 0
    vals, slots = [], []
    for lo in range(0, n_rows, group):
        v, s = _row_topk_group(dense_rows[lo:min(lo + group, n_rows)], k)
        vals.append(v)
        slots.append(s)
    return (torch.cat(vals).cpu().numpy().astype(np.float32),
            torch.cat(slots).to(torch.int32).cpu().numpy())
