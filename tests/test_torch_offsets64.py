"""64-bit offsets into the dense, compact and tf tables.

At MS MARCO passage's size (8,841,823 passages, 8,843,264 doc slots) the
dense rows that an 80 GB card holds (728 rows in 24 GiB) are 6.4e9 f32
elements, past 2^31. No table that large is allocated here: the CPU tests
check the index arithmetic that the device build runs, with a row index
times n_slots past 2^31, and that every CUDA entry point and kernel takes
its doc-slot and element counts as 64-bit integers, with matching ctypes
signatures. The CUDA kernels' own offsets (K1, K2, K3, the exact full-table
relaunch) are checked on the card, by the benchmark's comparison with the
plain reference at that size. The same reading of the source holds every
entry point's ctypes signature to its C parameter types, and every kernel
to a launch site: no kernel is left in the library that nothing launches.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import pytest
import torch

from nextsearch_tpu_torch.index.device_build import (
    _build_buckets, _cells, _entries, _expand_groups,
)
from nextsearch_tpu_torch.ops import cuda_build

N_SLOTS = 8_843_264  # 8,841,823 passages rounded up to 2048
ROWS = 728  # 24 GiB of f32 rows
SRC = (Path(cuda_build.__file__).resolve().parents[1] / "csrc"
       / "heavy.cu").read_text()
# parameters that count doc slots or flat elements of a table
WIDE = {"n_slots", "N", "n", "nv", "n4", "chunk", "n_chunks"}


def test_the_dense_table_is_past_int32():
    assert ROWS * N_SLOTS > 2 ** 32
    assert (24 << 30) // (4 * N_SLOTS) == ROWS


def test_dense_cells_past_int32():
    """The device build's flat offsets of (row, doc) into the dense rows
    are exact int64 past 2^31, from int32 postings."""
    post_doc = torch.tensor([5, N_SLOTS - 1, 17, 3, 0], dtype=torch.int32)
    starts, dfs, rows = _entries([0, 2], [2, 3], [ROWS - 1, 300])
    (row, pos, doc), = _expand_groups(post_doc, starts, dfs, rows, N_SLOTS)
    cells = _cells(row, doc, N_SLOTS)
    assert cells.dtype == torch.int64
    want = [(ROWS - 1) * N_SLOTS + 5, (ROWS - 1) * N_SLOTS + N_SLOTS - 1,
            300 * N_SLOTS + 17, 300 * N_SLOTS + 3, 300 * N_SLOTS]
    assert cells.tolist() == want
    assert max(want) > 2 ** 32
    # int32 operands widen before the multiply
    r32 = torch.tensor([ROWS - 1], dtype=torch.int32)
    c32 = torch.tensor([N_SLOTS - 1], dtype=torch.int32)
    assert _cells(r32, c32, N_SLOTS).item() == ROWS * N_SLOTS - 1


def test_bucket_cells_fill_the_right_rows():
    """The bucket table's counts land in (row, bucket) cells through the
    same offsets (a small table, so the values can be read)."""
    post_doc = torch.tensor([1, 9, 40, 2, 63], dtype=torch.int32)
    starts, dfs, rows = _entries([0, 3], [3, 2], [2, 0])
    table, occ = _build_buckets(post_doc, starts, dfs, rows, n_rows_pad=3,
                                n_slots=64, bucket_log2=3)
    assert table.tolist() == [
        [0, 1, 1, 1, 1, 1, 1, 1, 2],
        [0] * 9,
        [0, 1, 2, 2, 2, 2, 3, 3, 3],
    ]
    assert occ == 1


def _params(text):
    """(type, name) of each parameter of a C parameter list."""
    out = []
    for p in text.replace("\n", " ").split(","):
        p = " ".join(p.split())
        m = re.match(r"(.*?)\s*(\w+)$", p)
        if m:  # a pointer keeps its * in the type
            typ = m.group(1).replace("__restrict__", "")
            out.append((" ".join(typ.split()), m.group(2)))
    return out


ENTRIES = {m.group(1): _params(m.group(2)) for m in re.finditer(
    r'extern "C" int (ns_\w+)\(([^)]*)\)', SRC)}
KERNELS = {m.group(1): _params(m.group(2)) for m in re.finditer(
    r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(([^)]*)\)",
    SRC)}


def test_sources_were_read():
    assert {"ns_heavy_fused3", "ns_gather_rows", "ns_mix_lists",
            "ns_score_epilogue"} <= set(ENTRIES)
    assert {"heavy_gather_kernel", "heavy_dense_tc_kernel",
            "heavy_dense_exact_kernel", "gather_rows_kernel",
            "gather_rows_unrolled_kernel", "mix_lists_kernel"} <= set(KERNELS)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_take_wide_counts_as_64_bit(kernel):
    for typ, name in KERNELS[kernel]:
        if name in WIDE:
            assert typ == "long long", (kernel, typ, name)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_points_take_wide_counts_as_64_bit(entry):
    """Each C entry point's doc-slot and element counts are long long, and
    its ctypes signature passes them as c_longlong."""
    params = ENTRIES[entry]
    sig = cuda_build._SIGNATURES[entry]
    assert len(sig) == len(params)
    for (typ, name), ctype in zip(params, sig):
        if name in WIDE:
            assert typ == "long long", (entry, typ, name)
            assert ctype is ctypes.c_longlong, (entry, name)
        elif typ == "long long":
            assert ctype is ctypes.c_longlong, (entry, name)


def _ctype(typ):
    """The ctypes type that passes a C parameter of type `typ`."""
    if typ.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[typ]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_signatures_match_the_c_types(entry):
    """Each C entry point's ctypes signature passes each parameter as its
    C type: pointers as c_void_p, int as c_int, long long as c_longlong."""
    want = [_ctype(typ) for typ, _name in ENTRIES[entry]]
    assert cuda_build._SIGNATURES[entry] == want


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_every_kernel_has_a_launch_site(kernel):
    """Each kernel is launched in the library: by name, with or without
    template arguments, before <<<, or taken as the function an entry point
    launches (auto kernel = name<...>)."""
    launched = re.search(rf"\b{kernel}\s*(<[^;{{}}()]*>)?\s*<<<", SRC)
    taken = re.search(rf"auto kernel = {kernel}\s*(<[^;]*>)?\s*;", SRC)
    assert launched or taken, kernel
