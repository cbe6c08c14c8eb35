"""The fused mode's score epilogue as one hand-written CUDA pass.

In the reference, everything after the fused mode's dot sits inside one
jitted function, and XLA fuses its elementwise passes and reductions over
the [Q, n_slots] score array: ``scores + heavy_scores(...)``, ``found =
sum(scores > 0)`` and tiled_topk's tile max
(nextsearch_tpu/ops/bm25.py:300-301, :358-359, :232; no Pallas kernel).
score_epilogue does the same in one pass (``ns_score_epilogue`` in
``nextsearch_tpu_torch/csrc/heavy.cu``, built by ops/cuda_build.py): the
heavy product added into the scores in place, the count of positive
scores per row, and the max of each tile of a row. Exact and fast mode
take only the count from it.

The wrapper runs the plain PyTorch version for CPU tensors (the CPU tests)
and launches the kernel for CUDA tensors, raising if the launch fails; it
counts launches in ``score_epilogue.launches``.
"""

from __future__ import annotations

import torch

from .cuda_build import check_rc, counted, library, stream

TILE = 2048  # tiled_topk's tile width
_CHUNK = 2048  # docs a warp takes where no tile maxima are asked for


def _tiled(n: int, tile: int, tiles: bool) -> bool:
    return tiles and n % tile == 0


def score_epilogue_ref(scores: torch.Tensor, heavy=None, *, tile: int = TILE,
                       tiles: bool = True):
    """Plain PyTorch version of score_epilogue: the add, then the count and
    the tile maxima as three separate ops."""
    q, n = scores.shape
    if heavy is not None:
        scores.add_(heavy.to(scores.dtype))
    found = (scores > 0).sum(dim=1, dtype=torch.int32)
    tile_max = (scores.view(q, n // tile, tile).amax(dim=2)
                if _tiled(n, tile, tiles) else None)
    return found, tile_max


def score_epilogue(scores: torch.Tensor, heavy=None, *, tile: int = TILE,
                   tiles: bool = True):
    """scores += heavy in place; each row's count of positive scores and
    each tile's max.

    scores f32 or bf16 [Q, N], contiguous, finite and >= 0 (pass-1 BM25
    scores); heavy None or f32 [Q, N], contiguous (torch.matmul's heavy
    product), added as heavy.to(scores.dtype), so with bf16 scores it is
    rounded to bf16 before the bf16 add, as the reference's
    heavy_scores(..., dtype=bf16) then ``+``. Returns (found int32 [Q], the
    count of scores > 0 after the add; tile_max [Q, N // tile] in the
    scores' type, the max of each `tile` scores of a row, or None unless
    `tiles` is set and tile divides N)."""
    if scores.dim() != 2 or scores.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("score_epilogue: scores must be 2D float32 or bfloat16")
    if not scores.is_contiguous():
        raise ValueError("score_epilogue: scores must be contiguous")
    if heavy is not None:
        if heavy.dtype != torch.float32 or heavy.shape != scores.shape:
            raise TypeError("score_epilogue: heavy must be float32 of the "
                            "scores' shape")
        if not heavy.is_contiguous():
            raise ValueError("score_epilogue: heavy must be contiguous")
        if heavy.device != scores.device:
            raise ValueError("score_epilogue: scores and heavy on different "
                             "devices")
    if tile < 1:
        raise ValueError(f"score_epilogue: tile={tile} < 1")
    if scores.device.type == "cpu":
        return score_epilogue_ref(scores, heavy, tile=tile, tiles=tiles)
    if scores.device.type != "cuda":
        raise ValueError(f"score_epilogue: unsupported device {scores.device}")
    q, n = scores.shape
    dev = scores.device
    tiled = _tiled(n, tile, tiles)
    # integer atomics add into it: a memset node inside a CUDA graph
    found = torch.zeros((q,), dtype=torch.int32, device=dev)
    tile_max = (torch.empty((q, n // tile), dtype=scores.dtype, device=dev)
                if tiled else None)
    if q == 0 or n == 0:
        return found, tile_max
    lib = library()
    vec_ok = scores.data_ptr() % 16 == 0 and (
        heavy is None or heavy.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        rc = lib.ns_score_epilogue(
            scores.data_ptr(), None if heavy is None else heavy.data_ptr(),
            int(scores.dtype == torch.bfloat16), q, n, tile if tiled else _CHUNK,
            None if tile_max is None else tile_max.data_ptr(),
            found.data_ptr(), int(vec_ok), stream(dev),
        )
    check_rc(rc, "score_epilogue")
    score_epilogue.launches += 1
    return found, tile_max


counted(score_epilogue)
