"""The (dp, seg) device grid of the sharded backend (port of
nextsearch_tpu/parallel/mesh.py).

  "dp"  data parallel over the query batch (concurrent API requests)
  "seg" index parallel over segment groups (posting arrays + doc slots)

One Python process holds the grid, plans each batch, launches every (dp
group, shard) local step on its device and merges the shards' candidates
with explicit tensor ops (parallel/sharded.py). A device may appear more
than once: eight CPU entries stand in for an eight-device grid in the
tests, and four entries of one card hold four shards on it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _indexed(device) -> torch.device:
    """The device with its index: a bare "cuda" names the current card, so
    that equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A [dp, seg] grid of torch devices (row g, column s: the device of
    dp group g's local step on shard s)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[_indexed(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1 \
                or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular device grid")
        self.shape = {"dp": len(self.devices), "seg": len(self.devices[0])}

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, seg={self.shape['seg']}, "
                f"devices={[[str(d) for d in r] for r in self.devices]})")


def make_mesh(
    dp: Optional[int] = None,
    seg: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, seg) mesh over `devices` (row-major: devices[g * seg +
    s] serves dp group g on shard s).

    Defaults: all devices on the seg axis (index sharding scales capacity
    first), dp=1. With no `devices`, every CUDA device (cuda:0 ..
    cuda:{n-1}); with no card that raises: a CPU grid is asked for
    explicitly, e.g. devices=[torch.device("cpu")] * 8."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= explicitly")
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devs = [_indexed(d) for d in devices]
    n = len(devs)
    if dp is None and seg is None:
        dp, seg = 1, n
    elif dp is None:
        dp = n // seg
    elif seg is None:
        seg = n // dp
    if dp * seg != n or n == 0:
        raise ValueError(f"mesh {dp}x{seg} != {n} devices")
    return Mesh([devs[g * seg:(g + 1) * seg] for g in range(dp)])
