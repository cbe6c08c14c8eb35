"""Engine over a TorchIndex: the reference Engine with reload building the
port's index on an explicit device.

Everything else (cache probes, tokenization, batching, JSON rendering,
warmup's shape pinning) is nextsearch_tpu.engine.Engine unchanged.
Autocomplete and semantic expansion build device state in jax and are not
ported yet (ROADMAP queue 1 items 9-10): reload leaves both empty, so
/api/suggest answers with no suggestions and queries are not expanded.
"""

from __future__ import annotations

import gc
import os
from dataclasses import replace
from struct import error as struct_error

import torch

from nextsearch_tpu.config import DEFAULT_CONFIG as _REF_DEFAULT
from nextsearch_tpu.config import EngineConfig
from nextsearch_tpu.engine import Engine as _RefEngine
from nextsearch_tpu.index.artifacts import load_segment_cached
from nextsearch_tpu.index.metadata import MetadataStore
from nextsearch_tpu.index.segmentio import discover_segments
from nextsearch_tpu.utils.logging import log

from .index.segment import TorchIndex

# The reference's defaults in the one device mode the port carries.
DEFAULT_CONFIG = replace(
    _REF_DEFAULT, device=replace(_REF_DEFAULT.device, mode="sparse")
)


class Engine(_RefEngine):
    def __init__(self, index_dir=".", config: EngineConfig = DEFAULT_CONFIG,
                 cache_dir=".", *, device, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded serving over a mesh is not ported: ROADMAP queue 1 "
                "item 11"
            )
        if os.environ.get("NEXTSEARCH_PROFILE_DIR"):
            raise NotImplementedError(
                "NEXTSEARCH_PROFILE_DIR (jax device trace) has no torch "
                "counterpart yet: ROADMAP queue 1 item 4"
            )
        super().__init__(index_dir, config=config, mesh=None,
                         cache_dir=cache_dir)
        self.device = torch.device(device)

    def reload(self, warm: bool = False) -> bool:
        """Reload the index from disk; the old index serves until the
        swap (see the reference's Engine.reload)."""
        with self._reload_mtx:
            if os.environ.get("NEXTSEARCH_RELOAD_IN_PLACE") == "1":
                with self.mtx:
                    self.index = None
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
            seg_names = discover_segments(self.index_dir)
            if not seg_names:
                return False
            loaded = []
            for name in seg_names:
                segdir = self.index_dir / "segments" / name
                try:
                    loaded.append(load_segment_cached(
                        segdir, k1=self.config.bm25.k1, b=self.config.bm25.b,
                    ))
                except (OSError, ValueError, struct_error) as e:
                    log("reload", f"Failed to load segment: {segdir} ({e})",
                        level="error")
                    return False
            new_index = TorchIndex(
                loaded, seg_names, self.config, device=self.device
            )
            log("reload", "autocomplete and semantic expansion are not "
                "ported yet (ROADMAP queue 1 items 9-10); suggestions are "
                "empty and queries are not expanded")
            new_metadata = MetadataStore(self.index_dir / "metadata.csv")
            log("metadata", f"map_size={len(new_metadata)}")
            new_renderer = self._build_renderer(
                new_index, new_metadata, loaded, seg_names
            )
            if warm:
                self.warmup(index=new_index)
            with self.mtx:
                self.index = new_index
                self.seg_names = seg_names
                self.metadata = new_metadata
                self._renderer = new_renderer
            self.cache.load()
            self.ai_overview_cache.load()
            self.ai_summary_cache.load()
            return True
