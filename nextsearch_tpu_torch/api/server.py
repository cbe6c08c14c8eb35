"""HTTP API server over the port's Engine on a CUDA device.

    python -m nextsearch_tpu_torch.api.server <INDEX_DIR> [port]

The reference server's main (nextsearch_tpu/api/server.py) with the jax
platform, mesh and compile-cache lines dropped: sparse is the only device
mode, and a CUDA device is required. Request handling (ServerContext,
make_server, ApiHandler, the batching queue) is the reference's, unchanged.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

from nextsearch_tpu.api.ai import AzureOpenAIConfig
from nextsearch_tpu.api.feedback import FeedbackManager
from nextsearch_tpu.api.server import ServerContext, make_server
from nextsearch_tpu.api.stats import StatsTracker
from nextsearch_tpu.utils.envloader import load_env_file
from nextsearch_tpu.utils.logging import log

from ..engine import DEFAULT_CONFIG, Engine

USAGE = (
    "Usage: python -m nextsearch_tpu_torch.api.server <INDEX_DIR> [port] "
    "[--mode sparse]\n"
    "Example: python -m nextsearch_tpu_torch.api.server ./index 8080"
)


def _env_config(config):
    """The reference server's environment overrides of the device budgets,
    batching queue and persistence."""
    dev = config.device
    dev = replace(
        dev,
        dense_max_bytes=int(
            os.environ.get("NEXTSEARCH_DENSE_BYTES", dev.dense_max_bytes)
        ),
        dense_df_ratio=float(
            os.environ.get("NEXTSEARCH_DENSE_RATIO", dev.dense_df_ratio)
        ),
        heavy_buckets=tuple(
            int(x) for x in os.environ.get(
                "NEXTSEARCH_HEAVY_BUCKETS",
                ",".join(str(b) for b in dev.heavy_buckets),
            ).split(",")
        ),
        posting_block=int(
            os.environ.get("NEXTSEARCH_POSTING_BLOCK", dev.posting_block)
        ),
    )
    if dev != config.device:
        config = replace(config, device=dev)
        log("server", f"device budgets: dense_bytes={dev.dense_max_bytes} "
            f"ratio={dev.dense_df_ratio:.6f} buckets={dev.heavy_buckets}")
    if os.environ.get("NEXTSEARCH_NATIVE_RENDER", "1") == "1":
        from nextsearch_tpu import native as _native

        if _native.available():
            config = replace(config, native_render=True)
            log("server", "native batch-response renderer enabled")
    cache_flush = float(os.environ.get("NEXTSEARCH_CACHE_FLUSH_MS", 1000))
    if cache_flush != config.cache.flush_ms:
        config = replace(config, cache=replace(config.cache, flush_ms=cache_flush))
    bat = config.batching
    bat = replace(
        bat,
        max_batch=int(os.environ.get("NEXTSEARCH_MAX_BATCH", bat.max_batch)),
        window_ms=float(os.environ.get("NEXTSEARCH_WINDOW_MS", bat.window_ms)),
        pipeline_depth=int(
            os.environ.get("NEXTSEARCH_PIPELINE_DEPTH", bat.pipeline_depth)
        ),
        small_batch=int(
            os.environ.get("NEXTSEARCH_SMALL_BATCH", bat.small_batch)
        ),
        small_window_ms=float(
            os.environ.get("NEXTSEARCH_SMALL_WINDOW_MS", bat.small_window_ms)
        ),
    )
    if bat != config.batching:
        config = replace(config, batching=bat)
        log("server", f"batching: max_batch={bat.max_batch} "
            f"window_ms={bat.window_ms} depth={bat.pipeline_depth}")
    return config


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    mode = os.environ.get("NEXTSEARCH_MODE", "sparse")
    if "--mode" in argv:
        i = argv.index("--mode")
        if i + 1 >= len(argv):
            print("--mode expects 'sparse'", file=sys.stderr)
            return 1
        mode = argv[i + 1]
        del argv[i: i + 2]
    if mode != "sparse":
        print(f"mode '{mode}' is not ported: the port serves 'sparse' only",
              file=sys.stderr)
        return 1
    if "--mesh" in argv:
        print("--mesh is not ported (single device only)", file=sys.stderr)
        return 1
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        raise RuntimeError("the torch server requires a CUDA device")
    index_dir = Path(argv[0])
    port = int(argv[1]) if len(argv) > 1 else 8080

    config = _env_config(DEFAULT_CONFIG)
    engine = Engine(index_dir, config=config, device="cuda")
    t0 = time.perf_counter()
    if not engine.reload():
        log("server", f"Failed to load index segments from: {index_dir}",
            level="error")
        return 1
    log("server", f"reload (load + device build/upload) took "
        f"{time.perf_counter() - t0:.1f}s")

    env_vars = load_env_file(".env")
    azure = AzureOpenAIConfig(
        endpoint=env_vars.get("AZURE_OPENAI_ENDPOINT", ""),
        api_key=env_vars.get("AZURE_OPENAI_API_KEY", ""),
        model=env_vars.get("AZURE_OPENAI_MODEL", ""),
    )
    stats = StatsTracker(
        flush_ms=float(os.environ.get("NEXTSEARCH_STATS_FLUSH_MS", 200))
    )
    if not Path("stats.json").exists() and env_vars.get("AI_API_CALLS_LIMIT"):
        limit = int(env_vars["AI_API_CALLS_LIMIT"])
        stats.set_ai_api_calls_limit(limit)
        log("stats", f"AI API calls limit set to: {limit} (from .env)")
    if azure.enabled:
        log("azure", f"Azure OpenAI enabled with model: {azure.model}")
    else:
        log("azure", "Azure OpenAI not configured "
            "(AI overview endpoint will return error)")
    feedback = FeedbackManager("feedback.json")
    if os.environ.get("NEXTSEARCH_WARMUP", "1") == "1":
        sizes_env = os.environ.get("NEXTSEARCH_WARMUP_SIZES")
        t0 = time.perf_counter()
        engine.warmup(
            sizes=[int(s) for s in sizes_env.split(",")] if sizes_env else None
        )
        log("server", f"warmup took {time.perf_counter() - t0:.1f}s")
    ctx = ServerContext(
        engine, stats, feedback, azure, config=config,
        enable_add_document=os.environ.get("NEXTSEARCH_ENABLE_ADD_DOCUMENT") == "1",
    )
    server = make_server(ctx, port=port)
    print(f"API running on http://127.0.0.1:{port}")
    print("Try: /api/search?q=mycoplasma+pneumonia&k=10")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.save_caches()
        stats.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
