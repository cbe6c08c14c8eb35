"""Sparse-kernel stage profiling at the serving operating point.

Port of nextsearch_tpu's benchmarks/profile_serving.py: the production
packed launch (ops/bm25_sparse.packed_impl) timed whole with one stage
dropped at a time through its prof_skip argument (stage cost = full -
variant; the dropped stages' results are wrong by design). The
configuration is the bench's: posting block 64, heavy bucket 512, dense df
ratio 1/1024, 7 GiB of dense rows, K2 margin 32, the compact launch, and
the guarded fast mode (K2 + K1 one-pass, merged pool); "wide" is the exact
relaunch kernel's mode.

    python -m nextsearch_tpu_torch.benchmarks.profile_serving

Env: NEXTSEARCH_PROF_DOCS (1000000), NEXTSEARCH_PROF_VOCAB (200000),
NEXTSEARCH_PROF_BATCH (512), NEXTSEARCH_PROF_BLOCK (64),
NEXTSEARCH_PROF_HEAVYB (512), NEXTSEARCH_PROF_K2 (32),
NEXTSEARCH_PROF_VARIANTS (comma list), NEXTSEARCH_PROF_GROUPS (1; > 1
times packed_multi over G stacked plans). Plans are uploaded before
timing; times are device milliseconds between CUDA events, median over 12
batches.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops.bm25_sparse import packed_impl, packed_multi

VARIANTS = {
    "full": (),
    "wide": (),
    "no_rescore": ("rescore",),
    "no_sort2": ("sort2",),
    "no_lsort": ("lsort",),
    "no_hgather": ("hgather",),
    "no_light": ("light", "hgather", "sort2"),
    "no_cand_heavy": ("cand_heavy",),
    "no_rowgather": ("rowgather",),
    "no_heavy_mm": ("heavy_mm", "rowgather"),
    "no_s2hg": ("sort2", "hgather"),
    "no_segsum": ("segsum",),
    "no_lcount": ("lcount",),
    "no_seg_lc": ("segsum", "lcount"),
    # light chain + base alone (heavy stages all off)
    "light_only": ("rowgather", "heavy_mm", "cand_heavy", "rescore"),
    # heavy stages + base alone
    "heavy_only": ("light", "hgather", "sort2", "rescore"),
    "base": ("heavy_mm", "rowgather", "light", "hgather", "sort2",
             "cand_heavy", "rescore"),
}


def serving_statics(ti, plans, groups: int = 1) -> dict:
    """packed_impl's static arguments for the plans (1-term shortcuts
    already taken out), as the original sizes them."""
    dcfg = ti.config.device
    block = dcfg.posting_block
    K = 10
    return dict(
        n_slots=ti.n_slots, K=K, K2=min(max(2 * K, dcfg.rescore_margin), ti.n_slots),
        C=max(ti._chunk_budget(p[1], block) for p, _u in plans),
        L2=max(ti._light_budget(p) for p, _u in plans),
        H2=max(ti._heavy_budget(p) for p, _u in plans),
        U=plans[0][1], block=block, bs_steps=ti._bs_depth, nd=ti.n_dense,
        nl=ti.n_light, lb_log2=ti._lb_log2, heavy_direct=ti._heavy_direct,
        guard_eps=dcfg.fast_heavy_eps, bucket_pos=ti.bucket_pos,
    )


def launch(ti, plan_dev, w_max: int, statics: dict, name: str):
    """One timed call: variant `name` on plan_dev ([7, Q, T], or [G, 7, Q,
    T] for packed_multi)."""
    run = packed_multi if plan_dev.dim() == 4 else packed_impl
    return run(ti.post_doc, ti.post_score, ti.dense_rows, ti.light_bucket_pos,
               plan_dev, use_compact=True, fast_heavy=name != "wide",
               w_max=w_max, prof_skip=VARIANTS[name], **statics)


def main() -> int:
    from nextsearch_tpu.config import DeviceConfig, EngineConfig

    from ..index.segment import TorchIndex
    from ..tools.synthetic import sample_queries
    from .common import bench_corpus, card_line, event_ms, require_cuda

    device = require_cuda()
    print(card_line(), flush=True)
    env = os.environ.get
    n_docs = int(env("NEXTSEARCH_PROF_DOCS", 1_000_000))
    vocab = int(env("NEXTSEARCH_PROF_VOCAB", 200_000))
    batch = int(env("NEXTSEARCH_PROF_BATCH", 512))
    names = env("NEXTSEARCH_PROF_VARIANTS")
    names = names.split(",") if names else list(VARIANTS)
    groups = int(env("NEXTSEARCH_PROF_GROUPS", 1))
    seg, probs = bench_corpus(n_docs, vocab)
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=int(env("NEXTSEARCH_PROF_BLOCK", 64)),
        heavy_buckets=(int(env("NEXTSEARCH_PROF_HEAVYB", 512)),),
        dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30,
        rescore_margin=int(env("NEXTSEARCH_PROF_K2", 32)),
    ))
    ti = TorchIndex([seg], config=cfg, device=device)
    batches = sample_queries(probs, n_queries=20 * batch, batch=batch)
    pins = ti.pin_shapes(batches)
    # serving answers 1-term head queries on the host before planning
    plans = [ti.plan_sparse(ti._shortcut_single_heavy(b, 10)[0])
             for b in batches]
    st = serving_statics(ti, plans)
    print(f"[prof] {n_docs} docs n_dense={ti.n_dense} n_slots={ti.n_slots} "
          f"pins={pins} bs_steps={ti._bs_depth} C={st['C']} L2={st['L2']} "
          f"H2={st['H2']} U={st['U']} T={plans[0][0].shape[2]} G={groups}",
          file=sys.stderr, flush=True)
    if groups > 1:
        plans = [(np.stack([plans[i + g][0] for g in range(groups)]), st["U"])
                 for i in range(0, len(plans) - groups + 1, groups)]
    dev_plans = [(torch.from_numpy(p).to(device),
                  ti._sel_window(p[:, 1] if groups > 1 else p[1]))
                 for p, _u in plans]
    results = {}
    for name in names:
        it = iter(range(2, 10 ** 9))
        launch(ti, *dev_plans[0], st, name)  # warm

        def call(name=name, it=it):
            return launch(ti, *dev_plans[next(it) % len(dev_plans)], st, name)

        results[name] = event_ms(call, 12, warm=0)
        print(f"[prof] {name}: {results[name]:.3f} ms/batch "
              f"({batch * groups / results[name] * 1000:.0f} qps)",
              file=sys.stderr, flush=True)
    print("\n=== serving-point stage attribution (ms/batch) ===")
    full = results.get("full")
    for name, ms in results.items():
        delta = (f"  (full - this = {full - ms:+.3f})"
                 if full and name != "full" else "")
        print(f"{name:14s} {ms:10.3f}{delta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
