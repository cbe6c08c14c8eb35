"""Entry points of the sharded backend (the port's counterpart of the
repository root's __graft_entry__.py):

entry(device)              -> (fn, example_args): the batched BM25 top-k
                              step in exact-accumulation mode on a
                              synthetic two-segment index.
dryrun_multichip(n, device) -> builds a (dp, seg) mesh of n device entries
                              and runs the sharded search on it: a toy
                              pass in the fused and sparse modes, then a
                              production-shape sparse pass, every result
                              held to the oracle bit for bit.

device="cuda" places entry i on cuda:(i % device_count()), so one card
holds several shards (the placement is printed); device="cpu" makes n CPU
entries (the tests). Nothing falls back to the CPU when a card is asked
for.

    python -m nextsearch_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import functools
import sys
from typing import List

import numpy as np
import torch


def _tiny_segments(n_segs: int, n_docs: int, vocab: int, seed: int = 0):
    from ..index.builder import build_segment_arrays

    r = np.random.default_rng(seed)
    words = [f"w{i:03d}" for i in range(vocab)]
    segs = []
    for s in range(n_segs):
        docs = []
        for i in range(n_docs):
            toks = r.integers(0, vocab, size=30)
            docs.append({"cord_uid": f"s{s}d{i}", "tokens": [words[t] for t in toks]})
        segs.append(build_segment_arrays(docs))
    return segs


def _device_list(n: int, device: str) -> List[torch.device]:
    """n mesh entries: n CPU entries, or the cards cycled."""
    if device == "cpu":
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (device='cpu' "
                           "runs it on the CPU)")
    n_cards = torch.cuda.device_count()
    return [torch.device(f"cuda:{i % n_cards}") for i in range(n)]


def entry(device: str = "cuda"):
    """The exact-mode forward step on a synthetic index + example args."""
    from ..index.segment import TorchIndex, _upload
    from ..ops.bm25 import bm25_topk_exact

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device (device='cpu' runs it on "
                           "the CPU)")
    segs = _tiny_segments(n_segs=2, n_docs=64, vocab=128)
    ti = TorchIndex(segs, device=dev)
    queries = [
        [("w000", 1.0), ("w001", 0.6)],
        [("w002", 1.0)],
        [("w003", 1.0), ("w004", 0.42), ("w005", 0.37)],
        [("w006", 1.0)],
    ]
    starts, dfs, weights = ti.plan(queries)
    fn = functools.partial(bm25_topk_exact, n_slots=ti.n_slots, K=10, block=512)
    example_args = (ti.post_doc, ti.post_score, _upload(starts, dev),
                    _upload(dfs, dev), _upload(weights, dev))
    return fn, example_args


def _check(si, queries, expected, tag, k):
    """si's results equal the oracle's: f32 scores, (segment, doc), found."""
    results = si.search_batch(queries, k=k)
    for qi, (res, (hits, o_found)) in enumerate(zip(results, expected)):
        assert res.found == o_found, (tag, qi, res.found, o_found)
        assert len(res.scores) == len(hits), (tag, qi)
        for (o_s, o_seg, o_d), d_s, d_slot in zip(hits, res.scores, res.doc_slots):
            assert si.locate(int(d_slot)) == (o_seg, o_d), (tag, qi)
            assert np.float32(d_s) == np.float32(o_s), (tag, qi, float(d_s), float(o_s))
    return results


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Build an (dp, seg) mesh of n_devices entries and run the sharded
    search on it: every mode must reproduce the numpy oracle bit for bit
    (scores, doc identities, found counts); execution alone is not evidence
    that the merge is right. Returns a summary."""
    from ..config import DeviceConfig, EngineConfig
    from ..index.oracle import oracle_search
    from .mesh import make_mesh
    from .sharded import ShardedIndex

    devices = _device_list(n_devices, device)
    print(f"[dryrun_multichip] mesh entries: {[str(d) for d in devices]}",
          flush=True)
    dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(dp=dp, seg=n_devices // dp, devices=devices)

    segs = _tiny_segments(n_segs=max(4, n_devices), n_docs=32, vocab=64, seed=1)
    queries = [
        [("w000", 1.0), ("w001", 0.6)],
        [("w002", 1.0)],
        [("w003", 1.0), ("w004", 0.42)],
        [("w005", 1.0)],
    ]
    oracle_segs = [s.to_oracle_segment() for s in segs]
    expected = [oracle_search(oracle_segs, q, k=5) for q in queries]
    founds = {}
    for mode in ("fused", "sparse"):
        si = ShardedIndex(segs, mesh, config=EngineConfig(
            device=DeviceConfig(mode=mode)))
        results = _check(si, queries, expected, mode, k=5)
        assert all(res.found > 0 for res in results), "dryrun queries must hit docs"
        founds[mode] = [r.found for r in results]
    assert founds["fused"] == founds["sparse"], founds

    # production-shape pass on both mesh factorizations
    meshes = [(dp, n_devices // dp)]
    if dp != 1:
        meshes.append((1, n_devices))
    prod = _production_dryrun(devices, meshes)
    print(
        f"[dryrun_multichip] ok: mesh=({dp},{n_devices // dp}), "
        f"{len(queries)} queries x (fused, sparse), ORACLE-EXACT "
        f"(scores+docs+found), found={founds['sparse']}; production sparse "
        f"(12k Zipf docs, pinned envelopes, shortcuts, guarded fast-heavy): "
        f"ORACLE-EXACT on meshes {', '.join(prod['meshes'])}", flush=True)
    return dict(mesh=(dp, n_devices // dp), devices=[str(d) for d in devices],
                found=founds["sparse"], **prod)


def zipf_segments(n_segs: int = 4, docs_per_seg: int = 3000, vocab: int = 2000,
                  seed: int = 7):
    """A Zipf corpus synthesized straight into posting arrays (the bench
    corpus model, scaled down); returns (segments, term CDF, terms)."""
    from ..index.builder import SegmentArrays, eager_scores

    r = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
    probs /= probs.sum()
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    terms = [f"t{i:04d}" for i in range(vocab)]
    segs = []
    for s in range(n_segs):
        uniq = np.maximum(1, r.poisson(40, docs_per_seg))
        tids = np.searchsorted(cum, r.random(int(uniq.sum())), "right")
        docs_flat = np.repeat(np.arange(docs_per_seg), uniq)
        key = np.unique(docs_flat * vocab + tids)
        post_doc = (key // vocab).astype(np.int32)
        post_term = (key % vocab).astype(np.int32)
        order = np.argsort(post_term, kind="stable")
        post_term, post_doc = post_term[order], post_doc[order]
        post_tf = (1 + (post_doc + post_term) % 3).astype(np.int32)
        term_df = np.bincount(post_term, minlength=vocab).astype(np.int32)
        offs = np.zeros(vocab + 1, np.int64)
        np.cumsum(term_df, out=offs[1:])
        real_len = np.bincount(post_doc, weights=post_tf,
                               minlength=docs_per_seg).astype(np.int64)
        seg = SegmentArrays(
            terms=terms, term_df=term_df, term_offsets=offs, post_doc=post_doc,
            post_tf=post_tf, doc_len=np.maximum(real_len, 1).astype(np.int32),
            N=docs_per_seg,
            avgdl=float(np.float32(real_len.sum()) / np.float32(docs_per_seg)),
            cord_uids=[f"s{s}d{i}" for i in range(docs_per_seg)],
        )
        seg.post_score = eager_scores(seg)
        segs.append(seg)
    return segs, cum, terms


def _production_dryrun(devices, mesh_shapes) -> dict:
    """The sharded sparse production configuration at 12k Zipf docs in 4
    segments, oracle-exact: probed and pinned envelopes
    (pin_shapes(scope_q=True)), merged dense rows from shard-global df, the
    row and light 1-term shortcut tables, and the guarded fast-heavy
    selection with its trip protocol (posting_block 64, as the bench)."""
    from ..config import DeviceConfig, EngineConfig
    from ..index.oracle import oracle_search_vec
    from .mesh import make_mesh
    from .sharded import ShardedIndex

    vocab = 2000
    segs, cum, _terms = zipf_segments(vocab=vocab)

    def q(ids, ws=None):
        ws = ws or [1.0] * len(ids)
        return [(f"t{i:04d}", w) for i, w in zip(ids, ws)]

    rq = np.random.default_rng(11)

    def zipf_query(w):
        ids = set()
        while len(ids) < w:
            ids.add(int(np.searchsorted(cum, rq.random(), "right")))
        return q(sorted(ids))

    # 1-term head-heavy (row shortcut, + a duplicate), 1-term tail (light
    # shortcut), heavy + light multi-term queries (kernel and guard)
    queries = ([q([0]), q([1]), q([0])] + [q([vocab - 5]), q([vocab - 9])]
               + [zipf_query(rq.integers(1, 5)) for _ in range(43)])
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, dense_df_ratio=1 / 64,
        heavy_buckets=(64,)))
    oracle_segs = [s.to_oracle_segment() for s in segs]
    # oracle_search vectorized, with the same bits
    expected = [oracle_search_vec(oracle_segs, qq, k=10) for qq in queries]
    done = []
    for dp_p, seg_p in mesh_shapes:
        mesh = make_mesh(dp=dp_p, seg=seg_p, devices=devices)
        si = ShardedIndex(segs, mesh, config=cfg)
        pins = si.pin_shapes([queries], scope_q=True)
        assert pins, "production dryrun must pin probed envelopes"
        _check(si, queries, expected, f"({dp_p},{seg_p})", k=10)
        done.append(f"({dp_p},{seg_p})")
    return dict(meshes=done, production_queries=len(queries))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    dryrun_multichip(int(argv[0]) if argv else 4, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
