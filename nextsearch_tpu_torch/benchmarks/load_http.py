"""Served-QPS benchmark: drive the port's real HTTP server with concurrent
load (port of nextsearch_tpu's benchmarks/load_http.py).

Serves the bench corpus (1M docs, 200k-term Zipf vocabulary) through
``python -m nextsearch_tpu_torch.api.server`` (a subprocess on the card,
real sockets, real JSON) and measures the delivered QPS and the p50
request latency at the client.

Load shapes:
  --mode batch  (default): N client threads POST /api/search_batch with B
                queries per request (keep-alive).
  --mode single: C asyncio connections each issue GET /api/search (the
                reference C++ server's request shape): the per-request
                ceiling of the Python HTTP front.
  --mode both:   batch, then single.
  --mode engine: no sockets: Engine + SearchBatcher at pipeline depth 2 in
                this process, on --device (cuda by default).

Before the timed run, 16 queries of the stream go through
/api/search_batch once: each answer must be sorted, at least 12 must be
non-empty, and each must equal index/oracle.py's top 10 (scores as f32,
docId, found) over the query's terms.

    python -m nextsearch_tpu_torch.benchmarks.load_http [--mode batch]
        [--docs 1000000] [--secs 20] [--clients 3] [--batch 512]
        [--port 18080] [--reuse-server] [--index-dir DIR]

--reuse-server attaches to a server already listening on --port instead of
spawning one. --index-dir names the index that server serves (the spot
check's oracle reads its segments, and the query stream draws its terms
by df rank from them); without it the script serves, and checks against,
the bench corpus, built once into the corpus cache
(NEXTSEARCH_BENCH_CACHE or the temp dir). The spawned server runs in a
directory under the temp dir and logs there. Prints one JSON line per
mode.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

K = 10


def make_query_texts(vocab: int, n_queries: int, seed: int = 3, names=None):
    """Zipf query stream as raw strings (bench.py's distribution): 1-4
    distinct terms of df rank r drawn with weight 1 / (r + 1)^1.07. Rank r
    is the term t{r:06d} of the bench corpus, or names[r]."""
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
    probs /= probs.sum()
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    r = np.random.default_rng(seed)
    n_terms = r.integers(1, 5, size=n_queries)
    total = int(n_terms.sum())
    tids = np.searchsorted(cum, r.random(total), side="right")
    ends = np.cumsum(n_terms)
    out = []
    for qi in range(n_queries):
        s, e = ends[qi] - n_terms[qi], ends[qi]
        q = np.unique(tids[s:e])
        out.append(" ".join(
            f"t{t:06d}" if names is None else names[t] for t in q))
    return out


def prepare_index_dir(docs: int, vocab: int) -> Path:
    """Serve the bench corpus: an artifact-only segment directory under the
    temp dir, linked to the corpus cache's artifact."""
    from ..index.artifacts import ARTIFACT_NAME
    from ..index.segmentio import save_manifest
    from .common import bench_corpus

    bench_corpus(docs, vocab)  # builds the cached artifact once
    art = Path(os.environ.get(
        "NEXTSEARCH_BENCH_CACHE",
        Path(tempfile.gettempdir()) / "nextsearch_bench_cache",
    )) / f"{docs}_{vocab}_0" / ARTIFACT_NAME
    served = Path(tempfile.gettempdir()) / f"nextsearch_torch_served_{docs}_{vocab}"
    segdir = served / "segments" / "seg_000001"
    segdir.mkdir(parents=True, exist_ok=True)
    link = segdir / ARTIFACT_NAME
    if not link.exists():
        link.symlink_to(art)
    save_manifest(served / "manifest.bin", ["seg_000001"])
    return served


def load_segments(index_dir: Path):
    from ..index.artifacts import load_segment_cached
    from ..index.segmentio import discover_segments

    return [load_segment_cached(index_dir / "segments" / name)
            for name in discover_segments(index_dir)]


def ranked_terms(segs):
    """The index's terms by summed df, highest first (ties by term)."""
    df: dict = {}
    for seg in segs:
        for t, d in zip(seg.terms, seg.term_df.tolist()):
            df[t] = df.get(t, 0) + int(d)
    return sorted((t for t in df if df[t] > 0), key=lambda t: (-df[t], t))


def wait_healthy(port: int, timeout_s: float) -> None:
    deadline = time.time() + timeout_s
    last = None
    while time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            c.request("GET", "/api/health")
            r = c.getresponse()
            body = r.read()
            c.close()
            if r.status == 200 and json.loads(body).get("ok"):
                return
        except OSError as e:
            last = e
        time.sleep(2.0)
    raise RuntimeError(f"server never became healthy: {last}")


def spot_check(port: int, queries, segs=None):
    """Response shape on a small batch before the timed run, and, given the
    served segments, each answer against the oracle."""
    from ..index.oracle import oracle_search_vec

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    payload = json.dumps({"queries": [{"q": q, "k": K} for q in queries[:16]]})
    c.request("POST", "/api/search_batch", body=payload,
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    j = json.loads(r.read())
    c.close()
    assert r.status == 200, r.status
    assert len(j["results"]) == 16
    n_nonempty = 0
    osegs = [s.to_oracle_segment() for s in segs] if segs else None
    for q, res in zip(queries[:16], j["results"]):
        scores = [hit["score"] for hit in res["results"]]
        assert scores == sorted(scores, reverse=True), res["query"]
        n_nonempty += bool(scores)
        if osegs is not None:
            hits, found = oracle_search_vec(
                osegs, [(t, 1.0) for t in q.split()], k=K)
            got = [(np.float32(x["score"]), x["docId"]) for x in res["results"]]
            exp = [(np.float32(s), doc) for s, _sg, doc in hits]
            assert res["found"] == found and got == exp, (q, "!= oracle")
    assert n_nonempty >= 12, f"only {n_nonempty}/16 queries matched"
    print(f"[load] spot-check OK ({n_nonempty}/16 non-empty, sorted"
          + (", oracle-exact)" if osegs is not None else ")"),
          file=sys.stderr, flush=True)


def run_batch_mode(port, texts, secs, clients, batch, k=K):
    """Threaded keep-alive POST /api/search_batch loop."""
    # payloads encoded before the timed loop: the client shares the host's
    # cores with the server
    payloads = []
    for i in range(0, max(len(texts) - batch, 1), batch):
        payloads.append(json.dumps(
            {"queries": [{"q": q, "k": k} for q in texts[i: i + batch]]}
        ).encode())
    lat, done, errors = [], [0], []
    stop = time.time() + secs
    lock = threading.Lock()

    def worker(wi):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        pi = wi
        while time.time() < stop:
            t0 = time.time()
            try:
                conn.request("POST", "/api/search_batch",
                             body=payloads[pi % len(payloads)],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                body = r.read()
            except OSError as e:
                errors.append(e)
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                continue
            dt = time.time() - t0
            if r.status != 200:
                errors.append(body[:200])
                continue
            with lock:
                lat.append(dt)
                done[0] += batch
            pi += clients
        conn.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errors:
        print(f"[load] {len(errors)} errors, first: {errors[0]}", file=sys.stderr)
    return done[0] / wall, float(np.median(lat)) * 1000 if lat else 0.0, len(errors)


def run_single_mode(port, texts, secs, conns, k=K):
    """asyncio GET /api/search load (per-request ceiling)."""
    import asyncio
    from urllib.parse import quote

    paths = [f"/api/search?q={quote(q)}&k={k}" for q in texts]
    lat = []
    done = [0]
    errors = [0]

    async def client(ci):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        pi = ci
        stop = time.time() + secs
        try:
            while time.time() < stop:
                p = paths[pi % len(paths)]
                t0 = time.time()
                writer.write(f"GET {p} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
                await writer.drain()
                status_line = await reader.readline()
                try:
                    status = int(status_line.split(b" ")[1])
                except (IndexError, ValueError):
                    status = 0
                clen = 0
                while True:
                    line = await reader.readline()
                    if not line or line == b"\r\n":
                        break
                    if line.lower().startswith(b"content-length:"):
                        clen = int(line.split(b":")[1])
                if clen:
                    await reader.readexactly(clen)
                if status == 200:
                    lat.append(time.time() - t0)
                    done[0] += 1
                else:  # a non-200 must not count as served
                    errors[0] += 1
                pi += conns
        except (OSError, asyncio.IncompleteReadError):
            errors[0] += 1
        finally:
            writer.close()

    async def main():
        await asyncio.gather(*(client(i) for i in range(conns)))

    t0 = time.time()
    asyncio.run(main())
    wall = time.time() - t0
    return done[0] / wall, float(np.median(lat)) * 1000 if lat else 0.0, errors[0]


def run_engine_mode(index_dir, texts, secs, batch, device):
    """In-process serving-dispatcher capacity: Engine + SearchBatcher at
    pipeline depth 2 on `device`, no sockets; the bench's sparse
    configuration. Bounds what any HTTP front on this host could deliver."""
    from ..api.batching import SearchBatcher
    from ..config import BatchingConfig, CacheConfig, DeviceConfig, EngineConfig
    from ..engine import Engine

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, heavy_buckets=(512,),
            dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30,
        ),
        batching=BatchingConfig(max_batch=batch, pipeline_depth=2),
        # write-behind persistence, as the server runs it
        cache=CacheConfig(flush_ms=1000),
    )
    eng = Engine(index_dir, config=cfg, cache_dir=tempfile.mkdtemp(),
                 device=device)
    t0 = time.time()
    assert eng.reload()
    print(f"[load] engine reload {time.time() - t0:.1f}s", file=sys.stderr)
    eng.warmup()
    b = SearchBatcher(eng, cfg.batching)
    reqs = [[(q, K) for q in texts[i: i + batch]]
            for i in range(0, max(len(texts) - batch, 1), batch)]
    done, lat = [0], []
    stop = time.time() + secs
    lock = threading.Lock()

    def worker(wi):
        pi = wi
        while time.time() < stop:
            t0 = time.time()
            out = b.search_many(reqs[pi % len(reqs)])
            dt = time.time() - t0
            with lock:
                done[0] += len(out)
                lat.append(dt)
            pi += 3

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.time() - t0
    b.shutdown()
    return done[0] / wall, float(np.median(lat)) * 1000 if lat else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="batch",
                    choices=["batch", "single", "both", "engine"])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--secs", type=float, default=20)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--conns", type=int, default=64)
    ap.add_argument("--port", type=int, default=18080)
    ap.add_argument("--reuse-server", action="store_true")
    ap.add_argument("--index-dir", default=None)
    ap.add_argument("--startup-timeout", type=float, default=5400)
    ap.add_argument("--device", default="cuda",
                    help="--mode engine's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    spawn = not args.reuse_server and args.mode != "engine"
    if (spawn or (args.mode == "engine" and args.device != "cpu")) and \
            not torch.cuda.is_available():
        print("no CUDA device: the port's server and engine run on a card "
              "(--reuse-server attaches to a running server)", file=sys.stderr)
        return 2
    if torch.cuda.is_available():
        from .common import card_line

        print(card_line(), flush=True)
    if args.index_dir:
        index_dir = Path(args.index_dir)
        segs = load_segments(index_dir)
        names = ranked_terms(segs)
        texts = make_query_texts(len(names), 40_000, names=names)
    else:
        index_dir = prepare_index_dir(args.docs, args.vocab)
        segs = load_segments(index_dir)
        texts = make_query_texts(args.vocab, 40_000)
    if args.mode == "engine":
        qps, p50 = run_engine_mode(index_dir, texts, args.secs, args.batch,
                                   torch.device(args.device))
        print(json.dumps({
            "metric": "served_qps_engine_dispatcher",
            "value": round(qps, 1), "unit": "queries/sec",
            "p50_req_ms": round(p50, 2), "batch": args.batch,
            "vs_baseline": round(qps / 10000.0, 4),
        }), flush=True)
        return 0
    proc = None
    if spawn:
        env = dict(os.environ)
        env.setdefault("NEXTSEARCH_MODE", "sparse")
        env.setdefault("NEXTSEARCH_MAX_BATCH", "512")
        env.setdefault("NEXTSEARCH_PIPELINE_DEPTH", "2")
        # the bench's sparse operating point, so the served number compares
        env.setdefault("NEXTSEARCH_POSTING_BLOCK", "64")
        env.setdefault("NEXTSEARCH_DENSE_RATIO", str(1 / 1024))
        env.setdefault("NEXTSEARCH_DENSE_BYTES", str(7 << 30))
        env.setdefault("NEXTSEARCH_HEAVY_BUCKETS", "512")
        # the server writes stats and cache JSON to its working directory
        run_dir = Path(tempfile.gettempdir()) / f"nextsearch_torch_run_{args.port}"
        run_dir.mkdir(exist_ok=True)
        logf = open(run_dir / "server.log", "ab")
        repo = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "nextsearch_tpu_torch.api.server",
             str(index_dir), str(args.port)],
            cwd=str(run_dir), env=env, stdout=logf, stderr=logf,
        )
        print(f"[load] server pid {proc.pid} (log {run_dir / 'server.log'}); "
              "waiting for health", file=sys.stderr, flush=True)
    try:
        wait_healthy(args.port, args.startup_timeout)
        spot_check(args.port, texts, segs)
        out = []
        if args.mode in ("batch", "both"):
            qps, p50, errs = run_batch_mode(args.port, texts, args.secs,
                                            args.clients, args.batch)
            out.append({
                "metric": "served_qps_http_batch",
                "value": round(qps, 1), "unit": "queries/sec",
                "p50_req_ms": round(p50, 2), "clients": args.clients,
                "batch": args.batch, "errors": errs,
                "vs_baseline": round(qps / 10000.0, 4),
            })
        if args.mode in ("single", "both"):
            qps, p50, errs = run_single_mode(args.port, texts, args.secs,
                                             args.conns)
            out.append({
                "metric": "served_qps_http_single",
                "value": round(qps, 1), "unit": "queries/sec",
                "p50_req_ms": round(p50, 2), "conns": args.conns,
                "errors": errs,
                "vs_baseline": round(qps / 10000.0, 4),
            })
        for line in out:
            print(json.dumps(line), flush=True)
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
