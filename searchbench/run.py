"""Run one cell of the benchmark once, on one card.

    python -m searchbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 0|1]

The cell is found by name in BENCHMARK.json, its configuration in the file
that BENCHMARK.json names, its traffic mix in searchbench/traffic/<mix>.json
and each metric's reader in searchbench/metrics/<metric>.py. A run draws the
corpus on the card from the seed, serves it with the program's Engine in
the server's configuration (api/server.serving_config, the configuration's
overrides through the server's own NEXTSEARCH_* variables), warms it as the
server does (Engine.warmup), drives a SearchBatcher over it with the
cell's traffic for a warm stretch and then the measured window, and holds
a sample of the window's answers against the plain reference. The last
line of standard output is one JSON object; with --trace 0 its metrics are
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
from the harness's host spans and a torch.profiler trace of a steady
stretch of the window. --control 1 also judges the reference in TF32 and in
bfloat16 put in the program's place, on the same sample (printed, never
part of the result).
"""

import time

T0 = time.perf_counter()  # set-up runs from here, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from dataclasses import asdict  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import devtrace, judge, readers, roofline  # noqa: E402
from .corpus import generate, heavy_profile, term_name  # noqa: E402
from .metadata import Metadata  # noqa: E402
from .reference import Bm25Reference  # noqa: E402
from .traffic import Traffic  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a configuration's metadata.csv, written once per checkout (git-ignored)
DATA = HERE / ".data"
FORBIDDEN = ("jax", "jaxlib", "flax", "nextsearch_tpu")
# answers judged per run, drawn from the seed, beside the longest ones
SAMPLE = 1024
LONGEST = 16
# the traced stretch after the window, and the traffic before it
TRACE_SECONDS = 2.0
SETTLE_SECONDS = 0.5


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return dict(
        cell=cell,
        cfg=json.loads((root / entry["file"]).read_text()),
        mix=json.loads((root / "searchbench" / "traffic"
                        / f"{cell['traffic']}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer, root=root,
    )


def reader(name: str, root: Path):
    """The read(run) function of searchbench/metrics/<name>.py."""
    path = root / "searchbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "searchbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the metric readers read: the traffic's window, the set-up
    times, the harness's host spans and the reduced device trace."""

    def __init__(self):
        self.window = None
        self.setup_s = None
        self.warmup_s = None
        self.build_phases = {}
        self.device_cfg = {}
        self.corpus = None
        self.spans = []  # (name, t0, t1, argument) on the host clock
        self.trace = None  # devtrace.reduce of the traced stretch
        self.trace_host = None  # (t0, t1) of the traced stretch, host clock
        self.captures_in_window = 0
        self.flush_cpu = []  # (start, CPU seconds) of each LRU flush

    def spans_in(self, name, t0=None, t1=None):
        """Spans called `name` that start inside [t0, t1] (the window by
        default)."""
        t0 = self.window.t_start if t0 is None else t0
        t1 = self.window.t_end if t1 is None else t1
        return [s for s in self.spans if s[0] == name and t0 <= s[1] <= t1]


def wrap(run: Run, obj, attr: str, name: str, keep_arg: bool = False,
         cpu: list = None):
    """Record a span around every call of obj.attr (an instance attribute,
    so the program's own code calls the wrapper), and where `cpu` is given,
    append to it the CPU seconds that the calling thread spent in it."""
    fn = getattr(obj, attr)
    rows = run.spans
    clock = time.perf_counter

    def wrapped(*a, **kw):
        t0 = clock()
        c0 = time.thread_time()
        try:
            return fn(*a, **kw)
        finally:
            t1 = clock()
            rows.append((name, t0, t1, a[0] if keep_arg else None))
            if cpu is not None:
                cpu.append((t0, time.thread_time() - c0))

    setattr(obj, attr, wrapped)


def segment_arrays(corpus):
    """The corpus as the program's segment type (its own builder's avgdl:
    f32 sum of lengths over f32 N); the arrays are shared, read-only."""
    from nextsearch_tpu_torch.index.builder import SegmentArrays

    n = corpus.n_docs
    return SegmentArrays(
        terms=[term_name(i) for i in range(corpus.vocab)],
        term_df=corpus.term_df,
        term_offsets=corpus.term_offsets,
        post_doc=corpus.post_doc,
        post_tf=corpus.post_tf,
        doc_len=corpus.doc_len,
        N=n,
        avgdl=float(np.float32(corpus.doc_len.sum(dtype=np.int64))
                    / np.float32(n)),
        cord_uids=[f"doc{i}" for i in range(n)],
    )


def serve(cfg: dict, seg, workdir: Path, device, meta=None):
    """The program's Engine over `seg`, loaded and warmed as the server
    does. Its index directory holds a manifest, an empty segment directory
    (reload's segment load is handed the generated arrays, which are not
    written to disk) and, where the deployment has one, a link to its
    metadata.csv."""
    from nextsearch_tpu_torch import engine as engine_mod
    from nextsearch_tpu_torch.api.server import serving_config
    from nextsearch_tpu_torch.index.segmentio import save_manifest

    for key, value in cfg.get("env", {}).items():
        os.environ[key] = str(value)
    config = serving_config(cfg["mode"])
    index_dir = workdir / "index"
    segdir = index_dir / "segments" / "seg_000001"
    segdir.mkdir(parents=True)
    save_manifest(index_dir / "manifest.bin", ["seg_000001"])
    if meta is not None:
        (index_dir / "metadata.csv").symlink_to(meta.path)
    cache_dir = workdir / "cache"
    cache_dir.mkdir()
    engine = engine_mod.Engine(index_dir, config, cache_dir, device=device)

    def load(path, k1=1.2, b=0.75):
        if Path(path) != segdir:
            raise OSError(f"no generated segment at {path}")
        return seg

    real = engine_mod.load_segment_cached
    engine_mod.load_segment_cached = load
    try:
        if not engine.reload():
            raise RuntimeError("Engine.reload failed")
    finally:
        engine_mod.load_segment_cached = real
    t0 = time.perf_counter()
    engine.warmup()
    return engine, config, time.perf_counter() - t0


def stop_flushers(engine) -> None:
    """Stop the write-behind threads of the Engine's LRU caches (the
    server's 1,000 ms flush) before their directory goes."""
    for cache in (engine.cache, engine.ai_overview_cache,
                  engine.ai_summary_cache):
        stop = getattr(cache, "_flush_stop", None)
        if stop is not None:
            stop.set()
    for t in threading.enumerate():
        if t.name.endswith("-flush"):
            t.join(timeout=10)


def siblings(cpu: int) -> set:
    """The logical CPUs that share `cpu`'s core (itself where the machine
    does not say)."""
    path = f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list"
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return {cpu}
    out = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out or {cpu}


def pin_host(n) -> list:
    """Pin every thread of this process, and so each thread it starts
    later, to `n` of its CPUs, each on a core of its own, so that the
    interpreter's lock passes between the same few CPUs in every run; the
    CPUs pinned (none where `n` is None)."""
    if not n or not hasattr(os, "sched_setaffinity"):
        return []
    chosen, taken = [], set()
    for cpu in sorted(os.sched_getaffinity(0), reverse=True):
        if cpu not in taken:
            chosen.append(cpu)
            taken |= siblings(cpu)
        if len(chosen) == int(n):
            break
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), chosen)
        except OSError:  # a thread that has just ended
            pass
    return sorted(chosen)


def host_clocks() -> tuple:
    """(wall, this process's CPU seconds, the machine's stolen seconds
    summed over its cores from /proc/stat, or 0 where there is none)."""
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return time.perf_counter(), time.process_time(), steal


def host_line(run: Run, before: tuple, after: tuple) -> str:
    """What the host did in the window: the requests' waits, and how much
    of the window the LRU flush and other tenants of the machine took."""
    win = run.window
    ms = sorted(readers.request_ms(run))
    q = (statistics.quantiles(ms, n=20, method="inclusive")
         if len(ms) > 1 else [float("nan")] * 19)
    flush = run.spans_in("LRUCache._save")
    clear = [1e3 * (t1 - t0) for t0, t1, _n, ok in win.requests
             if ok and not any(f0 < t1 and f1 > t0
                               for _n2, f0, f1, _a in flush)]
    cpu = sum(c for t, c in run.flush_cpu if win.t_start <= t <= win.t_end)
    return (f"requests: {len(ms)}, ms p25 {q[4]:.3f} p50 {q[9]:.3f} "
            f"p75 {q[14]:.3f} p90 {q[17]:.3f}; {len(clear)} clear of a "
            f"flush, their p50 {statistics.median(clear) if clear else 0:.3f}"
            f"; flush CPU {cpu:.3f} s; process CPU "
            f"{after[1] - before[1]:.3f} s and stolen "
            f"{after[2] - before[2]:.3f} s over {after[0] - before[0]:.3f} s")


def captures(engine) -> int:
    return sum(c.captures for c in engine.index.launch_caches.values())


def traced_stretch(traffic, batcher, seconds: float) -> dict:
    """Profile the card over `seconds` more of the cell's traffic, after
    SETTLE_SECONDS of it under the profiler: the profiler's start and stop
    stall the host, so this stretch follows the window instead of lying
    inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traffic.extra(batcher, SETTLE_SECONDS)
        with record_function("searchbench.trace"):
            h0 = time.perf_counter()
            traffic.extra(batcher, seconds)
            h1 = time.perf_counter()
    return {"prof": prof, "host": (h0, h1)}


def reduce_trace(run: Run, box: dict) -> None:
    trace = devtrace.load(box["prof"])
    t0_us, t1_us = devtrace.annotation(trace, "searchbench.trace")
    h0, h1 = box["host"]
    off = t0_us - h0 * 1e6
    spans = sorted((s * 1e6 + off, e * 1e6 + off, name)
                   for name, s, e, _a in run.spans)
    run.trace = devtrace.reduce(trace, t0_us, t1_us, spans)
    run.trace_host = (h0, h1)


def cached(served) -> bool:
    """Whether an answer came from the Engine's LRU cache (the native
    renderer's flag, or the dict's)."""
    if isinstance(served, tuple):
        return bool(served[1])
    return isinstance(served, dict) and bool(served.get("from_cache"))


def corpus_profile(corpus, device_cfg: dict, win) -> str:
    """The corpus's postings, its terms at or above the dense-row threshold
    (and those the row budget grants a row), and how heavy the window's
    distinct queries are."""
    n_slots = -(-corpus.n_docs // 2048) * 2048
    thr = max(1, int(n_slots * float(device_cfg["dense_df_ratio"])))
    df = corpus.term_df
    rows = roofline.dense_terms(df, corpus.n_docs, device_cfg)
    sent = {a[1]: a[0] for a in win.answers}
    prof = heavy_profile(df, thr, list(sent.values()))
    return (f"corpus: {corpus.n_postings} postings, {corpus.vocab} terms "
            f"({int((df > 0).sum())} with a posting); "
            f"{int((df >= thr).sum())} terms at df >= {thr}, {len(rows)} "
            f"granted a dense row; the window's {len(sent)} distinct "
            f"queries: heavy terms {prof['heavy_term_share']:.4f} of "
            f"their terms, in {prof['heavy_query_share']:.4f} of them, "
            f"mean query-term df {prof['mean_query_term_df']:.1f}")


def sample(win, seed: int, df: np.ndarray) -> list:
    """A seeded sample of the window's answers and its longest queries."""
    rng = np.random.default_rng([seed, 2])
    n = len(win.answers)
    idx = set(rng.choice(n, size=min(SAMPLE, n), replace=False).tolist())
    work = {}
    for i, a in enumerate(win.answers):
        work.setdefault(a[1], (int(df[a[0]].sum()), i))
    idx.update(i for _w, i in sorted(work.values(), reverse=True)[:LONGEST])
    return [(win.answers[i][0], win.answers[i][1], win.answers[i][4])
            for i in sorted(idx)]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device, control: bool = False, log=print) -> dict:
    """One run of the cell; returns the result object (and prints the
    compared numbers through `log`)."""
    seed = int(seed) % (1 << 63)
    device = torch.device(device)
    run = Run()
    cfg = cell["cfg"]
    workdir = Path(tempfile.mkdtemp(prefix="searchbench-"))
    try:
        meta = (Metadata(cfg, cell["root"] / "searchbench" / ".data")
                if cfg.get("metadata") else None)
        corpus = generate(cfg, seed, device)
        run.corpus = corpus
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        traffic = Traffic(cell["mix"], cfg, seed)
        engine, config, run.warmup_s = serve(
            cfg, segment_arrays(corpus), workdir, device, meta)
        cpus = pin_host(cell["mix"].get("host_cpus"))
        run.build_phases = dict(engine.index.build_phases)
        run.device_cfg = asdict(config.device)
        wrap(run, engine.cache, "_save", "LRUCache._save",
             cpu=run.flush_cpu)
        if trace:
            wrap(run, engine.index, "search_batch_async",
                 "TorchIndex.search_batch_async", keep_arg=True)
            wrap(run, engine.index, "search_batch_gather",
                 "TorchIndex.search_batch_gather")
            wrap(run, engine, "search_batch_async",
                 "Engine.search_batch_async", keep_arg=True)
            wrap(run, engine, "search_batch_gather",
                 "Engine.search_batch_gather")
        from nextsearch_tpu_torch.api.batching import SearchBatcher

        batcher = SearchBatcher(engine, config.batching)
        try:
            traffic.warm_up(batcher)
            n_cap = captures(engine)
            run.setup_s = time.perf_counter() - T0
            clocks = host_clocks()
            run.window = traffic.window(batcher, seconds)
            clocks = (clocks, host_clocks())
            run.captures_in_window = captures(engine) - n_cap
            box = (traced_stretch(traffic, batcher, TRACE_SECONDS)
                   if trace and device.type == "cuda" else None)
        finally:
            batcher.shutdown()
            stop_flushers(engine)
        peak = (torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else 0)
        del engine, batcher
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if box is not None:
            t_red = time.perf_counter()
            reduce_trace(run, box)
            log(f"trace read in {time.perf_counter() - t_red:.1f} s",
                file=sys.stderr)

        ref = Bm25Reference(corpus.term_offsets, corpus.post_doc,
                            corpus.post_tf, corpus.doc_len, device)
        items = sample(run.window, seed, corpus.term_df)
        numbers = judge.judge(items, ref, int(cfg["k"]), meta)
        if control:
            for prec in ("tf32", "bfloat16"):
                c = judge.judge(judge.control_answers(
                    items, ref, int(cfg["k"]), prec, meta), ref,
                    int(cfg["k"]), meta)
                log(f"control {prec}: " + json.dumps(c), file=sys.stderr)
                log(f"control {prec} correct: {judge.verdict(c)}",
                    file=sys.stderr)
        del ref

        wanted = cell["per_layer"] if trace else cell["end_to_end"]
        metrics = {}
        for m in wanted:
            v = reader(m["name"], cell["root"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        win = run.window
        log(f"set-up {run.setup_s:.3f} s (index build "
            f"{sum(run.build_phases.values()):.3f}, warm-up "
            f"{run.warmup_s:.3f}); window: {win.attempted} attempted, "
            f"{win.failed} failed, "
            f"{win.answered_in_window} answered in {seconds} s; "
            f"{sum(cached(a[4]) for a in win.answers)} from the LRU cache; "
            f"{run.captures_in_window} launch graph(s) captured in the "
            f"window; judged {numbers['judged']}", file=sys.stderr)
        flush = run.spans_in("LRUCache._save")
        log(f"LRU flush: {len(flush)} flush(es), "
            f"{sum(t1 - t0 for _n, t0, t1, _a in flush):.3f} s in the "
            f"window", file=sys.stderr)
        log(host_line(run, *clocks) + f"; pinned to CPUs {cpus}",
            file=sys.stderr)
        log(corpus_profile(corpus, run.device_cfg, win),
            file=sys.stderr)
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
        if trace and run.trace is not None:
            dev["busy_s"] = run.trace["busy_s"]
            dev["window_s"] = run.trace["window_s"]
        result = {"correct": judge.verdict(numbers),
                  "attempted": win.attempted, "failed": win.failed,
                  "metrics": metrics, "device": dev}
        if trace and run.trace is not None:
            result["breakdown"] = {"device_ops": run.trace["device_ops"],
                                   "idle_gaps": run.trace["idle_gaps"]}
        result["checks"] = {name: {"value": numbers[name], "limit": lim}
                            for name, lim in judge.LIMITS.items()}
        for line in judge.lines(numbers):
            log(line, file=sys.stderr)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"searchbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"searchbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
