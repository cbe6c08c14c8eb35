"""engine.host_ms.closed: host ms a batch inside Engine.search_batch_async
and Engine.search_batch_gather (cache probes, tokenizer, render, cache
fill), less the index calls nested in them."""


def read(run):
    outer = run.spans_in("Engine.search_batch_async")
    if not outer:
        return None
    total = sum(t1 - t0 for name in (
        "Engine.search_batch_async", "Engine.search_batch_gather")
        for _n, t0, t1, _a in run.spans_in(name))
    nested = sum(t1 - t0 for name in (
        "TorchIndex.search_batch_async", "TorchIndex.search_batch_gather")
        for _n, t0, t1, _a in run.spans_in(name))
    return 1e3 * (total - nested) / len(outer)
