"""engine.cache_flush_share.closed: percent of the window's seconds spent
in the LRU search cache's write-behind flush (LRUCache._save: the whole
cache dumped as JSON, once a second in the server's configuration), which
holds the GIL that the dispatcher and the clients share."""


def read(run):
    spans = run.spans_in("LRUCache._save")
    if not spans:
        return None
    w = run.window
    return 100.0 * sum(t1 - t0 for _n, t0, t1, _a in spans) / (
        w.t_end - w.t_start)
