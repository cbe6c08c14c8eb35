"""The port's autocomplete (ops/prefix.py, models/autocomplete.py) on the CPU
against the JAX package's: the prefix top-k functions bit for bit on int32
scores with many ties and -1 pads, AutocompleteIndex's suggestions on every
lookup path (per-prefix cache, narrow host range, device window, full
table), and the cases of tests/test_autocomplete.py."""

import numpy as np
import pytest
import torch

from nextsearch_tpu.models.autocomplete import AutocompleteIndex as JaxAutocomplete
from nextsearch_tpu.ops import prefix as jprefix
from nextsearch_tpu_torch.models import autocomplete as tac
from nextsearch_tpu_torch.models.autocomplete import (AutocompleteIndex,
                                                      split_last_token)
from nextsearch_tpu_torch.ops import prefix as tprefix

torch.set_num_threads(1)


def _scores_and_ranges(seed, T, Q, max_width):
    """int32 scores in 1..5 (ties everywhere) with a -1 tail, as the padded
    table has, and [lo, hi) ranges: empty, narrower than L, up to
    max_width, some reaching into the pad."""
    r = np.random.default_rng(seed)
    scores = r.integers(1, 6, T).astype(np.int32)
    scores[T - T // 8:] = -1
    lo = r.integers(0, T, Q).astype(np.int32)
    width = r.integers(0, max_width + 1, Q)
    width[:3] = (0, 1, 2)
    hi = np.minimum(lo + width, T).astype(np.int32)
    return scores, lo, hi


@pytest.mark.parametrize("seed,L", [(0, 1), (1, 5), (2, 10)])
def test_prefix_range_topk_bit_equal(seed, L):
    scores, lo, hi = _scores_and_ranges(seed, 384, 24, 384)
    jv, ji = jprefix.prefix_range_topk(scores, lo, hi, L=L)
    tv, ti = tprefix.prefix_range_topk(torch.as_tensor(scores),
                                       torch.as_tensor(lo), torch.as_tensor(hi),
                                       L=L)
    assert tv.dtype == ti.dtype == torch.int32
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert (tv.numpy() == -1).any()


@pytest.mark.parametrize("seed,L,W", [(3, 3, 16), (4, 10, 64), (5, 20, 16)])
def test_prefix_window_topk_bit_equal(seed, L, W):
    """L > W (the last case) takes the reference's padding."""
    scores, lo, hi = _scores_and_ranges(seed, 256, 32, W)
    jv, ji = jprefix.prefix_window_topk(scores, lo, hi, L=L, W=W)
    tv, ti = tprefix.prefix_window_topk(torch.as_tensor(scores),
                                        torch.as_tensor(lo), torch.as_tensor(hi),
                                        L=L, W=W)
    assert tv.shape == (32, L)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def _vocabulary():
    r = np.random.default_rng(12)
    alphabet = "abcd"
    terms = set()
    while len(terms) < 3000:
        length = int(r.integers(2, 9))
        terms.add("".join(alphabet[int(c)] for c in r.integers(0, 4, length)))
    # scores from a small range, so groups hold ties; mixed-case and
    # one-letter keys exercise normalization and the length filter
    scores = {t: int(r.integers(1, 40)) for t in sorted(terms)}
    scores.update({"ABCD": 99, "Abc": 7, "x": 5, "B": 3})
    return scores


PATHS = {
    # name: instance attributes that force the path
    "cached": {},
    "narrow host": {"PRECOMP_LEN": 0},
    "device window": {"PRECOMP_LEN": 0, "NARROW_RANGE": 0},
    "full table": {"PRECOMP_LEN": 0, "NARROW_RANGE": 0, "WINDOW_BUCKETS": (4,)},
}


@pytest.mark.parametrize("path", list(PATHS))
def test_suggest_batch_equals_jax_on_every_path(path):
    scores = _vocabulary()
    ref = JaxAutocomplete()
    ref.build(scores, 10)
    port = AutocompleteIndex(device="cpu")
    for name, v in PATHS[path].items():
        setattr(port, name, v)
    port.build(scores, 10)
    assert port.terms == ref.terms
    assert np.array_equal(port._scores_dev.numpy(), np.asarray(ref._scores_dev))
    inputs = ["a", "ab", "abc", "abcd", "abcda", "dcba", "aaaa", "b", "bc",
              "zz", "The AB", "x", "", "d c", "ABC", "abcdabcd", "c-d"]
    launched = []
    for fn in ("prefix_window_topk", "prefix_range_topk"):
        orig = getattr(tac, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            launched.append(_fn)
            return _orig(*a, **kw)
        setattr(tac, fn, spy)
    try:
        for L in (1, 3, 10):
            assert port.suggest_batch(inputs, L) == ref.suggest_batch(inputs, L), L
    finally:
        for fn in ("prefix_window_topk", "prefix_range_topk"):
            setattr(tac, fn, getattr(tprefix, fn))
    want = {"cached": set(), "narrow host": set(),
            "device window": {"prefix_window_topk"},
            "full table": {"prefix_range_topk"}}[path]
    assert set(launched) == want


# ---------------------------------------------------------------- the cases
# of tests/test_autocomplete.py, on the port's AutocompleteIndex


@pytest.fixture(scope="module")
def ac():
    idx = AutocompleteIndex(device="cpu")
    idx.build(
        {
            "covid": 500,
            "coronavirus": 300,
            "corona": 300,  # tie with coronavirus -> term asc
            "cough": 100,
            "cov": 90,
            "vaccine": 400,
            "vaccination": 50,
            "x": 7,  # len < 2 -> excluded
            "zz9": 1,
        },
        10,
    )
    return idx


def test_split_last_token():
    assert split_last_token("hello wor") == ("hello ", "wor")
    assert split_last_token("covid ") == ("", "covid")
    assert split_last_token("a b, c") == ("a b, ", "c")
    assert split_last_token("...") == ("", "")
    assert split_last_token("one-two") == ("one-", "two")


def test_prefix_ranking_score_desc_term_asc(ac):
    assert ac.suggest_query("cov", 10) == ["covid", "cov"]
    assert ac.suggest_query("co", 10) == [
        "covid", "corona", "coronavirus", "cough", "cov",
    ]


def test_limit_truncation(ac):
    assert ac.suggest_query("co", 2) == ["covid", "corona"]


def test_multiword_base_preserved(ac):
    assert ac.suggest_query("mRNA vac", 2) == ["mRNA vaccine", "mRNA vaccination"]
    assert ac.suggest_query("The COV", 1) == ["The covid"]


def test_no_match_and_empty(ac):
    assert ac.suggest_query("qqq", 5) == []
    assert ac.suggest_query("   ", 5) == []
    assert ac.suggest_query("", 5) == []


def test_short_terms_excluded(ac):
    assert "x" not in ac.terms
    assert ac.suggest_query("x", 5) == []


def test_batched_matches_single(ac):
    inputs = ["co", "vac", "qqq", "mRNA vac", ""]
    batched = ac.suggest_batch(inputs, 5)
    singles = [ac.suggest_query(i, 5) for i in inputs]
    assert batched == singles


def test_empty_index():
    idx = AutocompleteIndex(device="cpu")
    idx.build({}, 10)
    assert idx.empty()
    assert idx.suggest_query("co", 5) == []


def test_prefix_cache_matches_bruteforce():
    """Cached, windowed and full-table paths all equal brute force."""
    r = np.random.default_rng(12)
    alphabet = "abcd"
    terms = set()
    while len(terms) < 3000:
        length = int(r.integers(2, 9))
        terms.add("".join(alphabet[int(c)] for c in r.integers(0, 4, length)))
    scores = {t: int(r.integers(1, 10_000)) for t in terms}

    ac = AutocompleteIndex(device="cpu")
    ac.build(scores, max_candidates_per_prefix=10)

    def brute(prefix, L):
        cand = [(t, s) for t, s in scores.items() if t.startswith(prefix)]
        cand.sort(key=lambda x: (-x[1], x[0]))
        return [t for t, _s in cand[:L]]

    prefixes = ["a", "ab", "abc", "abcd", "abcda", "dcba", "aaaa", "b", "bc"]
    for p in prefixes:
        for L in (1, 3, 10):
            got = ac.suggest_batch([p], L)[0]
            assert got == brute(p, L), (p, L)

    batch = ["a", "abcda", "zz", "dc", "abcd"]
    got = ac.suggest_batch(batch, 5)
    assert got == [brute(p, 5) for p in batch]


def test_prefix_cache_wide_vocab_uses_cache(monkeypatch):
    """Short-prefix lookups never launch a device kernel."""
    ac = AutocompleteIndex(device="cpu")
    ac.build({f"term{i:05d}": i + 1 for i in range(5000)})

    def boom(*a, **k):
        raise AssertionError("device kernel must not run for short prefixes")

    monkeypatch.setattr(tac, "prefix_range_topk", boom)
    monkeypatch.setattr(tac, "prefix_window_topk", boom)
    res = ac.suggest_batch(["te", "term", "t"], 5)
    assert res[1][:1] == ["term04999"]


def test_host_narrow_range_matches_device_path(monkeypatch):
    """Long-prefix suggests answer host-side with exactly the device
    function's results and tie order (score desc, term asc)."""
    rng = np.random.default_rng(3)
    terms = {}
    for i in range(3000):
        t = f"prefix{i % 40:02d}word{i:04d}"
        terms[t] = int(rng.integers(1, 10_000))
    for i in range(10):
        terms[f"prefix00tie{i}"] = 777
    ac = AutocompleteIndex(device="cpu")
    ac.build(terms, 10)
    for q in ("prefix00", "prefix07wo", "prefix00tie", "prefix39word2"):
        host = ac.suggest_query(q, 10)
        lo, hi = ac.prefix_range(q)
        if lo >= hi:
            assert host == []
            continue
        with monkeypatch.context() as m:
            m.setattr(AutocompleteIndex, "NARROW_RANGE", 0)
            dev = ac.suggest_query(q, 10)
        assert host == dev, (q, host, dev)
