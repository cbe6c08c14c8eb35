"""The port's semantic expansion (ops/dense.similarity_topk, models/semantic.py)
on the CPU against the JAX package's: the loaders bit for bit, the
similarity top-k (rows equal, sims within 2e-6), expand() (equal term lists,
weights within 2e-6), and the cases of tests/test_semantic.py.

The two packages sum a dot product in different orders, so a candidate
within an ULP of min_sim, or two neighbours within an ULP of each other,
could rank differently. The inputs here are drawn so that no such pair
exists: such cases are counted (|sim - min_sim| < 2e-6, neighbour gaps
< 2e-6) and the count is asserted to be 0 at these seeds."""

import numpy as np
import pytest
import torch

from nextsearch_tpu.models.semantic import SemanticIndex as JaxSemantic
from nextsearch_tpu.ops import dense as jdense
from nextsearch_tpu_torch.models.semantic import SemanticIndex
from nextsearch_tpu_torch.ops import dense as tdense

torch.set_num_threads(1)

EPS = 2e-6


def _near_cases(sims: np.ndarray, min_sim: float) -> int:
    """Finite top-k similarities within EPS of the floor or of the next
    one in their row: where two summation orders may disagree."""
    n = 0
    for row in sims:
        f = row[np.isfinite(row)]
        n += int((np.abs(f - min_sim) < EPS).sum())
        n += int((np.abs(np.diff(f)) < EPS).sum())
    return n


def _clustered(n_terms=400, dim=32, per_cluster=8, sigma=0.65, seed=0):
    """Terms t0000... with vectors centre + sigma * noise, 8 to a cluster:
    in-cluster cosines about 0.7, cross-cluster about 0."""
    r = np.random.default_rng(seed)
    centres = r.normal(size=(n_terms // per_cluster + 1, dim)) / np.sqrt(dim)
    noise = r.normal(size=(n_terms, dim)) / np.sqrt(dim)
    vecs = centres[np.arange(n_terms) // per_cluster] + sigma * noise
    return [f"t{i:04d}" for i in range(n_terms)], vecs.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    terms, vecs = _clustered()
    ref, port = JaxSemantic(), SemanticIndex(device="cpu")
    assert ref.load_from_arrays(terms, vecs) and port.load_from_arrays(terms, vecs)
    return ref, port


def test_load_from_arrays_bit_equal(pair):
    ref, port = pair
    assert port.terms == ref.terms and port.dim == ref.dim
    assert port.term_to_row == ref.term_to_row
    assert np.array_equal(port._emb_host.view(np.uint32),
                          ref._emb_host.view(np.uint32))
    assert torch.equal(port.emb, torch.from_numpy(ref._emb_host))
    assert np.array_equal(port.get_vec("t0007"), ref.get_vec("t0007"))
    assert port.get_vec("nosuch") is None


def test_load_from_text_bit_equal(tmp_path):
    """Header, a short row, a dim mismatch, an unparsable row, a duplicate
    (first wins), a zero vector and the needed-terms filter."""
    r = np.random.default_rng(4)
    lines = ["7 12"]
    for t in ("alpha", "beta", "gamma", "delta", "alpha"):
        lines.append(t + " " + " ".join(f"{x:.6f}" for x in r.normal(size=12)))
    lines += ["short 1 2 3", "wide " + " ".join(["0.5"] * 13),
              "bad " + " ".join(["x"] * 12), "zero " + " ".join(["0"] * 12), ""]
    p = tmp_path / "emb.vec"
    p.write_text("\n".join(lines) + "\n")
    for needed in (set(), {"alpha", "gamma", "short", "zero", "wide"}):
        ref, port = JaxSemantic(), SemanticIndex(device="cpu")
        assert ref.load_from_text(p, needed) == port.load_from_text(p, needed) is True
        assert port.terms == ref.terms and port.dim == ref.dim == 12
        assert np.array_equal(port._emb_host.view(np.uint32),
                              ref._emb_host.view(np.uint32))
    assert not SemanticIndex(device="cpu").load_from_text(tmp_path / "no", set())


@pytest.mark.parametrize("min_sim,k", [(0.55, 5), (0.1, 7), (-1.0, 12)])
def test_similarity_topk_matches_jax(pair, min_sim, k):
    ref, port = pair
    r = np.random.default_rng(9)
    q = port._emb_host[r.choice(len(port.terms), 6, replace=False)]
    centroid = q[:3].mean(axis=0)
    q = np.vstack([q, centroid / np.linalg.norm(centroid)]).astype(np.float32)
    banned = np.zeros(len(port.terms), bool)
    banned[r.choice(len(port.terms), 40, replace=False)] = True
    jv, jr = jdense.similarity_topk(ref._emb_host, q, banned, np.float32(min_sim),
                                    k=k)
    tv, tr = tdense.similarity_topk(port.emb, torch.from_numpy(q),
                                    torch.from_numpy(banned), min_sim, k=k)
    jv, jr = np.asarray(jv), np.asarray(jr)
    assert _near_cases(jv, min_sim) == 0
    assert tr.dtype == torch.int32
    live = np.isfinite(jv)
    assert np.array_equal(np.isfinite(tv.numpy()), live)
    assert np.array_equal(tr.numpy()[live], jr[live])
    assert np.allclose(tv.numpy()[live], jv[live], rtol=0, atol=EPS)
    assert not banned[tr.numpy()[live]].any()
    # rows that fail the floor are -inf, padded by the lowest free rows
    assert np.array_equal(tr.numpy(), jr)


def test_matvec_scores_matches_jax(pair):
    ref, port = pair
    q = port._emb_host[3]
    got = tdense.matvec_scores(port.emb, torch.from_numpy(q)).numpy()
    assert np.allclose(got, np.asarray(jdense.matvec_scores(ref._emb_host, q)),
                       rtol=0, atol=EPS)


def _queries(n_terms, seed=2):
    r = np.random.default_rng(seed)
    out = [["t0000"], ["t0009", "t0200"], ["t0001", "nosuch"], ["nosuch"], []]
    for w in (1, 2, 3, 4, 6, 10):
        for _ in range(4):
            out.append([f"t{i:04d}" for i in r.choice(n_terms, w, replace=False)])
    return out


@pytest.mark.parametrize("params", [
    {},  # the engine's ExpansionConfig: 3 / 5 / 0.55 / 0.6 / 40
    dict(per_term=5, global_topk=0, min_sim=0.3),
    dict(per_term=0, global_topk=8, min_sim=0.2, alpha=0.9),
    dict(max_total_terms=6),
])
def test_expand_matches_jax(pair, params):
    ref, port = pair
    exempt = 0
    expanded = 0
    for q in _queries(len(port.terms)):
        a, b = port.expand(q, **params), ref.expand(q, **params)
        # where the two could disagree: weights within EPS of each other
        # (their order) or similarities within EPS of the floor
        ws = np.array([w for _t, w in b])
        exempt += int((np.abs(np.diff(ws)) < EPS).sum() - (np.diff(ws) == 0).sum())
        assert [t for t, _w in a] == [t for t, _w in b], q
        assert np.allclose([w for _t, w in a], ws, rtol=0, atol=EPS), q
        expanded += len(a) > len(set(q) - {""})
    assert exempt == 0
    assert expanded > 10


# ---------------------------------------------------------------- the cases
# of tests/test_semantic.py, on the port's SemanticIndex


def _make_index():
    rng = np.random.default_rng(7)
    base = rng.normal(size=12).astype(np.float32)

    def near(v, eps):
        return v + eps * rng.normal(size=12).astype(np.float32)

    terms = ["covid", "corona", "virus", "vaccine", "banana", "apple"]
    vecs = np.stack(
        [
            base,
            near(base, 0.1),
            near(base, 0.3),
            rng.normal(size=12).astype(np.float32),
            rng.normal(size=12).astype(np.float32),
            rng.normal(size=12).astype(np.float32),
        ]
    )
    idx = SemanticIndex(device="cpu")
    assert idx.load_from_arrays(terms, vecs)
    return idx


def test_expand_disabled_returns_originals():
    idx = SemanticIndex(device="cpu")
    out = idx.expand(["covid", "vaccine"])
    assert sorted(out) == [("covid", 1.0), ("vaccine", 1.0)]


def test_expand_originals_weight_one_and_banned():
    idx = _make_index()
    out = idx.expand(["covid"], per_term=3, global_topk=0, min_sim=0.5, alpha=0.6)
    d = dict(out)
    assert d["covid"] == 1.0
    assert "corona" in d
    assert 0 < d["corona"] <= 0.6
    emb = idx._emb_host
    sim = float(np.dot(emb[0], emb[1]))
    assert abs(d["corona"] - 0.6 * sim) < 1e-6


def test_expand_min_sim_filters():
    idx = _make_index()
    out = idx.expand(["covid"], per_term=5, global_topk=0, min_sim=0.999, alpha=0.6)
    assert out == [("covid", 1.0)]


def test_expand_centroid_factor():
    idx = _make_index()
    out = idx.expand(
        ["covid", "corona"], per_term=0, global_topk=3, min_sim=0.3, alpha=0.6
    )
    d = dict(out)
    assert d["covid"] == 1.0 and d["corona"] == 1.0
    extra = {t: v for t, v in d.items() if t not in ("covid", "corona")}
    for t, v in extra.items():
        assert v <= 0.8 * 0.6 + 1e-7


def test_expand_cap_total_terms():
    idx = _make_index()
    out = idx.expand(
        ["covid"], per_term=5, global_topk=5, min_sim=-1.0, alpha=0.6,
        max_total_terms=3,
    )
    assert len(out) == 3
    assert out[0] == ("covid", 1.0)
    ws = [v for _, v in out]
    assert ws == sorted(ws, reverse=True)


def test_load_from_text(tmp_path):
    p = tmp_path / "emb.vec"
    dim = 12
    rows = []
    rng = np.random.default_rng(3)
    for t in ["alpha", "beta", "gamma"]:
        v = rng.normal(size=dim)
        rows.append(t + " " + " ".join(f"{x:.6f}" for x in v))
    p.write_text(f"3 {dim}\n" + "\n".join(rows) + "\nshort 1 2 3\n")
    idx = SemanticIndex(device="cpu")
    ok = idx.load_from_text(p, {"alpha", "gamma", "short"})
    assert ok and idx.enabled
    assert idx.terms == ["alpha", "gamma"]
    assert idx.dim == dim
    assert abs(np.linalg.norm(idx._emb_host[0]) - 1.0) < 1e-5


def test_load_missing_file(tmp_path):
    idx = SemanticIndex(device="cpu")
    assert not idx.load_from_text(tmp_path / "nope.vec", set())
    assert not idx.enabled
