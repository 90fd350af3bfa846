"""The port's keyword search (kaldi_tpu_torch/kws.py, a numpy copy)
against the JAX package's, mirroring the KWS tests of
tests/test_lm_kws_misc.py (``test_keyword_search``,
``test_lattice_index_matches_direct_search``).  Each side builds the same
CompactLattices from its own classes.  Bars: hits (utterance, frames)
equal and posteriors within 1e-9 (both float64 numpy); index files equal
byte for byte, the union's too; and the original's property on the
port: the index returns what the direct search returns.
"""

import io
import math

import numpy as np
import pytest

from kaldi_tpu import kws as jk
from kaldi_tpu.core import io as jio
from kaldi_tpu.lattice.lattice import CompactArc as JArc
from kaldi_tpu.lattice.lattice import CompactLattice as JLat
from kaldi_tpu_torch import kws as tk
from kaldi_tpu_torch.core import io as tio
from kaldi_tpu_torch.lattice.lattice import CompactArc as TArc
from kaldi_tpu_torch.lattice.lattice import CompactLattice as TLat

KEYWORDS = ([5, 6], [6], [5], [7, 6], [9], [5, 9])


def two_branch(lat_cls, arc):
    """Branch 1: words 5 6 (cost 0); branch 2: words 7 6 (cost 1)."""
    c = lat_cls()
    s = [c.add_state() for _ in range(3)]
    c.start = s[0]
    c.arcs[s[0]].append(arc(5, 0.0, 0.0, (1, 2), s[1]))
    c.arcs[s[0]].append(arc(7, 1.0, 0.0, (3,), s[1]))
    c.arcs[s[1]].append(arc(6, 0.0, 0.0, (4,), s[2]))
    c.finals[s[2]] = (0.0, 0.0, ())
    return c


def with_eps(lat_cls, arc):
    """An ε arc between the two keyword words, beside a direct arc."""
    d = lat_cls()
    t = [d.add_state() for _ in range(4)]
    d.start = t[0]
    d.arcs[t[0]].append(arc(5, 0.2, 0.1, (1,), t[1]))
    d.arcs[t[1]].append(arc(0, 0.4, 0.0, (2,), t[2]))  # ε
    d.arcs[t[1]].append(arc(6, 0.9, 0.0, (8,), t[3]))  # direct
    d.arcs[t[2]].append(arc(6, 0.3, 0.2, (3,), t[3]))
    d.finals[t[3]] = (0.1, 0.0, ())
    return d


def random_sausage(lat_cls, arc, seed, T=5, width=3, vocab=4):
    """A seeded word sausage with some ε arcs (a larger collection)."""
    rng = np.random.default_rng(seed)
    c = lat_cls()
    s = [c.add_state() for _ in range(T + 1)]
    c.start = s[0]
    for t in range(T):
        for _ in range(width):
            word = int(rng.integers(0, vocab + 1)) and \
                int(rng.integers(5, 5 + vocab))
            c.arcs[s[t]].append(arc(word, float(rng.uniform(0, 2)),
                                    float(rng.uniform(0, 3)),
                                    tuple(range(int(rng.integers(1, 4)))),
                                    s[t + 1]))
    c.finals[s[T]] = (0.3, 0.0, ())
    return c


def collection(lat_cls, arc):
    lats = {"u1": two_branch(lat_cls, arc), "u2": with_eps(lat_cls, arc)}
    for i in range(3):
        lats[f"r{i}"] = random_sausage(lat_cls, arc, i)
    return lats


def hits(results):
    return {kw: [(h.utt, h.begin_frame, h.end_frame, h.posterior)
                 for h in hs] for kw, hs in results.items()}


def same_hits(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1], (g, w)
        assert abs(g[-1] - w[-1]) < 1e-9, (g, w)


def test_keyword_search_equals_jax():
    c = two_branch(TLat, TArc)
    res = tk.search_lattice(c, [5, 6])
    assert res == jk.search_lattice(two_branch(JLat, JArc), [5, 6])
    assert len(res) == 1
    b, e, post = res[0]
    assert abs(post - 1.0 / (1.0 + math.exp(-1.0))) < 1e-6
    assert b == 0 and e >= 3
    res6 = tk.search_lattice(c, [6])
    assert abs(sum(p for _, _, p in res6) - 1.0) < 1e-6
    assert tk.search_lattice(c, [9]) == []
    kws = {"kw1": [5, 6], "kw2": [9]}
    got = hits(tk.keyword_search({"utt1": c}, kws))
    assert got == hits(jk.keyword_search({"utt1": two_branch(JLat, JArc)},
                                         kws))
    assert len(got["kw1"]) == 1 and got["kw1"][0][0] == "utt1"
    assert got["kw2"] == []


@pytest.mark.parametrize("acoustic_scale", [1.0, 0.1])
def test_lattice_index_equals_jax_and_direct_search(acoustic_scale):
    tl, jl = collection(TLat, TArc), collection(JLat, JArc)
    idx = tk.LatticeIndex.build(tl, acoustic_scale=acoustic_scale)
    jidx = jk.LatticeIndex.build(jl, acoustic_scale=acoustic_scale)
    assert idx.utts == jidx.utts
    for kw in KEYWORDS:
        got = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                     for h in idx.search(kw))
        same_hits(got, sorted((h.utt, h.begin_frame, h.end_frame,
                               h.posterior) for h in jidx.search(kw)))
        direct = sorted((u, b, e, p) for u in sorted(tl)
                        for b, e, p in tk.search_lattice(
                            tl[u], kw, acoustic_scale))
        same_hits(got, direct)
    kws = {f"k{i}": kw for i, kw in enumerate(KEYWORDS)}
    res = idx.search_all(kws, 0.05)
    assert hits(res) == hits(jidx.search_all(kws, 0.05))
    assert hits(tk.keyword_search(tl, kws, 0.05, acoustic_scale)) == hits(
        jk.keyword_search(jl, kws, 0.05, acoustic_scale))


def _index_bytes(kio, mod, idx):
    f = io.BytesIO()
    kio.init_kaldi_output_stream(f)
    mod.write_lattice_index(f, idx)
    return f.getvalue()


def test_index_files_and_union_equal_jax():
    """Shards written, read back and merged: every file the JAX
    package's byte for byte; the merged index searches as the index of
    the whole collection does, within the float32 the file stores."""
    tl, jl = collection(TLat, TArc), collection(JLat, JArc)
    keys = sorted(tl)
    shards = (keys[:2], keys[2:])
    parts = []
    for shard in shards:
        t = tk.LatticeIndex.build({k: tl[k] for k in shard})
        j = jk.LatticeIndex.build({k: jl[k] for k in shard})
        raw = _index_bytes(tio, tk, t)
        assert raw == _index_bytes(jio, jk, j)
        f = io.BytesIO(raw)
        tio.init_kaldi_input_stream(f)
        parts.append(tk.read_lattice_index(f))
    union = tk.merge_indexes(parts)
    jparts = []
    for shard in shards:
        f = io.BytesIO(_index_bytes(jio, jk, jk.LatticeIndex.build(
            {k: jl[k] for k in shard})))
        jio.init_kaldi_input_stream(f)
        jparts.append(jk.read_lattice_index(f))
    assert _index_bytes(tio, tk, union) == _index_bytes(
        jio, jk, jk.merge_indexes(jparts))
    whole = tk.LatticeIndex.build(tl)
    assert union.utts == whole.utts
    for kw in KEYWORDS:
        got = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                     for h in union.search(kw))
        want = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                      for h in whole.search(kw))
        assert [g[:-1] for g in got] == [w[:-1] for w in want]
        np.testing.assert_allclose([g[-1] for g in got],
                                   [w[-1] for w in want], rtol=1e-6)
