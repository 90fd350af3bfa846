"""The port's DenseDecoder against kaldi_tpu's (CPU tensors).

Mirrors tests/test_dense_decoder.py (SimpleDecoder oracle, batch,
binding beam) and holds the port to the JAX DenseDecoder: the same
alignments and word sequences, costs within 1e-3 (the same float32
operations in the same order), the same tie-breaking (first minimum;
an ε-sweep keeps its own token on a tie), and raw lattices equal arc
for arc, so that the path sets within ``lattice_beam`` are equal.
Each side decodes a graph built by its own package from the same
parameters; the port runs on the CPU (``device="cpu"``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.decoder import SimpleDecoder
from kaldi_tpu.decoder import align as jalign
from kaldi_tpu.decoder import dense as jdense
from kaldi_tpu.fst import csr as jcsr
from kaldi_tpu.lattice import determinize_lattice as jdeterminize
from kaldi_tpu.pipelines import largevocab as jlv
from kaldi_tpu_torch.decoder import dense as tdense
from kaldi_tpu_torch.fst import csr as tcsr
from kaldi_tpu_torch.lattice import determinize_lattice as tdeterminize
from kaldi_tpu_torch.pipelines import largevocab as tlv
from test_torch_beam import JAX, PORT, yesno_graph

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graph():
    """{side: (lang, tm, HCLG)}: the three-state yes/no graph, built by
    each package."""
    return {"jax": yesno_graph(JAX, "three_state"),
            "port": yesno_graph(PORT, "three_state")}


@pytest.fixture(scope="module")
def lv_graph():
    """A small large-vocabulary HCLG: ε-depth 3, hundreds of ε in-arcs
    into the back-off states; {side: (task, VectorFst)} and the
    log-likelihoods."""
    kw = dict(vocab_size=60, order=3, seed=7, closure=False,
              corpus_sentences=200)
    task = tlv.make_largevocab_task(**kw)
    jtask = jlv.make_largevocab_task(**kw)
    sents = tlv.sample_eval_set(task, 3, max_words=3, seed=5)
    rng = np.random.default_rng(6)
    lls = [tlv.synth_loglikes(task, sents[u], rng, noise=0.5)
           for u in sorted(sents)]
    return ({"port": (task, tcsr.csr_to_vector_fst(task.graph.csr)),
             "jax": (jtask, jcsr.csr_to_vector_fst(jtask.graph.csr))}, lls)


def _both(graphs, **cfg):
    """The port's and the JAX package's DenseDecoder, each on its own
    side's (HCLG, tm) pair."""
    (tHCLG, ttm), (jHCLG, jtm) = graphs
    return (tdense.DenseDecoder(tHCLG, ttm.tid_to_pdf_array,
                                tdense.DenseDecoderConfig(**cfg),
                                device="cpu"),
            jdense.DenseDecoder(jHCLG, jtm.tid_to_pdf_array,
                                jdense.DenseDecoderConfig(**cfg)))


def _pairs(graph):
    return ((graph["port"][2], graph["port"][1]),
            (graph["jax"][2], graph["jax"][1]))


def _lv_pairs(lv):
    (task, fst), (jtask, jfst) = lv["port"], lv["jax"]
    return (fst, task.tm), (jfst, jtask.tm)


def _same(got, want):
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) < 1e-3


@pytest.mark.parametrize("seed", range(5))
def test_dense_matches_simple(graph, seed):
    _, jtm, jHCLG = graph["jax"]
    lang, tm, HCLG = graph["port"]
    ll = np.random.default_rng(seed).standard_normal(
        (40, tm.num_pdfs)).astype(np.float32)
    ref = SimpleDecoder(jHCLG, acoustic_scale=0.1).decode(
        ll, jtm.tid_to_pdf_array)
    dec = tdense.DenseDecoder(tdense.pack_reverse(HCLG), tm.tid_to_pdf_array,
                              tdense.DenseDecoderConfig(beam=1e9,
                                                        acoustic_scale=0.1),
                              device="cpu")
    tids, ols, cost = dec.decode(ll)
    assert abs(cost - ref[2]) < 1e-3
    assert tids == ref[0]
    assert ols == ref[1]


def test_dense_batch(graph):
    _, jtm, jHCLG = graph["jax"]
    tm = graph["port"][1]
    rng = np.random.default_rng(7)
    tdec, jdec = _both(_pairs(graph), beam=1e9, acoustic_scale=0.1)
    simple = SimpleDecoder(jHCLG, acoustic_scale=0.1)
    T_pad, P = 48, tm.num_pdfs
    lls, lens, refs = [], [], []
    for T in [48, 21, 9]:
        ll = rng.standard_normal((T, P)).astype(np.float32)
        refs.append(simple.decode(ll, jtm.tid_to_pdf_array))
        pad = np.zeros((T_pad, P), np.float32)
        pad[:T] = ll
        lls.append(pad)
        lens.append(T)
    got = tdec.decode_batch(np.stack(lls), np.array(lens))
    for g, ref in zip(got, refs):
        _same(g, ref)
    for g, w in zip(got, jdec.decode_batch(np.stack(lls), np.array(lens))):
        _same(g, w)


def test_dense_beam_pruning_still_decodes(graph):
    tm = graph["port"][1]
    ll = np.random.default_rng(3).standard_normal(
        (30, tm.num_pdfs)).astype(np.float32)
    tdec, jdec = _both(_pairs(graph), beam=8.0, acoustic_scale=0.1)
    got = tdec.decode(ll)
    assert len(got[0]) == 30
    assert np.isfinite(got[2])
    _same(got, jdec.decode(ll))


def test_min_returns_first_of_tied_minima():
    """jnp.argmin returns the first minimum; the port's torch.min(dim)
    must too (the decoder's back-pointers depend on it)."""
    x = np.array([[3.0, 1.0, 1.0, 2.0, 1.0],
                  [1e30, 1e30, 1e30, 1e30, 1e30],
                  [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    vals, idx = torch.min(torch.from_numpy(x), dim=1)
    assert idx.tolist() == [1, 0, 0]
    assert idx.tolist() == np.asarray(jnp.argmin(x, axis=1)).tolist()
    np.testing.assert_array_equal(vals.numpy(), x.min(axis=1))


def test_dense_ties_match_jax(graph):
    """All-equal log-likelihoods on a graph whose two words weigh the
    same: every frame has tied candidates and the ε-sweeps tie with the
    token already there; the port picks the JAX decoder's path."""
    tm = graph["port"][1]
    ll = np.zeros((25, tm.num_pdfs), np.float32)
    tdec, jdec = _both(_pairs(graph), beam=1e9, acoustic_scale=0.1)
    _same(tdec.decode(ll), jdec.decode(ll))


def test_pack_dense_and_degrees_equal_jax(lv_graph):
    lv, _ = lv_graph
    fst, jfst = lv["port"][1], lv["jax"][1]
    assert tdense.degrees(fst) == jalign.degrees(jfst)
    ae, an = tdense.degrees(fst)
    got = tdense.pack_dense(fst, fst.num_states + 3, ae + 1, an)
    want = jalign.pack_dense(jfst, fst.num_states + 3, ae + 1, an)
    for name in ("e_il", "e_ol", "e_w", "e_ns", "n_ol", "n_w", "n_ns",
                 "final"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert (got.num_states, got.start, got.eps_depth) == \
        (want.num_states, want.start, want.eps_depth)
    rev_t, rev_j = tdense.pack_reverse(fst), jdense.pack_reverse(jfst)
    for name in ("e_src", "e_il", "e_ol", "e_w", "n_src", "n_ol", "n_w",
                 "final"):
        np.testing.assert_array_equal(getattr(rev_t, name),
                                      getattr(rev_j, name))
    assert rev_t.eps_depth == rev_j.eps_depth == 3


def test_dense_batch_matches_jax_on_largevocab(lv_graph):
    lv, lls = lv_graph
    tdec, jdec = _both(_lv_pairs(lv), beam=13.0, acoustic_scale=1.0)
    lens = np.array([len(x) for x in lls])
    X = np.zeros((len(lls), int(lens.max()), lls[0].shape[1]), np.float32)
    for b, x in enumerate(lls):
        X[b, :len(x)] = x
    got = tdec.decode_batch(X, lens)
    assert any(g[1] for g in got)
    for g, w in zip(got, jdec.decode_batch(X, lens)):
        _same(g, w)


def _lattice_paths(lat):
    """(tids, words) → min cost over raw-lattice paths."""
    out = {}

    def go(s, tids, words, cost):
        if s in lat.finals:
            gc, ac = lat.finals[s]
            key = (tuple(tids), tuple(words))
            out[key] = min(out.get(key, np.inf), cost + gc + ac)
        for a in lat.arcs[s]:
            go(a.nextstate, tids + ([a.ilabel] if a.ilabel else []),
               words + ([a.olabel] if a.olabel else []), cost + a.total)

    go(lat.start, [], [], 0.0)
    return out


def _same_lattice(got, want):
    """Raw lattices equal node for node and arc for arc (costs 1e-3)."""
    assert got.num_states == want.num_states and got.start == want.start
    for s in range(want.num_states):
        ga, wa = got.arcs[s], want.arcs[s]
        assert [(a.ilabel, a.olabel, a.nextstate) for a in ga] == \
            [(a.ilabel, a.olabel, a.nextstate) for a in wa]
        np.testing.assert_allclose([a.total for a in ga],
                                   [a.total for a in wa], atol=1e-3)
    assert set(got.finals) == set(want.finals)


@pytest.mark.parametrize("seed", range(3))
def test_decode_lattice_matches_jax(graph, seed):
    tm = graph["port"][1]
    ll = np.random.default_rng(seed).standard_normal(
        (7, tm.num_pdfs)).astype(np.float32)
    tdec, jdec = _both(_pairs(graph), beam=16.0, lattice_beam=3.0,
                       acoustic_scale=1.0)
    glat, gbest = tdec.decode_lattice(ll)
    wlat, wbest = jdec.decode_lattice(ll)
    assert abs(gbest - wbest) < 1e-3
    _same_lattice(glat, wlat)
    got, want = _lattice_paths(glat), _lattice_paths(wlat)
    assert len(got) > 1 and set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) < 1e-3
    assert abs(min(got.values()) - gbest) < 1e-3
    gw, gt, gc = tdeterminize(glat).best_path()
    ww, wt, wc = jdeterminize(wlat).best_path()
    assert (gw, gt) == (ww, wt) and abs(gc - wc) < 1e-3


def test_decode_lattice_matches_jax_on_largevocab(lv_graph):
    lv, lls = lv_graph
    tdec, jdec = _both(_lv_pairs(lv), beam=13.0, lattice_beam=4.0,
                       acoustic_scale=1.0)
    for ll in lls[:2]:
        glat, gbest = tdec.decode_lattice(ll)
        wlat, wbest = jdec.decode_lattice(ll)
        assert abs(gbest - wbest) < 1e-3
        _same_lattice(glat, wlat)
        gw, gt, gc = tdeterminize(glat).best_path()
        ww, wt, wc = jdeterminize(wlat).best_path()
        assert gw and (gw, gt) == (ww, wt) and abs(gc - wc) < 1e-3
