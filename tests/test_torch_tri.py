"""Triphone training pieces of the PyTorch port against the JAX package:
context composition and context-dependent HCLG, tree statistics, tree
building, alignment conversion, the LDA, MLLT and fMLLR estimators and
lattice frame posteriors (tests/test_tri.py and
tests/test_transforms.py, held against the original).

Each side builds its own Lang, models and graphs from the same seeded
numpy inputs.  Graph builders, tree code, the estimators' host math and
``frame_posteriors`` are copies: equal arcs and arrays, and equal
matrices given equal statistics.  Where the statistics pass through the
GMM's mixture posteriors (``estimate_mllt``, ``accumulate_fmllr_*``),
the posteriors are float32 products in another order (1e-5, see
tests/test_torch_gmm_train.py): the accumulators at rtol 1e-5 and the
estimated transforms at 1e-4.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.am import HmmTopology as JTopo
from kaldi_tpu.am import MonophoneContextDependency as JMono
from kaldi_tpu.am import TransitionModel as JTM
from kaldi_tpu.am import gmm as jgmm
from kaldi_tpu.am import transforms as jtr
from kaldi_tpu.am import tree as jtree
from kaldi_tpu.fst import ArpaModel as JArpa
from kaldi_tpu.fst import Lang as JLang
from kaldi_tpu.fst import Lexicon as JLexicon
from kaldi_tpu.fst import arpa_to_fst as j_arpa_to_fst
from kaldi_tpu.fst import compose as jcompose
from kaldi_tpu.fst import make_unigram_arpa as j_unigram
from kaldi_tpu.fst import mkgraph as jmkgraph
from kaldi_tpu.fst import ops as jops
from kaldi_tpu.fst.context import compose_context as j_compose_context
from kaldi_tpu.lattice import functions as jlf
from kaldi_tpu.lattice.lattice import CompactArc as JArc
from kaldi_tpu.lattice.lattice import CompactLattice as JClat
from kaldi_tpu.pipelines import tri as jtri
from kaldi_tpu_torch.am import gmm as tgmm
from kaldi_tpu_torch.am import transforms as ttr
from kaldi_tpu_torch.am import tree as ttree
from kaldi_tpu_torch.am.topology import HmmTopology as TTopo
from kaldi_tpu_torch.am.transitions import TransitionModel as TTM
from kaldi_tpu_torch.fst import ArpaModel as TArpa
from kaldi_tpu_torch.fst import Lang as TLang
from kaldi_tpu_torch.fst import Lexicon as TLexicon
from kaldi_tpu_torch.fst import arpa_to_fst as t_arpa_to_fst
from kaldi_tpu_torch.fst import compose as tcompose
from kaldi_tpu_torch.fst import make_unigram_arpa as t_unigram
from kaldi_tpu_torch.fst import mkgraph as tmkgraph
from kaldi_tpu_torch.fst import ops as tops
from kaldi_tpu_torch.fst.context import compose_context as t_compose_context
from kaldi_tpu_torch.lattice import functions as tlf
from kaldi_tpu_torch.lattice.lattice import CompactArc as TArc
from kaldi_tpu_torch.lattice.lattice import CompactLattice as TClat
from kaldi_tpu_torch.pipelines import tri as ttri

torch.set_num_threads(1)

ENTRIES = [("YES", ["Y", "EH", "S"]), ("NO", ["N", "OW"]),
           ("SO", ["S", "OW"])]


def _arcs(fst):
    return ([[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate)
              for a in arcs] for arcs in fst.arcs],
            fst.start, sorted(fst.finals.items()))


def _side(J):
    Lexicon, Lang, Topo, Mono, TM, arpa, to_fst, unigram = (
        (JLexicon, JLang, JTopo, JMono, JTM, JArpa, j_arpa_to_fst, j_unigram)
        if J else
        (TLexicon, TLang, TTopo, ttree.MonophoneContextDependency, TTM,
         TArpa, t_arpa_to_fst, t_unigram))
    lang = Lang(Lexicon(entries=list(ENTRIES)))
    phones = lang.phone_list()
    topo = Topo.three_state(phones)
    tm = TM(topo, Mono(phones, topo))
    G = to_fst(arpa.parse(unigram({w: 1.0 for w, _ in ENTRIES})),
               lang.words)
    return lang, topo, tm, G


@pytest.fixture(scope="module")
def sides():
    return _side(True), _side(False)


def _alignments(tm, tree, rng, seqs):
    """Per sequence of phones, 3 frames a state (fwd, self, self)."""
    alis = []
    for seq in seqs:
        tids = []
        for ph in seq:
            for state in range(3):
                pdf = tree.compute([ph], state)
                ts = tm.tuple_to_transition_state(ph, state, pdf, pdf)
                fwd = [t for t in range(tm.state2id[ts], tm.state2id[ts + 1])
                       if not tm.is_self_loop(t)][0]
                slf = tm.self_loop_of(ts)
                tids.extend([fwd, slf, slf])
        alis.append(tids)
    return alis


@pytest.fixture(scope="module")
def tree_pair(sides):
    """Tree statistics → questions → a triphone tree, on each side, from
    the same alignments and features."""
    (jl, jtopo, jtm, _), (tl, ttopo, ttm, _) = sides
    rng = np.random.default_rng(3)
    phones = jl.phone_list()
    seqs = [list(rng.choice(phones, size=int(rng.integers(3, 7))))
            for _ in range(12)]
    alis = _alignments(jtm, jtm.tree, rng, seqs)
    feats, ali = {}, {}
    for i, (seq, a) in enumerate(zip(seqs, alis)):
        f = np.repeat(np.asarray(seq, np.float64), 9)[:, None] \
            + 0.3 * rng.standard_normal((len(a), 4))
        feats[f"u{i}"], ali[f"u{i}"] = f, a
    out = []
    for tri, tree_mod, tm, topo, TM in ((jtri, jtree, jtm, jtopo, JTM),
                                        (ttri, ttree, ttm, ttopo, TTM)):
        stats = tri.accumulate_tree_stats(feats, ali, tm)
        questions = tri.cluster_phone_questions(stats)
        tree = tree_mod.build_tree(stats, questions, 3, 1, max_leaves=18)
        out.append((stats, questions, tree, TM(topo, tree)))
    return feats, ali, out


def test_tree_stats_questions_and_tree_equal(tree_pair):
    _, _, ((js, jq, jt, _), (ts, tq, tt, _)) = tree_pair
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].count == js[k].count
        np.testing.assert_array_equal(ts[k].sum, js[k].sum)
        np.testing.assert_array_equal(ts[k].sumsq, js[k].sumsq)
    assert tq == jq
    assert tt.num_pdfs == jt.num_pdfs > 1
    for (w, pc) in js:
        assert tt.compute(w, pc) == jt.compute(w, pc)


def test_convert_alignment_and_init_model_equal(tree_pair, sides):
    (_, _, jtm, _), (_, _, ttm, _) = sides
    feats, ali, ((js, _, jt, jtm2), (ts, _, tt, ttm2)) = tree_pair
    for u in ali:
        got = ttri.convert_alignment(ttm, ttm2, ali[u])
        assert got == jtri.convert_alignment(jtm, jtm2, ali[u])
        assert ttm2.alignment_to_phones(got) == \
            ttm.alignment_to_phones(ali[u])
    jam = jtri.init_model_from_tree_stats(jt, js)
    tam = ttri.init_model_from_tree_stats(tt, ts, device="cpu")
    for name in ("weights", "means", "vars"):
        np.testing.assert_array_equal(getattr(tam, name), getattr(jam, name))


def test_compose_context_equal(sides):
    (jl, _, _, jG), (tl, _, _, tG) = sides
    jLG = jops.minimize_encoded(jops.determinize_star(
        jcompose(jl.L_disambig, jG)))
    tLG = tops.minimize_encoded(tops.determinize_star(
        tcompose(tl.L_disambig, tG)))
    for N, P in ((3, 1), (2, 1)):
        jc, jinfo, jd = j_compose_context(jLG, jl, N, P)
        tc, tinfo, td = t_compose_context(tLG, tl, N, P)
        assert _arcs(tc) == _arcs(jc)
        assert tinfo == jinfo and td == jd


def test_mkgraph_triphone_equal(tree_pair, sides):
    """The context-dependent branch of mkgraph (ported in this slice)
    builds the JAX package's HCLG from the same triphone tree."""
    (jl, _, _, jG), (tl, _, _, tG) = sides
    _, _, ((_, _, _, jtm2), (_, _, _, ttm2)) = tree_pair
    jh = jmkgraph(jl, jtm2, jG)
    th = tmkgraph(tl, ttm2, tG)
    assert th.num_states == jh.num_states > 0
    assert _arcs(th) == _arcs(jh)


def test_lda_and_compose_transforms_equal():
    rng = np.random.default_rng(5)
    D, N, C = 9, 800, 4
    centers = rng.standard_normal((C, D)) * 2
    classes = rng.integers(0, C, N)
    feats = centers[classes] + rng.standard_normal((N, D))
    j, t = jtr.LdaEstimate(C, D), ttr.LdaEstimate(C, D)
    j.accumulate_batch(feats, classes)
    t.accumulate_batch(feats, classes)
    j.accumulate(feats[0], 1, 0.5)
    t.accumulate(feats[0], 1, 0.5)
    np.testing.assert_array_equal(t.estimate(3), j.estimate(3))
    a = rng.standard_normal((3, 5))
    b = rng.standard_normal((5, D + 1))
    for b_aff in (True, False):
        bb = b if b_aff else b[:, :D]
        np.testing.assert_array_equal(
            ttr.compose_transforms(a, bb, b_is_affine=b_aff),
            jtr.compose_transforms(a, bb, b_is_affine=b_aff))


def _gmm_pair(rng, P=5, M=3, D=6):
    w = rng.dirichlet(np.ones(M), size=P)
    m = rng.standard_normal((P, M, D))
    v = 0.5 + rng.random((P, M, D))
    return jgmm.AmDiagGmm(w, m, v), tgmm.AmDiagGmm(w, m, v, device="cpu")


def test_mllt_matches_jax():
    rng = np.random.default_rng(6)
    jam, tam = _gmm_pair(rng)
    T = 500
    A = np.eye(6) + 0.4 * rng.standard_normal((6, 6))
    feats = (rng.standard_normal((T, 6)) @ A.T).astype(np.float32)
    pdfs = rng.integers(0, 5, T)
    j, t = jtr.MlltAccs(6), ttr.MlltAccs(6)
    post = rng.dirichlet(np.ones(3), size=T)
    for acc in (j, t):
        acc.accumulate(post, feats, jam.means[pdfs], 1.0 / jam.vars[pdfs])
    np.testing.assert_array_equal(t.G, j.G)
    (jM, jimpr), (tM, timpr) = j.update(), t.update()
    np.testing.assert_array_equal(tM, jM)
    assert timpr == jimpr > 0
    # through the model's posteriors (tri.estimate_mllt)
    tm = _IdTm(5)
    ali = {"a": list(range(1, T + 1))}
    jM, jimpr = jtri.estimate_mllt(jam, {"a": feats}, ali, tm)
    tM, timpr = ttri.estimate_mllt(tam, {"a": feats}, ali, tm)
    np.testing.assert_allclose(tM, jM, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(timpr, jimpr, rtol=1e-4)


class _IdTm:
    """tid t → pdf (t · 7) mod P: a stand-in transition model."""

    def __init__(self, P, T=2000):
        self.tid_to_pdf_array = (np.arange(T + 1) * 7) % P


@pytest.mark.parametrize("source", ["ali", "post"])
def test_fmllr_matches_jax(source):
    rng = np.random.default_rng(7)
    jam, tam = _gmm_pair(rng)
    T = 400
    pdfs = rng.integers(0, 5, T).astype(np.int32)
    comp = rng.integers(0, 3, T)
    clean = jam.means[pdfs, comp] + rng.standard_normal((T, 6)) * \
        np.sqrt(jam.vars[pdfs, comp])
    A = np.eye(6) + 0.2 * rng.standard_normal((6, 6))
    feats = (clean @ A.T + 0.5).astype(np.float32)
    j, t = jtr.FmllrAccs(6), ttr.FmllrAccs(6)
    if source == "ali":
        jtr.accumulate_fmllr_for_utt(j, jam, feats, pdfs)
        ttr.accumulate_fmllr_for_utt(t, tam, feats, pdfs)
    else:
        post = [[(int(p), 0.7), (int((p + 1) % 5), 0.3)] for p in pdfs]
        jtr.accumulate_fmllr_from_post(j, jam, feats, post)
        ttr.accumulate_fmllr_from_post(t, tam, feats, post)
    for name in ("K", "G"):
        want = getattr(j, name)
        np.testing.assert_allclose(getattr(t, name), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(t.beta, j.beta, rtol=1e-6)
    (jW, ji), (tW, ti) = j.update(min_count=10.0), t.update(min_count=10.0)
    np.testing.assert_allclose(tW, jW, rtol=1e-4, atol=1e-4)
    assert ti > 0 and abs(ti - ji) <= 1e-4 * abs(ji)
    # below min_count: identity on both sides
    np.testing.assert_array_equal(t.update(min_count=1e9)[0],
                                  j.update(min_count=1e9)[0])


def _lattice(Clat, Arc, rng):
    """A small seeded CompactLattice: 4 frames a word, two words a
    state, merging back."""
    c = Clat()
    for _ in range(6):
        c.add_state()
    c.start = 0
    for s in range(5):
        for k in range(2 if s < 4 else 1):
            nxt = min(5, s + 1 + k)
            c.arcs[s].append(Arc(int(rng.integers(1, 5)),
                                 float(rng.random() * 3),
                                 float(rng.random() * 20),
                                 tuple(int(x) for x in
                                       rng.integers(1, 30, 4 * (nxt - s))),
                                 nxt))
    c.finals[5] = (0.5, 0.0, ())
    return c


def test_frame_posteriors_equal():
    j = _lattice(JClat, JArc, np.random.default_rng(8))
    t = _lattice(TClat, TArc, np.random.default_rng(8))
    for scale in (1.0, 0.1):
        got = tlf.frame_posteriors(t, acoustic_scale=scale)
        want = jlf.frame_posteriors(j, acoustic_scale=scale)
        assert got == want
        assert all(abs(sum(p for _, p in fr) - 1.0) < 1e-9 for fr in got)
    assert tlf.state_times(t) == jlf.state_times(j)
