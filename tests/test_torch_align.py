"""Training graphs and forced alignment in the PyTorch port against the
JAX package.

Each side builds its own Lang, TransitionModel and training graphs from
the same lexicon and transcripts (only numpy crosses).  The graph
compiler, the packers and ``equal_align`` are copies: equal arcs, equal
arrays, equal alignments.  ``DenseAligner`` runs on the CPU
(``device="cpu"``) on the SAME float32 log-likelihoods as the JAX one:
its float32 additions are the original's, in the same order, so the
tids are equal and the costs within 1e-4 relative (the reductions over
in-arcs may round differently).
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.am import HmmTopology as JTopo
from kaldi_tpu.am import MonophoneContextDependency as JMono
from kaldi_tpu.am import TransitionModel as JTM
from kaldi_tpu.core.logging import KaldiError as JKaldiError
from kaldi_tpu.decoder import align as jalign
from kaldi_tpu.decoder import training_graph as jtg
from kaldi_tpu.fst import Lang as JLang
from kaldi_tpu.fst import Lexicon as JLexicon
from kaldi_tpu_torch.am.topology import HmmTopology as TTopo
from kaldi_tpu_torch.am.transitions import TransitionModel as TTM
from kaldi_tpu_torch.am.tree import MonophoneContextDependency as TMono
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.decoder import align as talign
from kaldi_tpu_torch.decoder import training_graph as ttg
from kaldi_tpu_torch.fst.lang import Lang as TLang
from kaldi_tpu_torch.fst.lang import Lexicon as TLexicon

torch.set_num_threads(1)

# WON and ONE are homophones: their disambiguation symbols leave ε arcs
# in the training graphs
ENTRIES = [("ONE", ["W", "AH", "N"]), ("TWO", ["T", "UW"]),
           ("THREE", ["TH", "R", "IY"]), ("SIX", ["S", "IH", "K"]),
           ("WON", ["W", "AH", "N"])]
TEXTS = [["ONE"], ["TWO", "THREE"], ["SIX", "WON", "TWO"],
         ["THREE", "THREE"], ["TWO", "SIX", "ONE", "THREE"]]


def _side(Lexicon, Lang, Topo, Mono, TM):
    lang = Lang(Lexicon(entries=list(ENTRIES)))
    phones = lang.phone_list()
    topo = Topo.three_state(phones)
    tm = TM(topo, Mono(phones, topo))
    return lang, tm


@pytest.fixture(scope="module")
def sides():
    jl, jt = _side(JLexicon, JLang, JTopo, JMono, JTM)
    tl, tt = _side(TLexicon, TLang, TTopo, TMono, TTM)
    jc = jtg.TrainingGraphCompiler(jl, jt)
    tc = ttg.TrainingGraphCompiler(tl, tt)
    jg = [jc.compile_text(t) for t in TEXTS]
    tg = [tc.compile_text(t) for t in TEXTS]
    return jt, tt, jg, tg


def _arcs(fst):
    return ([[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate)
              for a in arcs] for arcs in fst.arcs],
            fst.start, sorted(fst.finals.items()))


def test_training_graphs_equal(sides):
    jt, tt, jg, tg = sides
    np.testing.assert_array_equal(tt.tid_to_pdf_array, jt.tid_to_pdf_array)
    for j, t in zip(jg, tg):
        assert _arcs(t) == _arcs(j)
    assert _arcs(ttg.linear_word_acceptor([3, 1, 2])) == \
        _arcs(jtg.linear_word_acceptor([3, 1, 2]))


def test_pack_dense_reverse_and_degrees_equal(sides):
    _, _, jg, tg = sides
    ae = max(jalign.in_degrees(g)[0] for g in jg)
    an = max(max(jalign.in_degrees(g)[1] for g in jg), 1)
    smax = max(g.num_states for g in jg)
    for j, t in zip(jg, tg):
        assert talign.in_degrees(t) == jalign.in_degrees(j)
        assert talign.degrees(t) == jalign.degrees(j)
        jr = jalign.pack_dense_reverse(j, smax, ae, an)
        tr = talign.pack_dense_reverse(t, smax, ae, an)
        for f in ("num_states", "start", "eps_depth"):
            assert getattr(tr, f) == getattr(jr, f)
        for f in ("e_src", "e_il", "e_w", "n_src", "n_w", "final"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
        jd = jalign.pack_dense(j, smax, 4, 4)
        td = talign.pack_dense(t, smax, 4, 4)
        for f in ("e_il", "e_ol", "e_w", "e_ns", "n_ol", "n_w", "n_ns",
                  "final"):
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    packed = talign.pack_training_graphs(tg)
    assert all(p.e_src.shape == (smax, ae) for p in packed)


@pytest.mark.parametrize("extra", [0, 7, 30])
def test_equal_align_equal(sides, extra):
    _, _, jg, tg = sides
    pron = dict(ENTRIES)
    for text, j, t in zip(TEXTS, jg, tg):
        # three states a phone: the fewest frames a path takes
        n = 3 * sum(len(pron[w]) for w in text) + extra
        assert ttg.equal_align(t, n) == jtg.equal_align(j, n)
    with pytest.raises(KaldiError, match="too short"):
        ttg.equal_align(tg[-1], 2)


def _loglikes(tm, lens, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, tm.num_pdfs)) * 3.0).astype(np.float32)
            for n in lens]


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_dense_aligner_matches_jax_on_a_ragged_batch(sides, scale):
    jt, tt, jg, tg = sides
    ae = max(jalign.in_degrees(g)[0] for g in jg)
    an = max(max(jalign.in_degrees(g)[1] for g in jg), 1)
    smax = max(g.num_states for g in jg)
    jd = [jalign.pack_dense_reverse(g, smax, ae, an) for g in jg]
    td = talign.pack_training_graphs(tg)
    assert max(g.eps_depth for g in td) >= 1
    lls = _loglikes(tt, [37, 52, 61, 44, 90], 3)
    want = jalign.DenseAligner(jt.tid_to_pdf_array, scale).align_batch(
        jd, lls)
    # numpy and tensor log-likelihoods alike
    for inp in (lls, [torch.from_numpy(x) for x in lls]):
        got = talign.DenseAligner(tt.tid_to_pdf_array, scale,
                                  device="cpu").align_batch(td, inp)
        for (gt, gc), (wt, wc) in zip(got, want):
            assert gt == wt
            np.testing.assert_allclose(gc, wc, rtol=1e-4)
    # each utterance alone gives its own batch's answer
    solo = talign.DenseAligner(tt.tid_to_pdf_array, scale, device="cpu")
    assert solo.align_batch(td[2:3], lls[2:3])[0][0] == want[2][0]


def test_dense_aligner_no_path_raises(sides):
    """An utterance shorter than its transcript's fewest frames has no
    path: both raise, naming it."""
    jt, tt, jg, tg = sides
    ae = max(jalign.in_degrees(g)[0] for g in jg[3:5])
    an = max(max(jalign.in_degrees(g)[1] for g in jg[3:5]), 1)
    smax = max(g.num_states for g in jg[3:5])
    jd = [jalign.pack_dense_reverse(g, smax, ae, an) for g in jg[3:5]]
    lls = _loglikes(tt, [40, 2], 5)
    with pytest.raises(JKaldiError, match="no path for utterance 1"):
        jalign.DenseAligner(jt.tid_to_pdf_array).align_batch(jd, lls)
    with pytest.raises(KaldiError, match="no path for utterance 1"):
        talign.DenseAligner(tt.tid_to_pdf_array, device="cpu").align_batch(
            talign.pack_training_graphs(tg[3:5]), lls)
