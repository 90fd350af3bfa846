"""The port's host decoders (kaldi_tpu_torch/decoder/simple.py,
decoder/biglm.py: numpy copies) against the JAX package's, mirroring
tests/test_biglm.py.  Each side builds its own task (lexicon, lang,
transition model, small and big LMs, HCLGs) with its own builders; the
same seeded log-likelihoods go through both packages' decoders.  Bars:
alignments and words equal, costs within 1e-5 relative; and the
original's property on the port: decoding the small-LM HCLG with the
difference LM equals SimpleDecoder on the big-LM HCLG (words equal,
cost within 1e-3).
"""

import importlib

import numpy as np
import pytest

from kaldi_tpu.decoder.biglm import BiglmDecoderConfig as JCfg
from kaldi_tpu.decoder.biglm import BiglmFasterDecoder as JBiglm
from kaldi_tpu.decoder.simple import SimpleDecoder as JSimple
from kaldi_tpu_torch.decoder import SimpleDecoder as TSimple
from kaldi_tpu_torch.decoder.biglm import BiglmDecoderConfig as TCfg
from kaldi_tpu_torch.decoder.biglm import BiglmFasterDecoder as TBiglm

TEXTS = [["ONE", "TWO"], ["TWO", "NINE"], ["NINE", "NINE"],
         ["ONE", "TWO", "NINE"], ["TWO", "NINE", "ONE"]]


def _task(pkg):
    topology = importlib.import_module(f"{pkg}.am.topology")
    tree = importlib.import_module(f"{pkg}.am.tree")
    transitions = importlib.import_module(f"{pkg}.am.transitions")
    fst = importlib.import_module(f"{pkg}.fst")
    arpa = importlib.import_module(f"{pkg}.fst.arpa")
    lex = fst.Lexicon([("ONE", ["w", "n"]), ("TWO", ["t", "u"]),
                       ("NINE", ["n", "ai", "n"])])
    lang = fst.Lang(lex)
    topo = topology.HmmTopology.three_state(lang.phone_list())
    tm = transitions.TransitionModel(
        topo, tree.MonophoneContextDependency(lang.phone_list(), topo))
    small = fst.ArpaModel.parse(fst.make_unigram_arpa(
        {"ONE": 1.0, "TWO": 1.0, "NINE": 1.0}))
    big = arpa.estimate_arpa(TEXTS, order=2)
    if isinstance(big, str):
        big = fst.ArpaModel.parse(big)
    return dict(lang=lang, tm=tm, small=small, big=big,
                small_g=fst.mkgraph(lang, tm, fst.arpa_to_fst(small,
                                                              lang.words)),
                big_g=fst.mkgraph(lang, tm, fst.arpa_to_fst(big,
                                                            lang.words)))


@pytest.fixture(scope="module")
def tasks():
    j, t = _task("kaldi_tpu"), _task("kaldi_tpu_torch")
    np.testing.assert_array_equal(j["tm"].tid_to_pdf_array,
                                  t["tm"].tid_to_pdf_array)
    return j, t


def _biglm(side, cls, cfg_cls, scale):
    cfg = cfg_cls(beam=1e9, max_active=10 ** 9, acoustic_scale=scale,
                  history_len=1)
    return cls(side["small_g"], side["tm"].tid_to_pdf_array,
               side["small"].score, side["big"].score, side["lang"].words,
               cfg)


def _same(got, want):
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == pytest.approx(want[2], rel=1e-5)


@pytest.mark.parametrize("trial", range(4))
def test_biglm_equals_jax_and_direct_big_graph(tasks, trial):
    j, t = tasks
    rng = np.random.default_rng(trial)
    T = 24 + 6 * trial
    ll = (rng.standard_normal((T, t["tm"].num_pdfs)) * 2.0).astype(
        np.float32)
    got = _biglm(t, TBiglm, TCfg, 0.2).decode(ll)
    _same(got, _biglm(j, JBiglm, JCfg, 0.2).decode(ll))
    oracle = TSimple(t["big_g"], acoustic_scale=0.2).decode(
        ll, t["tm"].tid_to_pdf_array)
    _same(oracle, JSimple(j["big_g"], acoustic_scale=0.2).decode(
        ll, j["tm"].tid_to_pdf_array))
    assert got[2] == pytest.approx(oracle[2], abs=1e-3)
    assert got[1] == oracle[1]


def test_biglm_prefers_big_lm_sequences(tasks):
    j, t = tasks
    ll = np.zeros((18, t["tm"].num_pdfs), np.float32)
    got = _biglm(t, TBiglm, TCfg, 0.0).decode(ll)
    _same(got, _biglm(j, JBiglm, JCfg, 0.0).decode(ll))
    wordseq = [t["lang"].words.find(o) for o in got[1]]
    pairs = set(zip(wordseq, wordseq[1:]))
    trained = {("ONE", "TWO"), ("TWO", "NINE"), ("NINE", "NINE"),
               ("NINE", "ONE")}
    assert not pairs or pairs <= trained


def test_biglm_pruned_equals_jax(tasks):
    """At a finite beam and max-active (FasterDecoder's cutoff) the
    pruned search is the original's too."""
    j, t = tasks
    rng = np.random.default_rng(7)
    ll = (rng.standard_normal((30, t["tm"].num_pdfs)) * 2.0).astype(
        np.float32)
    outs = []
    for side, cls, cfg_cls in ((t, TBiglm, TCfg), (j, JBiglm, JCfg)):
        cfg = cfg_cls(beam=4.0, max_active=6, acoustic_scale=0.2,
                      history_len=1)
        outs.append(cls(side["small_g"], side["tm"].tid_to_pdf_array,
                        side["small"].score, side["big"].score,
                        side["lang"].words, cfg).decode(ll))
    _same(*outs)


def test_simple_decoder_raises_without_tokens(tasks):
    """No path through the graph: both raise KaldiError."""
    from kaldi_tpu.core.logging import KaldiError as JErr
    from kaldi_tpu_torch.core.logging import KaldiError as TErr
    from kaldi_tpu.fst.fst import Arc as JArc, VectorFst as JFst
    from kaldi_tpu_torch.fst.fst import Arc as TArc, VectorFst as TFst
    for fst_cls, arc, simple, err in ((TFst, TArc, TSimple, TErr),
                                      (JFst, JArc, JSimple, JErr)):
        g = fst_cls()
        s0, s1 = g.add_state(), g.add_state()
        g.set_start(s0)
        g.add_arc(s0, arc(1, 0, 0.0, s1))
        g.set_final(s1, 0.0)
        with pytest.raises(err):
            simple(g).decode(np.zeros((2, 1), np.float32),
                             np.array([0, 0], np.int32))
