"""The port's flagship LVCSR system (pipelines/flagship.py) against the
JAX package's, on the CPU at a tiny size.

* The corpus builders (``flagship_phones``, ``flagship_lexicon``,
  ``phrase_texts``, ``render_dataset``) equal the original's bit for
  bit.
* ``run`` end to end (mono → tri3b-SAT → left-biphone chain → chain +
  online i-vectors → 4-gram rescore → RNNLM rescore → MBR) at vocab 40,
  16 train / 2 test utterances, 400 LM sentences, one chain epoch,
  against JAX's ``run`` at its defaults (``with_ivector`` and
  ``with_rnnlm`` on).  Both are fed the JAX
  package's base features (MFCC + CMVN), as the mini ladder's test does,
  and both decode in batches of 2 (the batch size changes no result)
  at run's default arc budget, 4096 (a binding budget amplifies float32
  differences of the log-likelihoods through its cutoff).
  The trained models cross from the JAX run: each GMM stage's model as
  a ``.mdl`` file with its alignments, both chain models' weights
  in the order they were trained (``am/tdnn.py`` ``params_from_flax``)
  and the RNNLM's trained weights (``lm/rnnlm.py`` ``params_from_flax``).
  Training parity is held in tests/test_torch_{recipes,tri,gmm_train,
  chain_train,rnnlm}.py; here, at 6–12
  frames a Gaussian, mix-up's discrete choices amplify float32
  summation-order differences (two weights of 4/23 come out 0.17391304
  and 0.17391305, and the split heap breaks the tie the other way), so
  two trainings need not give the same model.  Everything between the
  trainings runs on the port's side: alignment, LDA, MLLT and its
  model transform, fMLLR, the alignment model, graphs, decodes, the
  two-pass fMLLR decode, the chain tree, den graph and egs, rescoring
  (the RNNLM's scorer included) and MBR, and the i-vector rung's UBM,
  extractor EM and online i-vectors (am/ivector.py in float64).  The
  records have the same rungs, graph sizes and chain leaves; the
  mono-GMM and tri3b-SAT rungs the same WER, oracle WER and density;
  the chain decode, the i-vector rung, the 4-gram rescore and MBR the
  same WERs; the RNNLM rung the reference's record keys, WER, oracle
  WER, LM scale and delta; the i-vector rung's augmented training
  features are the JAX run's to float32 rounding.
* ``build_chain_tree`` inside both runs: the same alignments in, the
  same tree out.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import kaldi_tpu.lm.rnnlm as jrnnlm
import kaldi_tpu.pipelines.chain as jchain
import kaldi_tpu.pipelines.hard as jhard
import kaldi_tpu.pipelines.mini as jmini
import kaldi_tpu.pipelines.mono as jmono
import kaldi_tpu.pipelines.tri as jtri
from kaldi_tpu.am.serialize import write_mdl as j_write_mdl
from kaldi_tpu.pipelines import flagship as jflag
import kaldi_tpu_torch.pipelines.chain as tchain
from kaldi_tpu_torch.am.serialize import read_mdl as t_read_mdl
from kaldi_tpu_torch.am.tdnn import params_from_flax
from kaldi_tpu_torch.lm import rnnlm as trnnlm
from kaldi_tpu_torch.pipelines import flagship as tflag
from kaldi_tpu_torch.pipelines.mono import MonoModel as TMonoModel
from kaldi_tpu_torch.pipelines.tri import TriModel as TTriModel

torch.set_num_threads(1)

SMALL = dict(vocab=40, train_utts=16, test_utts=2, lm_sents=400,
             chain_epochs=1, tri_leaves=40, arc_budget=4096,
             escalate_budget=0)


@pytest.mark.parametrize("kw", [dict(), dict(n_clusters=4, per_cluster=2)])
def test_flagship_phones_match_jax(kw):
    assert tflag.flagship_phones(**kw) == jflag.flagship_phones(**kw)


@pytest.mark.parametrize("vocab,seed", [(40, 11), (500, 3), (2000, 12)])
def test_flagship_lexicon_matches_jax(vocab, seed):
    got = tflag.flagship_lexicon(vocab, seed=seed)
    want = jflag.flagship_lexicon(vocab, seed=seed)
    assert got == want
    assert len(got[0]) == vocab


@pytest.mark.parametrize("kw", [dict(n_sents=50, seed=21, phrase_seed=8),
                                dict(n_sents=30, n_phrases=40, seed=5),
                                dict(n_sents=20, phrase_len=(2, 5),
                                     sent_phrases=(1, 3), seed=2,
                                     phrase_seed=9)])
def test_phrase_texts_match_jax(kw):
    words = [w for w, _ in jflag.flagship_lexicon(300, seed=4)[0]]
    assert tflag.phrase_texts(words, **kw) == jflag.phrase_texts(words, **kw)


def test_render_dataset_matches_jax_bit_for_bit():
    from kaldi_tpu.fst import Lexicon as JLexicon
    from kaldi_tpu_torch.fst import Lexicon as TLexicon
    entries, formants = jflag.flagship_lexicon(60, seed=11)
    sents = jflag.phrase_texts([w for w, _ in entries], 5, seed=3)
    args = (formants, sents, 3, "spk", 0.1, 0.12, 0.35, 51)
    want = jflag.render_dataset(JLexicon(list(entries)), *args)
    got = tflag.render_dataset(TLexicon(list(entries)), *args)
    assert got.utts == want.utts and got.text == want.text
    assert got.utt2spk == want.utt2spk
    for u in want.utts:
        assert got.wavs[u][1] == want.wavs[u][1]
        np.testing.assert_array_equal(got.wavs[u][0], want.wavs[u][0])


def _record_egs_feats(mp, module, rec):
    """Wrap ``module.make_chain_egs`` to keep the features of each call."""
    orig = module.make_chain_egs

    def make(feats, *args, **kw):
        rec.setdefault("egs_feats", []).append(
            {u: np.array(f, np.float32) for u, f in feats.items()})
        return orig(feats, *args, **kw)
    mp.setattr(module, "make_chain_egs", make)


def _record_tree(mp, module, rec):
    """Wrap ``module.build_chain_tree`` to keep its alignments and tree."""
    orig = module.build_chain_tree

    def build(feats, alignments, tm, topo, num_leaves, **kw):
        tree = orig(feats, alignments, tm, topo, num_leaves, **kw)
        rec["tree"] = (tree, topo, {u: list(a) for u, a in
                                    alignments.items()})
        return tree
    mp.setattr(module, "build_chain_tree", build)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's run at SMALL, recording its base features, each GMM stage's
    model (a .mdl file, written as the trainer returns it) and
    alignments, its chain tree's inputs and output, the features of each
    chain egs call, both trained chain models' weights, in order, and
    the trained RNNLM's weights and training arguments."""
    mdl_dir = tmp_path_factory.mktemp("flagship_mdl")
    rec = {"feats": {}, "gmm": [], "chain": []}

    def keep(model, ali, prev_ali):
        path = str(mdl_dir / f"stage{len(rec['gmm'])}.mdl")
        j_write_mdl(path, model.tm, model.am)
        rec["gmm"].append((path, ali, prev_ali))

    with pytest.MonkeyPatch.context() as mp:
        mono, tri = jmono.train_mono, jtri.train_tri

        def train_mono(*args, **kw):
            model = mono(*args, **kw)
            keep(model, None, None)
            return model

        def train_tri(feats, text, lang, prev, prev_ali, *args, **kw):
            model, ali = tri(feats, text, lang, prev, prev_ali, *args, **kw)
            keep(model, {u: list(a) for u, a in ali.items()},
                 {u: list(a) for u, a in prev_ali.items()})
            return model, ali

        mp.setattr(jmono, "train_mono", train_mono)
        mp.setattr(jtri, "train_tri", train_tri)
        base = jmini.base_feats

        def feats(data, samp_freq=8000.0):
            out = base(data, samp_freq)
            rec["feats"][tuple(data.utts)] = {
                u: np.array(f, np.float32) for u, f in out.items()}
            return out

        train = jchain.ChainTrainer.train

        def train_and_keep(self, egs, **kw):
            final = train(self, egs, **kw)
            rec["chain"].append(({"params": jax.tree_util.tree_map(
                np.asarray, self.params), "batch_stats":
                jax.tree_util.tree_map(np.asarray, dict(self.batch_stats))},
                final))
            return final

        mp.setattr(jmini, "base_feats", feats)
        mp.setattr(jchain.ChainTrainer, "train", train_and_keep)
        train_lm = jrnnlm.train_rnnlm

        def train_lm_and_keep(sents, cfg, **kw):
            params, model = train_lm(sents, cfg, **kw)
            rec["rnnlm"] = (jax.tree_util.tree_map(np.asarray, params),
                            cfg, [list(x) for x in sents], kw)
            return params, model

        mp.setattr(jrnnlm, "train_rnnlm", train_lm_and_keep)
        _record_tree(mp, jchain, rec)
        _record_egs_feats(mp, jchain, rec)
        mp.setattr(jhard, "decode_eval",
                   functools.partial(jhard.decode_eval, batch=2,
                                     bucket=32))
        results = jflag.run(**SMALL)
    return results, rec


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's run at SMALL on the JAX run's base features, each
    training stage returning the JAX run's model (read from its .mdl)
    and alignments, each chain training the JAX run's trained weights of
    the same rung, the RNNLM's training the JAX run's RNNLM (after
    checking it was asked for the same training)."""
    _, jrec = jax_run
    rec = {"prev_ali": []}
    stages = iter(jrec["gmm"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tflag, "base_feats",
                   lambda data, device="cuda": jrec["feats"][
                       tuple(data.utts)])

        def train_mono(feats, text, lang, config=None, device="cuda"):
            path, _, _ = next(stages)
            tm, am = t_read_mdl(path, device=device)
            return TMonoModel(am, tm, lang)

        def train_tri(feats, text, lang, prev, prev_ali, config=None,
                      device="cuda"):
            path, ali, want_prev = next(stages)
            rec["prev_ali"].append(
                ({u: list(a) for u, a in prev_ali.items()}, want_prev))
            tm, am = t_read_mdl(path, device=device)
            return TTriModel(am, tm, lang, tm.tree), ali

        mp.setattr(tflag, "train_mono", train_mono)
        mp.setattr(tflag, "train_tri", train_tri)

        chains = iter(jrec["chain"])

        def train_from_jax(self, egs, **kw):
            variables, final = next(chains)
            self.model.load_state_dict(params_from_flax(variables))
            return {"loss": float(final["loss"]),
                    "objf": float(final["objf"])}

        mp.setattr(tchain.ChainTrainer, "train", train_from_jax)

        def train_lm_from_jax(sents, cfg, device="cuda", stats=None, **kw):
            params, jcfg, jsents, jkw = jrec["rnnlm"]
            rec["rnnlm_args"] = ([list(x) for x in sents], cfg, kw,
                                 jsents, jcfg, jkw)
            model = trnnlm.RnnLm(cfg)
            model.load_state_dict(trnnlm.params_from_flax(params))
            stats.update(steps=0, nll=float("nan"), train_s=0.0)
            return model.to(device)

        mp.setattr(tflag, "train_rnnlm", train_lm_from_jax)
        _record_tree(mp, tflag, rec)
        _record_egs_feats(mp, tflag, rec)
        mp.setattr(tflag, "decode_eval",
                   functools.partial(tflag.decode_eval, batch=2,
                                     bucket=32))
        results = tflag.run(device="cpu", **SMALL)
    return results, rec


def test_stages_take_the_jax_runs_alignments(jax_run, port_run):
    """Each training stage of the port's run is handed the alignments
    the JAX run handed its own (the mono ones from the port's aligner on
    the carried mono model)."""
    assert len(port_run[1]["prev_ali"]) == len(jax_run[1]["gmm"]) - 1 == 4
    for got, want in port_run[1]["prev_ali"]:
        assert got == want


def test_run_has_the_same_rungs(jax_run, port_run):
    want, got = jax_run[0], port_run[0]
    assert [r["system"] for r in got] == [r["system"] for r in want] == [
        "mono-gmm", "tri3b-sat", "chain-tdnn", "chain-tdnn+ivec",
        "chain+4gram-rescore", "chain+rnnlm-rescore", "chain+4gram+mbr"]
    for g, w in zip(got, want):
        assert g["metric"] == w["metric"] == "flagship_results"
        assert g.get("graph_states") == w.get("graph_states")
    assert got[2]["chain_leaves"] == want[2]["chain_leaves"]
    assert got[2]["tree_context"] == "left-biphone"
    assert got[3]["ivector_dim"] == want[3]["ivector_dim"] == 16
    assert len(port_run[1]["egs_feats"]) == len(jax_run[1]["chain"]) == 2


@pytest.mark.parametrize("rung", [0, 1], ids=["mono-gmm", "tri3b-sat"])
def test_gmm_rungs_match_jax(jax_run, port_run, rung):
    want, got = jax_run[0][rung], port_run[0][rung]
    for k in ("wer", "oracle_wer", "density", "lm_scale"):
        assert got[k] == want[k], k
    assert got["oracle_wer"] <= got["wer"]


def test_chain_tree_matches_jax(jax_run, port_run):
    jtree, topo, jali = jax_run[1]["tree"]
    ttree, _, tali = port_run[1]["tree"]
    assert tali == jali
    assert ttree.num_pdfs == jtree.num_pdfs
    phones = list(topo.phones)
    for left in [0] + phones:
        for ph in phones:
            for pc in (0, 1):
                assert ttree.compute([left, ph], pc) == \
                    jtree.compute([left, ph], pc), (left, ph, pc)


@pytest.mark.parametrize("rung", [2, 4, 6], ids=["chain-tdnn",
                                                 "chain+4gram-rescore",
                                                 "chain+4gram+mbr"])
def test_chain_rungs_match_jax_with_its_weights(jax_run, port_run, rung):
    want, got = jax_run[0][rung], port_run[0][rung]
    assert got["wer"] == want["wer"]
    for k in ("oracle_wer", "map_wer", "lm_scale", "objf"):
        if k in want:
            assert got[k] == want[k], k


@pytest.mark.parametrize("key", ["wer", "oracle_wer", "lm_scale", "objf",
                                 "wer_delta_vs_no_ivec"])
def test_ivector_rung_matches_jax_with_its_weights(jax_run, port_run, key):
    """The chain-tdnn+ivec rung, decoded with the JAX run's second chain
    model on the port's i-vector-appended features, scores as the JAX
    run's."""
    want, got = jax_run[0][3], port_run[0][3]
    assert got["system"] == want["system"] == "chain-tdnn+ivec"
    assert want[key] is not None
    assert got[key] == want[key], key


def test_ivector_rung_features_match_jax(jax_run, port_run):
    """The second chain training's egs features (base features + 16
    online i-vector columns from the port's UBM, extractor EM and
    online_ivectors in float64) equal the JAX run's to float32 rounding
    (rtol 1e-6, atol 1e-6), and the first training's are the base
    features themselves."""
    jf, tf = jax_run[1]["egs_feats"], port_run[1]["egs_feats"]
    assert sorted(tf[1]) == sorted(jf[1])
    for u in jf[0]:
        np.testing.assert_array_equal(tf[0][u], jf[0][u])
    for u in jf[1]:
        assert tf[1][u].shape == jf[1][u].shape
        assert tf[1][u].shape[1] == jf[0][u].shape[1] + 16
        np.testing.assert_allclose(tf[1][u], jf[1][u], rtol=1e-6, atol=1e-6)
    # the i-vector columns are not all zero past the first period
    assert max(float(np.abs(f[10:, -16:]).max()) for f in tf[1].values()
               if f.shape[0] > 10) > 1e-3


def test_rnnlm_rung_is_trained_as_the_original(jax_run, port_run):
    """The port asks for the RNNLM the JAX run trained: the same
    sentences (the first 8000 of the LM text as word ids), config
    (vocab, E 96, H 192) and training arguments (12 epochs, B 64,
    lr 4e-3, K = min(512, V), the seed, <s> and </s>)."""
    sents, cfg, kw, jsents, jcfg, jkw = port_run[1]["rnnlm_args"]
    assert sents == jsents
    assert (cfg.vocab_size, cfg.embed_dim, cfg.hidden_dim) == \
        (jcfg.vocab_size, jcfg.embed_dim, jcfg.hidden_dim)
    assert (jcfg.embed_dim, jcfg.hidden_dim) == (96, 192)
    assert kw == jkw


@pytest.mark.parametrize("key", ["wer", "oracle_wer", "lm_scale",
                                 "wer_delta_vs_trigram"])
def test_rnnlm_rung_matches_jax_with_its_weights(jax_run, port_run, key):
    """The chain+rnnlm-rescore rung, rescoring the chain lattices with the
    JAX run's RNNLM through the port's scorer, scores as the JAX run's,
    under the same record keys."""
    want, got = jax_run[0][5], port_run[0][5]
    assert got["system"] == want["system"] == "chain+rnnlm-rescore"
    assert sorted(got) == sorted(want)
    assert got[key] == want[key], key
    assert got["oracle_wer"] <= got["wer"]
