"""The GMM recipes of the PyTorch port against the JAX package: monophone
training, the yesno recipe and the mini_librispeech ladder (mono → tri1
→ tri2b (LDA+MLLT) → tri3b (SAT)), on the CPU (``device="cpu"``), at
small sizes.

* ``train_mono`` on the same features: the alignments equal at every
  realignment and the loglike per frame of every iteration within 1e-4
  relative (float32 accumulations in other orders).
* yesno end to end, each side on its own features (the port's MFCC
  within 2e-3 · lifter of the JAX one, tests/test_torch_features.py):
  the same WER and the same hypotheses.
* mini: fed the JAX package's base features (MFCC + CMVN), every stage's
  WER equals the JAX run's.  On its own features the port's mono and
  tri1 WERs equal the JAX run's, and the run keeps the recipe's exit
  rule (tri3b ≤ mono).  From tri2b on the two runs on their own features
  need not agree at this size: ``lda_dim`` 30 exceeds the rank (19) of
  the between-class scatter of tri1's 20 leaves, so rows 19–29 of the
  LDA are a basis of a degenerate eigenspace that rounding of the
  features (2.5e-4 apart) chooses.
* the ladder's chain rung (``ladder.chain_stage``, hidden 16, two
  epochs) on the JAX mini run's tri3b system, carried to the port as
  files and arrays, the port's trainer starting from the JAX trainer's
  initial weights (``params_from_flax``): equal egs, the final objf
  within 1e-3 relative (float32 training steps in other orders, the bar
  of tests/test_torch_chain_train.py's losses grown for the steps of
  two epochs) and the same WER (at this size both rungs still decode no
  word).  ``ladder.main`` and ``mini.main`` at tiny
  sizes return their exit rules' verdicts on the hard corpus they run.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.pipelines import ladder as jladder
from kaldi_tpu.pipelines import mini as jmini
from kaldi_tpu.pipelines import mono as jmono
from kaldi_tpu.pipelines import yesno as jyesno
from kaldi_tpu.pipelines import data as jdata
from kaldi_tpu.pipelines.data import make_synthetic_dataset as j_dataset
from kaldi_tpu.pipelines.data import yesno_lexicon as j_yesno_lexicon
from kaldi_tpu.fst import Lang as JLang
import kaldi_tpu.decoder.align as jalign
from kaldi_tpu_torch.fst import Lang as TLang
from kaldi_tpu_torch.ops.gmm import CudaGmm
from kaldi_tpu_torch.pipelines import data as tdata
from kaldi_tpu_torch.pipelines import ladder as tladder
from kaldi_tpu_torch.pipelines import mini as tmini
from kaldi_tpu_torch.pipelines import mono as tmono
from kaldi_tpu_torch.pipelines import yesno as tyesno

torch.set_num_threads(1)

MINI = dict(num_utts=12, num_test=4, quick=True, tri_leaves=20,
            tri_gauss=80, num_speakers=2, num_test_speakers=2)
MONO = dict(num_iters=4, totgauss=40, realign_iters=(1, 3))


def test_synthetic_corpus_is_the_same_bit_for_bit():
    for seed, kw in ((1, {}), (5, dict(noise=0.1, speaker_warp=0.05,
                                       coarticulation=0.2))):
        j = j_dataset(j_yesno_lexicon(), num_utts=5, max_words=4, seed=seed,
                      **kw)
        t = tdata.make_synthetic_dataset(tdata.yesno_lexicon(), num_utts=5,
                                         max_words=4, seed=seed, **kw)
        assert t.utts == j.utts and t.text == j.text
        assert t.utt2spk == j.utt2spk
        for u in j.utts:
            assert t.wavs[u][1] == j.wavs[u][1]
            np.testing.assert_array_equal(t.wavs[u][0], j.wavs[u][0])
    assert tdata.confusable_lexicon().entries == \
        jdata.confusable_lexicon().entries
    assert tdata.confusable_formants() == jdata.confusable_formants()


def _record_jax_alignments(monkeypatch):
    """The JAX aligner's batches and the JAX trainer's per-iteration
    loglike per frame, as they happen."""
    rec = {"ali": [], "ll": []}
    align_batch = jalign.DenseAligner.align_batch
    acc = jmono.accumulate_stats

    def align(self, graphs, lls):
        out = align_batch(self, graphs, lls)
        rec["ali"].append([t for t, _ in out])
        return out

    def accumulate(am, feats, pdfs, accs):
        tot = acc(am, feats, pdfs, accs)
        rec["ll"].append(tot / len(pdfs))
        return tot

    monkeypatch.setattr(jalign.DenseAligner, "align_batch", align)
    monkeypatch.setattr(jmono, "accumulate_stats", accumulate)
    return rec


def test_train_mono_matches_jax(monkeypatch):
    train = j_dataset(j_yesno_lexicon(), num_utts=6, max_words=4, seed=1)
    feats = jyesno.make_feats(train)
    rec = _record_jax_alignments(monkeypatch)
    jm = jmono.train_mono(feats, train.text, JLang(j_yesno_lexicon()),
                          jmono.MonoTrainConfig(**MONO))
    got = {"ali": [], "ll": []}

    def report(it, ali, accs):
        got["ll"].append(accs.tot_like / accs.tot_frames)
        if it in MONO["realign_iters"]:
            got["ali"].append([ali[u] for u in sorted(ali)])

    n0 = CudaGmm.total_launches
    tm = tmono.train_mono(feats, train.text, TLang(tdata.yesno_lexicon()),
                          tmono.MonoTrainConfig(**MONO), device="cpu",
                          report=report)
    assert CudaGmm.total_launches == n0        # the plain version on the CPU
    assert len(got["ali"]) == len(rec["ali"]) == 2
    for g, w in zip(got["ali"], rec["ali"]):
        assert g == w
    np.testing.assert_allclose(got["ll"], rec["ll"], rtol=1e-4)
    assert tm.am.num_gauss() == jm.am.num_gauss()
    np.testing.assert_allclose(tm.am.means, jm.am.means, rtol=1e-3,
                               atol=1e-3)


def test_yesno_recipe_matches_jax():
    kw = dict(num_utts=8, num_test=6, num_iters=4, totgauss=40)
    want = jyesno.run(**kw)
    got = tyesno.run(device="cpu", **kw)
    assert got.wer.wer == want.wer.wer
    assert got.hyps == want.hyps
    assert tyesno.main(["--num-utts=4", "--num-iters=2", "--totgauss=20",
                        "--device=cpu"]) in (0, 1)


@pytest.fixture(scope="module")
def jax_mini_systems():
    return jmini.run(return_systems=True, **MINI)


@pytest.fixture(scope="module")
def jax_mini(jax_mini_systems):
    return jax_mini_systems[0]


def _wers(w):
    return {k: v.wer for k, v in w.items()}


@pytest.fixture(scope="module")
def port_mini_on_jax_features():
    """The port's mini run on the JAX package's base features (MFCC +
    CMVN): its WERs, systems and the stages its report saw."""
    def base(data, samp_freq=8000.0, device="cuda"):
        return {u: np.asarray(f, np.float32)
                for u, f in jmini.base_feats(data, samp_freq).items()}

    stages = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmini, "base_feats", base)
        got, sysd = tmini.run(device="cpu", return_systems=True,
                              report=lambda s, *_: stages.append(s), **MINI)
    return got, sysd, stages


def test_mini_ladder_matches_jax_on_the_same_features(
        jax_mini, port_mini_on_jax_features):
    got, _, stages = port_mini_on_jax_features
    assert list(got) == ["mono", "tri1", "tri2b", "tri3b"]
    assert _wers(got) == _wers(jax_mini)
    assert sorted(set(stages)) == ["mono", "tri1", "tri2b", "tri2b+mllt",
                                   "tri3b"]


def test_mini_ladder_on_its_own_features(jax_mini):
    got = _wers(tmini.run(device="cpu", **MINI))
    want = _wers(jax_mini)
    assert got["mono"] == want["mono"] and got["tri1"] == want["tri1"]
    assert got["tri3b"] <= got["mono"]


LADDER_CHAIN = dict(order=3, num_epochs=2, hidden=16)


def _port_systems(jsys, tsys, path):
    """The JAX run's tri3b system as the port's chain rung reads it: its
    transition model through a .mdl file, its alignments and SAT
    features as arrays; the port run's Lang, test set and G (built from
    the same lexicon and seed)."""
    from kaldi_tpu.am.serialize import write_mdl as j_write_mdl
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.pipelines.tri import TriModel
    j3 = jsys["tri3b"]
    j_write_mdl(path, j3.tm, j3.am)
    tm, am = read_mdl(path, device="cpu")
    out = {k: tsys[k] for k in ("lang", "test", "G")}
    out["tri3b"] = TriModel(am, tm, tsys["lang"], tm.tree)
    out["tri3b_ali"] = {u: [int(t) for t in a]
                        for u, a in jsys["tri3b_ali"].items()}
    for k in ("sat_tr", "sat_te"):
        out[k] = {u: np.asarray(f, np.float32) for u, f in jsys[k].items()}
    return out


def test_ladder_chain_stage_matches_jax(jax_mini_systems,
                                        port_mini_on_jax_features,
                                        monkeypatch, tmp_path):
    """The chain rung on the JAX run's tri3b system (its model file,
    alignments and SAT features; the port's own tri3b alignments differ
    from it in a few frames: float32 GMM training in another order), the
    port's trainer from the JAX trainer's first weights."""
    import jax
    from kaldi_tpu_torch.am.tdnn import params_from_flax
    jsys = jax_mini_systems[1]
    tsys = _port_systems(jsys, port_mini_on_jax_features[1],
                         str(tmp_path / "tri3b.mdl"))
    rec = {}

    class JaxTrainer(jladder.ChainTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["init"] = jax.tree_util.tree_map(
                np.asarray, {"params": self.params,
                             "batch_stats": dict(self.batch_stats)})

        def train(self, egs, **kw):
            rec["jax_egs"] = np.asarray(egs.feats), np.asarray(egs.pdf_ali)
            rec["jax"] = super().train(egs, **kw)
            return rec["jax"]

    class PortTrainer(tladder.ChainTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.model.load_state_dict(params_from_flax(rec["init"]))

        def train(self, egs, **kw):
            rec["port_egs"] = np.asarray(egs.feats), np.asarray(egs.pdf_ali)
            return super().train(egs, **kw)

    monkeypatch.setattr(jladder, "ChainTrainer", JaxTrainer)
    monkeypatch.setattr(tladder, "ChainTrainer", PortTrainer)
    want = jladder.chain_stage(jsys, **LADDER_CHAIN)
    stats = {}
    got = tladder.chain_stage(tsys, device="cpu", stats=stats,
                              **LADDER_CHAIN)
    for a, b in zip(rec["port_egs"], rec["jax_egs"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    objf = float(rec["jax"]["objf"])
    assert np.isfinite(stats["objf"])
    assert abs(stats["objf"] - objf) <= 1e-3 * abs(objf)
    assert got.wer == want.wer and got.errors == want.errors


def _record_mini_runs(monkeypatch):
    """Record each ``mini.run`` call (``mini.main``'s and the ladder's):
    its keywords and WERs."""
    seen = []
    run = tmini.run

    def recording(**kw):
        out = run(**kw)
        seen.append((kw, out[0] if isinstance(out, tuple) else out))
        return out

    monkeypatch.setattr(tmini, "run", recording)
    return seen


def test_mini_main_runs_the_ladder_corpus(monkeypatch):
    seen = _record_mini_runs(monkeypatch)
    rc = tmini.main(["--num-utts=12", "--num-test=6", "--quick=true",
                     "--device=cpu"])
    (kw, wers), = seen
    assert kw["noise"] == 0.12 and kw["heldout_speakers"]
    assert kw["lexicon"].entries == tdata.confusable_lexicon().entries
    assert wers["mono"].wer > 0
    assert rc == (0 if wers["tri3b"].wer <= wers["mono"].wer else 1)


def test_ladder_main_exit_rule(monkeypatch):
    seen = _record_mini_runs(monkeypatch)
    rc = tladder.main(["--num-utts=12", "--num-test=6", "--chain-epochs=1",
                       "--device=cpu"])
    (kw, wers), = seen
    assert kw["return_systems"] and kw["num_speakers"] == 4
    ok = wers["mono"].wer > 0 and wers["tri3b"].wer <= wers["mono"].wer
    assert rc == (0 if ok else 1)
