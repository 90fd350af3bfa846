"""The port's file-based recipe (kaldi_tpu_torch/pipelines/wav_recipe.py)
against the JAX package's (kaldi_tpu/pipelines/wav_recipe.py), on the CPU.

A module fixture runs each package's recipe through its ``main`` at the
same size (12 / 10 utterances, 5 iterations), each in a work dir of its
own; the port's with ``--device=cpu``.  Then:

* the data dirs and their .wav files are equal byte for byte (the scp
  tables after the work dir's own path is taken out);
* the raw MFCC archives agree at the MFCC parity bar of
  tests/test_torch_features.py (log-mel 2e-3, the DCT keeps it, the
  lifter scales cepstrum k by its coefficient; the energy column 1e-4),
  the CMVN stats' frame counts exactly and their sums within that bar
  summed over the frames, and the final features (mean-normalized, with
  Δ and ΔΔ) within twice the bar of their column (the mean's error adds
  at most the bar once more; the Δ and ΔΔ windows' weights sum to less
  than 1 in absolute value);
* the trained final.mdl has the same transition model (log-probs
  within 1e-3) and the same Gaussians a pdf, and each pdf's mixture has
  its mean and second moment within 1e-3 (tests/test_torch_recipes.py's
  bar for ``train_mono``; its Gaussians one by one need not agree: where
  mix-up splits a pdf into near-equal halves, EM on features 1e-4 apart
  shares the frames between them differently, 0.6 apart in a mean with
  the mixture's moments 2e-5 apart), and both decodes give the same
  words (WER 0: each ``main`` exits 0);
* chain_recipe.py's ``gmm_alignments`` (the port's batched DenseAligner
  and ``realign``) on the JAX recipe's final.mdl and training features
  equals the reference's alignments exactly.
"""

import os
import types

import numpy as np
import pytest
import torch

from kaldi_tpu.am import serialize as jser
from kaldi_tpu.core.table import SequentialTableReader as JReader
from kaldi_tpu.fst import Lang as JLang
from kaldi_tpu.pipelines import chain_recipe as jchain_recipe
from kaldi_tpu.pipelines import wav_recipe as jwav
from kaldi_tpu.pipelines.data import yesno_lexicon as j_yesno_lexicon
from kaldi_tpu_torch.am import serialize as tser
from kaldi_tpu_torch.features.compute import compute_lifter_coeffs
from kaldi_tpu_torch.fst import Lang as TLang
from kaldi_tpu_torch.pipelines import chain_recipe as tchain_recipe
from kaldi_tpu_torch.pipelines import wav_recipe as twav
from kaldi_tpu_torch.pipelines.data import yesno_lexicon as t_yesno_lexicon
from kaldi_tpu_torch.pipelines.datadir import read_data_dir

torch.set_num_threads(1)

ARGV = ["--num-utts=12", "--num-iters=5"]
NUM_CEPS, LIFTER = 10, 22.0          # make_mfcc's MFCC (lifter: default)
DATA_FILES = ("wav.scp", "text", "utt2spk", "spk2utt", "feats.scp",
              "cmvn.scp")


@pytest.fixture(scope="module")
def works(tmp_path_factory):
    """Both recipes run through their ``main`` → (port dir, JAX dir)."""
    root = tmp_path_factory.mktemp("wav_recipe")
    t, j = str(root / "port"), str(root / "jax")
    assert twav.main([f"--work-dir={t}", "--device=cpu"] + ARGV) == 0
    assert jwav.main([f"--work-dir={j}"] + ARGV) == 0
    return t, j


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _mats(scp):
    return {u: np.asarray(m) for u, m in JReader(f"scp:{scp}", holder="mat")}


def mfcc_bar():
    """Per-column bar of the raw MFCC (tests/test_torch_features.py)."""
    bar = 2e-3 * compute_lifter_coeffs(LIFTER, NUM_CEPS).astype(np.float64)
    bar[0] = 1e-4
    return bar


@pytest.mark.parametrize("name", ["train", "test"])
def test_data_dirs_and_wavs_equal_jax(works, name):
    t, j = works
    td, jd = (os.path.join(w, "data", name) for w in works)
    for f in DATA_FILES:
        got = _read(os.path.join(td, f)).replace(t.encode(), b"<work>")
        want = _read(os.path.join(jd, f)).replace(j.encode(), b"<work>")
        assert got == want, f
    wavs = read_data_dir(td).wav_scp
    assert len(wavs) == (12 if name == "train" else 10)
    for u, path in wavs.items():
        assert _read(path) == _read(path.replace(t, j)), u
        assert _read(path)[:4] == b"RIFF"


@pytest.mark.parametrize("name", ["train", "test"])
def test_features_match_jax(works, name):
    t, j = works
    bar = mfcc_bar()
    got, want = (_mats(os.path.join(w, "mfcc", f"raw_mfcc_{name}.scp"))
                 for w in works)
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].shape == want[u].shape
        assert (np.abs(got[u] - want[u]) <= bar).all(), \
            (u, np.abs(got[u] - want[u]).max(0))
    # per-speaker CMVN stats: counts exact; the sums within the bar times
    # the frames summed (squares: |x² − y²| ≤ |x − y| (2|y| + |x − y|))
    gs, ws = (_mats(os.path.join(w, "mfcc", f"cmvn_{name}.scp"))
              for w in works)
    spk = read_data_dir(os.path.join(j, "data", name)).utt2spk
    assert sorted(gs) == sorted(ws)
    for s, w in ws.items():
        g = gs[s]
        assert g[0, -1] == w[0, -1]
        x = np.concatenate([want[u] for u in sorted(want) if spk[u] == s])
        assert len(x) == w[0, -1]
        assert (np.abs(g[0, :-1] - w[0, :-1]) <= len(x) * bar).all(), s
        sq = (bar * (2 * np.abs(x) + bar)).sum(0)
        assert (np.abs(g[1, :-1] - w[1, :-1]) <= sq * (1 + 1e-6)).all(), s
    got, want = (_mats(os.path.join(w, "mfcc", f"final_{name}.scp"))
                 for w in works)
    fbar = 2 * np.tile(bar, 3)
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].shape == want[u].shape == (len(want[u]), 3 * NUM_CEPS)
        assert (np.abs(got[u] - want[u]) <= fbar).all(), \
            (u, np.abs(got[u] - want[u]).max(0))


def test_model_and_decode_match_jax(works):
    mdl = [os.path.join(w, "exp", "mono", "final.mdl") for w in works]
    (ttm, tam), (jtm, jam) = (tser.read_mdl(m, device="cpu") for m in mdl)
    assert ttm.tuples == jtm.tuples
    np.testing.assert_array_equal(ttm.tid_to_pdf_array, jtm.tid_to_pdf_array)
    np.testing.assert_allclose(ttm.log_probs, jtm.log_probs, rtol=1e-3,
                               atol=1e-3)
    assert tam.num_gauss() == jam.num_gauss()
    np.testing.assert_array_equal((tam.weights > 0).sum(1),
                                  (jam.weights > 0).sum(1))
    for am in (tam, jam):
        np.testing.assert_allclose(am.weights.sum(1), 1.0, rtol=1e-6)

    def moments(am):
        w = am.weights[..., None]
        return ((w * am.means).sum(1),
                (w * (am.vars + am.means ** 2)).sum(1))

    for got, want in zip(moments(tam), moments(jam)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    tras = [dict(JReader(f"ark,t:{w}/exp/mono/decode_test/tra.1.txt",
                         holder="text")) for w in works]
    assert tras[0] == tras[1] and len(tras[0]) == 10
    for w in works:
        for f in ("exp/mono/graph/HCLG.fst", "exp/mono/decode_test/lat.1.ark"):
            assert os.path.getsize(os.path.join(w, f)) > 0, (w, f)


def test_gmm_alignments_equal_jax(works):
    """chain_recipe's gmm_alignments: the port's one batched alignment on
    the JAX recipe's model and training features equals the reference's
    tid for tid."""
    j = works[1]
    mdl = os.path.join(j, "exp", "mono", "final.mdl")
    feats = _mats(os.path.join(j, "mfcc", "final_train.scp"))
    text = read_data_dir(os.path.join(j, "data", "train")).text
    want = jchain_recipe.gmm_alignments(
        types.SimpleNamespace(**dict(zip(("tm", "am"), jser.read_mdl(mdl)))),
        feats, text, JLang(j_yesno_lexicon()))
    got = tchain_recipe.gmm_alignments(
        types.SimpleNamespace(**dict(zip(("tm", "am"),
                                         tser.read_mdl(mdl, device="cpu")))),
        feats, text, TLang(t_yesno_lexicon()), device="cpu")
    assert sorted(got) == sorted(want) == sorted(feats)
    for u in want:
        assert len(want[u]) == len(feats[u])
        assert list(got[u]) == list(want[u]), u
