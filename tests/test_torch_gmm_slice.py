"""The port's GMM decode slice against the JAX package, from disk.

A module fixture runs kaldi_tpu/pipelines/wav_recipe.py at
tests/test_wav_recipe.py's size: RIFF wavs → compute-mfcc-feats → CMVN
→ Δ+ΔΔ → mono training → final.mdl, a binary HCLG.fst and the JAX
``gmm-latgen-faster`` decode.  The port then reads those artifacts:
``read_mdl`` must give bit-equal parameters, its log-likelihoods agree
at 1e-4, and its ``gmm-latgen-faster`` (both decoder branches) gives the
same words with costs within 1e-3 from the same feature archive (the
log-likelihoods differ at ~1e-5; a path sums a few hundred of them at
acoustic scale 0.1).  Features the port computes from the .wav files
differ from the archive's at ~1e-4, so that decode is held to the
recipe's own contract instead: WER 0.  The files cross between the
packages; each side reads them, and builds its lexicon, with its own
modules.  The port runs on the CPU (``device="cpu"``).
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.am import serialize as jser
from kaldi_tpu.cli import TOOLS
from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.core.table import SequentialTableReader
from kaldi_tpu.fst import Lang
from kaldi_tpu.pipelines import decode as jdecode
from kaldi_tpu.pipelines import wav_recipe
from kaldi_tpu.pipelines.data import yesno_lexicon
from kaldi_tpu.pipelines.datadir import read_data_dir
from kaldi_tpu_torch.am import serialize as tser
from kaldi_tpu_torch.cli import latgen as tlatgen
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.table import \
    SequentialTableReader as TSequentialTableReader
from kaldi_tpu_torch.fst import Lang as TLang
from kaldi_tpu_torch.fst import Lexicon as TLexicon
from kaldi_tpu_torch.features import (DeltaFeaturesOptions, MelBanksOptions,
                                      Mfcc, MfccOptions, add_deltas,
                                      apply_cmvn, compute_cmvn_stats,
                                      sum_cmvn_stats)
from kaldi_tpu_torch.features.window import FrameExtractionOptions
from kaldi_tpu_torch.pipelines import decode as tdecode
from kaldi_tpu_torch.pipelines.score import compute_wer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("gmm_slice") / "wavwork")
    wer = wav_recipe.run(work, num_utts=12, num_test=6, num_iters=5,
                         totgauss=60)
    assert wer.wer == 0.0
    exp = os.path.join(work, "exp", "mono")
    paths = dict(
        work=work, mdl=os.path.join(exp, "final.mdl"),
        fst=os.path.join(exp, "graph", "HCLG.fst"),
        words=os.path.join(exp, "graph", "words.txt"),
        feats=os.path.join(work, "mfcc", "final_test.scp"),
        lat=os.path.join(exp, "decode_test", "lat.1.ark"),
        tra=os.path.join(exp, "decode_test", "tra.1.txt"),
        test=os.path.join(work, "data", "test"))
    feats = {u: np.asarray(m) for u, m in SequentialTableReader(
        f"scp:{paths['feats']}", holder="mat")}
    return paths, feats


def _best_paths(lat_ark, reader=SequentialTableReader):
    return {u: clat.best_path() for u, clat in
            reader(f"ark:{lat_ark}", holder="clat")}


def _port_lang():
    """The port's Lang of the recipe's lexicon."""
    return TLang(TLexicon(entries=yesno_lexicon().entries))


def test_read_mdl_matches_jax(recipe, tmp_path):
    paths, _ = recipe
    jtm, jam = jser.read_mdl(paths["mdl"])
    ttm, tam = tser.read_mdl(paths["mdl"], device="cpu")
    np.testing.assert_array_equal(ttm.tid_to_pdf_array, jtm.tid_to_pdf_array)
    np.testing.assert_array_equal(ttm.log_probs, jtm.log_probs)
    for name in ("weights", "means", "vars"):
        got, want = getattr(tam, name), getattr(jam, name)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert tam.num_gauss() == jam.num_gauss() > tam.num_pdfs
    # the port's writer gives the JAX writer's bytes for the models
    # each read, and the JAX package reads them back
    out, ref = str(tmp_path / "port.mdl"), str(tmp_path / "jax.mdl")
    tser.write_mdl(out, ttm, tam)
    jser.write_mdl(ref, jtm, jam)
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(jser.read_mdl(out)[1].means, jam.means)


def test_am_loglikes_match_jax_on_recipe_model(recipe):
    paths, feats = recipe
    _, jam = jser.read_mdl(paths["mdl"])
    _, tam = tser.read_mdl(paths["mdl"], device="cpu")
    for u in sorted(feats)[:3]:
        want = np.asarray(jam.loglikes(feats[u]))
        got = tam.loglikes(feats[u]).numpy()
        assert np.std(want) > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _same_decodes(got, want):
    assert sorted(got) == sorted(want)
    for u in want:
        gw, _, gc = got[u]
        ww, _, wc = want[u]
        assert gw == ww, u
        assert abs(gc - wc) < 1e-3, (u, gc, wc)


def test_latgen_cli_matches_jax(recipe, tmp_path):
    """The dense branch (the recipe's graph is far below 20,000
    states), through the port's CLI on the CPU."""
    paths, _ = recipe
    lat = str(tmp_path / "lat.ark")
    tra = str(tmp_path / "tra.txt")
    rc = tlatgen.gmm_latgen_faster([
        "--device=cpu", "--beam=16.0", "--acoustic-scale=0.1",
        f"--word-symbol-table={paths['words']}", paths["mdl"], paths["fst"],
        f"scp:{paths['feats']}", f"ark:{lat}", f"ark,t:{tra}"])
    assert rc == 0
    _same_decodes(_best_paths(lat, TSequentialTableReader),
                  _best_paths(paths["lat"]))
    with open(tra) as a, open(paths["tra"]) as b:
        assert a.read() == b.read()


def test_latgen_beam_branch_matches_jax(recipe):
    """``dense_limit=0`` sends the same graph to the BeamDecoder on both
    sides (the CLI has no option for it)."""
    paths, feats = recipe
    jtm, jam = jser.read_mdl(paths["mdl"])
    ttm, tam = tser.read_mdl(paths["mdl"], device="cpu")
    kw = dict(max_active=7000, dense_limit=0)
    jdec = jtools._LatgenDecoder(jtools._load_hclg(paths["fst"]),
                                 jtm.tid_to_pdf_array, 16.0, 6.0, 0.1, **kw)
    tdec = tlatgen._LatgenDecoder(tlatgen._load_hclg(paths["fst"]),
                                  ttm.tid_to_pdf_array, 16.0, 6.0, 0.1,
                                  device="cpu", **kw)
    assert tdec._compact and jdec._compact
    utts = sorted(feats)[:3]
    got = {u: tdec.decode_to_clat(tam.loglikes(feats[u])).best_path()
           for u in utts}
    want = {u: jdec.decode_to_clat(
        np.asarray(jam.loglikes(feats[u]))).best_path() for u in utts}
    _same_decodes(got, want)
    assert all(got[u][0] for u in utts)


def test_decode_gmm_pipelines_match_jax(recipe):
    paths, feats = recipe
    jtm, jam = jser.read_mdl(paths["mdl"])
    ttm, tam = tser.read_mdl(paths["mdl"], device="cpu")
    jHCLG = jtools._load_hclg(paths["fst"])
    HCLG = tlatgen._load_hclg(paths["fst"])
    jlang, lang = Lang(yesno_lexicon()), _port_lang()
    refs = read_data_dir(paths["test"]).text
    want = jdecode.decode_gmm_lattice(feats, jam, jtm, jHCLG, jlang,
                                      refs=refs)
    got = tdecode.decode_gmm_lattice(feats, tam, ttm, HCLG, lang, refs=refs,
                                     device="cpu")
    assert got.hyps == want.hyps and got.alignments == want.alignments
    for u in want.costs:
        assert abs(got.costs[u] - want.costs[u]) < 1e-3
    assert got.wer.wer == want.wer.wer == 0.0
    want1 = jdecode.decode_gmm(feats, jam, jtm, jHCLG, jlang, batch_size=4)
    got1 = tdecode.decode_gmm(feats, tam, ttm, HCLG, lang, batch_size=4,
                              device="cpu")
    assert got1.hyps == want1.hyps and got1.alignments == want1.alignments
    for u in want1.costs:
        assert abs(got1.costs[u] - want1.costs[u]) < 1e-3


def test_port_features_from_wavs_decode_with_wer0(recipe):
    """wav files → the port's MFCC (the recipe's options) → per-speaker
    CMVN → Δ+ΔΔ → the port's decode: WER 0, the recipe's contract."""
    paths, feats = recipe
    d = read_data_dir(paths["test"])
    mfcc = Mfcc(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
        mel_opts=MelBanksOptions(num_bins=15), num_ceps=10), device="cpu")
    raw = {}
    for u, (wave, rate) in TSequentialTableReader(
            f"scp:{os.path.join(paths['test'], 'wav.scp')}", holder="wav"):
        assert rate == 8000
        raw[u] = mfcc.compute(wave)
    spk = {s: sum_cmvn_stats([compute_cmvn_stats(raw[u]) for u in us])
           for s, us in d.spk2utt().items()}
    port = {u: add_deltas(apply_cmvn(raw[u], spk[d.utt2spk[u]]),
                          DeltaFeaturesOptions()).numpy() for u in raw}
    for u in feats:
        assert port[u].shape == feats[u].shape
        np.testing.assert_allclose(port[u], feats[u], atol=5e-3, rtol=0)
    ttm, tam = tser.read_mdl(paths["mdl"], device="cpu")
    res = tdecode.decode_gmm_lattice(
        port, tam, ttm, tlatgen._load_hclg(paths["fst"]), _port_lang(),
        beam=16.0, lattice_beam=6.0, refs=d.text, device="cpu")
    assert res.wer.wer == 0.0
    assert compute_wer(d.text, res.hyps).wer == 0.0


def test_latgen_cli_usage():
    """Wrong argument counts print the usage and return 1; an unknown
    option is refused, as by the JAX tool's ParseOptions."""
    assert "gmm-latgen-faster" in TOOLS
    assert tlatgen.gmm_latgen_faster(["--device=cpu", "only.mdl"]) == 1
    with pytest.raises(KaldiError, match="Unknown option"):
        tlatgen.gmm_latgen_faster(["--no-such-option=1", "a", "b", "c", "d"])
