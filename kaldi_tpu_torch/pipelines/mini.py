"""Port of kaldi_tpu/pipelines/mini.py: the multi-stage GMM recipe, mono →
tri1 (deltas) → tri2b (LDA+MLLT) → tri3b (SAT/fMLLR), runnable as a
module:

    python -m kaldi_tpu_torch.pipelines.mini [--device=cuda]

Parity target egs/mini_librispeech/s5/run.sh's stage flow
('mini_librispeech tri3b (LDA+MLLT+SAT) decode'), on the synthetic corpus with a larger lexicon
than yesno.  MFCC (the fbank kernel), CMVN, deltas, splicing and the
feature transforms run on ``device`` (the transforms in float64, as the
original's numpy products), the features then stay on the host as the
trainers take them; training, alignment and decoding run on the
device.  The exit rule is the original's: tri3b WER ≤ mono WER.
``main`` runs it on the WER ladder's hard corpus (``ladder_corpus``),
where the rule can fail; the original's ``main`` runs ``run``'s easy
defaults, where mono already scores 0.00 and the original fails its own
rule whenever a later stage errs.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.decoder.align import DenseAligner, pack_training_graphs
from kaldi_tpu_torch.decoder.beam import BeamDecoderConfig
from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.features import (
    FrameExtractionOptions,
    MelBanksOptions,
    Mfcc,
    MfccOptions,
    add_deltas,
    splice_frames,
)
from kaldi_tpu_torch.am.transforms import apply_transform
from kaldi_tpu_torch.fst import ArpaModel, Lang, Lexicon, arpa_to_fst, \
    make_unigram_arpa, mkgraph
from kaldi_tpu_torch.fst.arpa import estimate_arpa
from kaldi_tpu_torch.lattice.functions import frame_posteriors
from kaldi_tpu_torch.pipelines.data import make_synthetic_dataset
from kaldi_tpu_torch.pipelines.decode import decode_gmm, decode_gmm_lattice
from kaldi_tpu_torch.pipelines.mono import (MonoTrainConfig, realign,
                                            train_mono)
from kaldi_tpu_torch.pipelines.tri import (
    TriTrainConfig,
    apply_mllt_to_model,
    estimate_alignment_model,
    estimate_fmllr_per_speaker,
    estimate_fmllr_per_speaker_post,
    estimate_lda,
    estimate_mllt,
    train_tri,
)
from kaldi_tpu_torch.pipelines.yesno import cmvn_per_speaker

log = get_logger(__name__)


def mini_lexicon() -> Lexicon:
    return Lexicon(entries=[
        ("ONE", ["W", "AH", "N"]),
        ("TWO", ["T", "UW"]),
        ("THREE", ["TH", "R", "IY"]),
        ("FOUR", ["F", "AO", "R"]),
        ("FIVE", ["F", "AY", "V"]),
        ("SIX", ["S", "IH", "K"]),
        ("SEVEN", ["S", "EH", "V", "AH", "N"]),
        ("EIGHT", ["EY", "T"]),
    ])


def base_feats(data, samp_freq=8000.0, device: torch.device | str = "cuda"):
    """MFCC + per-speaker CMVN on ``device`` → utt → (T, 10) float32
    numpy on the host."""
    mfcc = Mfcc(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=samp_freq, dither=0.0),
        mel_opts=MelBanksOptions(num_bins=15), num_ceps=10), device=device)
    raw = {u: mfcc.compute(data.wavs[u][0] * 32768.0) for u in data.utts}
    return {u: f.cpu().numpy()
            for u, f in cmvn_per_speaker(data, raw).items()}


def _on_device(feats: Dict[str, np.ndarray], fn, device
               ) -> Dict[str, np.ndarray]:
    """utt → fn(features on ``device``), back on the host."""
    return {u: fn(torch.from_numpy(f).to(device)).cpu().numpy()
            for u, f in feats.items()}


def _transform(feats: Dict[str, np.ndarray], mats, device
               ) -> Dict[str, np.ndarray]:
    """apply_transform of each utterance's matrix (``mats(u)``), in
    float64 on ``device``, rounded to float32 (the original's numpy
    product, then ``astype(np.float32)``)."""
    return {u: apply_transform(torch.from_numpy(f).to(device, torch.float64),
                               mats(u)).float().cpu().numpy()
            for u, f in feats.items()}


def run(num_utts: int = 60, num_test: int = 15, seed: int = 1,
        quick: bool = False, lexicon: Optional[Lexicon] = None,
        noise: float = 0.0, speaker_warp: float = 0.0,
        heldout_speakers: bool = False, formants=None,
        return_systems: bool = False,
        tri_leaves: Optional[int] = None,
        tri_gauss: Optional[int] = None,
        lda_dim: Optional[int] = None,
        coarticulation: float = 0.0,
        num_speakers: int = 4,
        num_test_speakers: int = 3,
        lm_order: int = 1,
        device: torch.device | str = "cuda",
        report=None):
    """The tri ladder.  noise/speaker_warp/heldout_speakers/formants
    make the corpus hard enough for NONZERO WER (pipelines/ladder.py);
    defaults reproduce the easy smoke corpus.  ``lm_order`` > 1
    estimates G from the TRAINING transcripts (the local/..._train_lms
    role) instead of the unigram grammar — at ≥100-word lexicons this
    gives the decoder real LM disambiguation work.  Everything runs on
    ``device``; ``report(stage, iteration, alignments, accs)`` is called
    after each training iteration of each stage."""
    device = resolve_device(device)
    timer = Timer()
    lex = lexicon or mini_lexicon()
    lang = Lang(lex)
    train = make_synthetic_dataset(lex, num_utts=num_utts, max_words=5,
                                   num_speakers=num_speakers, seed=seed,
                                   noise=noise, speaker_warp=speaker_warp,
                                   formants=formants,
                                   coarticulation=coarticulation)
    test = make_synthetic_dataset(
        lex, num_utts=num_test, max_words=5,
        num_speakers=num_test_speakers,
        seed=seed + 100, noise=noise, speaker_warp=speaker_warp,
        formants=formants, coarticulation=coarticulation,
        speaker_prefix="tspk" if heldout_speakers else "spk")
    base_tr = base_feats(train, device=device)
    base_te = base_feats(test, device=device)
    delta_tr = _on_device(base_tr, add_deltas, device)
    delta_te = _on_device(base_te, add_deltas, device)

    def stage_report(stage):
        if report is None:
            return None
        return lambda it, ali, accs: report(stage, it, ali, accs)

    if lm_order > 1:
        arpa = estimate_arpa([train.text[u] for u in train.utts],
                             order=lm_order, prune_count=1,
                             vocab=[w for w, _ in lex.entries])
        G = arpa_to_fst(arpa, lang.words)
    else:
        G = arpa_to_fst(ArpaModel.parse(make_unigram_arpa(
            {w: 1.0 for w, _ in lex.entries})), lang.words)
    dcfg = BeamDecoderConfig(beam=16.0, max_active=2000, acoustic_scale=0.1)
    wers = {}

    n_mono = 8 if quick else 14
    mono = train_mono(delta_tr, train.text, lang, MonoTrainConfig(
        num_iters=n_mono, totgauss=150 if quick else 300,
        realign_iters=tuple(range(1, n_mono, 2))), device=device,
        report=stage_report("mono"))
    HCLG = mkgraph(lang, mono.tm, G)
    res = decode_gmm(delta_te, mono.am, mono.tm, HCLG, lang, dcfg,
                     refs=test.text, device=device)
    wers["mono"] = res.wer
    log.info("mono decode: %s (%.0fs)", res.wer, timer.elapsed())

    # alignments from mono for the tree
    compiler = TrainingGraphCompiler(lang, mono.tm)
    utts = sorted(delta_tr)
    dense = dict(zip(utts, pack_training_graphs(
        [compiler.compile_text(train.text[u]) for u in utts])))
    mono_ali = realign(mono.am, DenseAligner(mono.tm.tid_to_pdf_array,
                                             device=device),
                       dense, utts, delta_tr)

    # --- tri1: triphone tree on delta features.  Tree size must scale
    # with the corpus: on the hard heldout-speaker ladder a 100-leaf
    # tree over-splits (~120 utts of data) and tri1 regresses below
    # mono; a swept 30-leaf/600-gauss config beats mono decisively
    # (ladder passes tri_leaves=30), mirroring how Kaldi recipes tune
    # <num-leaves> <tot-gauss> per corpus in run.sh.  tcfg flows into
    # tri2b/tri3b below, so the whole tri ladder uses the scaled tree.
    tcfg = TriTrainConfig(
        num_iters=8 if quick else 15,
        totgauss=tri_gauss or (300 if quick else 600),
        num_leaves=tri_leaves or (60 if quick else 100),
        realign_iters=(1, 2, 4, 6) if quick else (1, 2, 4, 6, 8, 10, 12))
    if lda_dim is not None:
        tcfg.lda_dim = lda_dim
    tri1, tri1_ali = train_tri(delta_tr, train.text, lang, mono, mono_ali,
                               tcfg, device=device,
                               report=stage_report("tri1"))
    HCLG1 = mkgraph(lang, tri1.tm, G)
    res = decode_gmm(delta_te, tri1.am, tri1.tm, HCLG1, lang, dcfg,
                     refs=test.text, device=device)
    wers["tri1"] = res.wer
    log.info("tri1 decode: %s (%.0fs)", res.wer, timer.elapsed())

    # --- tri2b: LDA+MLLT on spliced base features
    sl, sr = 3, 3
    def splice(f):
        return splice_frames(f, sl, sr)

    spl_tr = _on_device(base_tr, splice, device)
    spl_te = _on_device(base_te, splice, device)
    lda = estimate_lda(spl_tr, tri1_ali, tri1.tm, tcfg.lda_dim)
    lda_tr = _transform(spl_tr, lambda u: lda, device)
    lda_te = _transform(spl_te, lambda u: lda, device)
    tri2b, tri2b_ali = train_tri(lda_tr, train.text, lang, tri1, tri1_ali,
                                 tcfg, device=device,
                                 report=stage_report("tri2b"))
    # MLLT estimation + model transform, then RETRAIN on the rotated
    # features (a coarse-grained version of steps/train_lda_mllt.sh's
    # interleaved MLLT rounds — one post-hoc round without retraining
    # left the model mismatched to the transformed feature space)
    M, impr = estimate_mllt(tri2b.am, lda_tr, tri2b_ali, tri2b.tm)
    mllt_lda = np.concatenate([M @ lda[:, :-1], (M @ lda[:, -1:])], axis=1)
    lda_tr = _transform(spl_tr, lambda u: mllt_lda, device)
    lda_te = _transform(spl_te, lambda u: mllt_lda, device)
    apply_mllt_to_model(tri2b.am, M)
    tri2b, tri2b_ali = train_tri(lda_tr, train.text, lang, tri2b,
                                 tri2b_ali, tcfg, device=device,
                                 report=stage_report("tri2b+mllt"))
    tri2b.lda_mat = mllt_lda
    HCLG2 = mkgraph(lang, tri2b.tm, G)
    res = decode_gmm(lda_te, tri2b.am, tri2b.tm, HCLG2, lang, dcfg,
                     refs=test.text, device=device)
    wers["tri2b"] = res.wer
    log.info("tri2b decode: %s (%.0fs)", res.wer, timer.elapsed())

    # --- tri3b: SAT — per-speaker fMLLR on top of LDA+MLLT features
    fmllr = estimate_fmllr_per_speaker(
        tri2b.am, lda_tr, tri2b_ali, tri2b.tm,
        {u: train.utt2spk[u] for u in lda_tr}, min_count=50.0)
    dim = tcfg.lda_dim
    sat_tr = _transform(lda_tr, lambda u: fmllr.get(
        train.utt2spk[u], np.eye(dim, dim + 1)), device)
    tri3b, tri3b_ali = train_tri(sat_tr, train.text, lang, tri2b, tri2b_ali,
                                 tcfg, device=device,
                                 report=stage_report("tri3b"))
    # two-pass SAT decode (steps/decode_fmllr.sh): 1st pass with the
    # ALIGNMENT MODEL (gmm-acc-stats-twofeats alimdl — the SAT model is
    # mismatched to unadapted features) → LATTICE posteriors with
    # silence down-weighted (lattice-to-post | weight-silence-post |
    # gmm-est-fmllr) → adapted decode with the SAT model → second
    # fMLLR round from that decode's lattice → final decode.
    HCLG3 = mkgraph(lang, tri3b.tm, G)
    alimdl = estimate_alignment_model(tri3b.am, tri3b.tm, sat_tr,
                                      lda_tr, tri3b_ali)
    te_spk = {u: test.utt2spk[u] for u in lda_te}

    def fmllr_round(am_pass, feats_pass, prev=None):
        """decode → lattice posteriors → per-speaker fMLLR (composed
        with `prev` when this is the second round)."""
        first = decode_gmm_lattice(feats_pass, am_pass, tri3b.tm,
                                   HCLG3, lang, beam=dcfg.beam,
                                   acoustic_scale=dcfg.acoustic_scale,
                                   device=device)
        # lattice acoustic costs are stored pre-scaled → scale 1.0
        posts = {u: frame_posteriors(first.lattices[u],
                                     acoustic_scale=1.0)
                 for u in feats_pass}
        return estimate_fmllr_per_speaker_post(
            tri3b.am, feats_pass, posts, tri3b.tm, te_spk,
            silence_phones=lang.silence_phones, silence_weight=0.01,
            min_count=50.0)

    def adapt(feats, trans):
        return _transform(feats, lambda u: trans.get(
            te_spk[u], np.eye(dim, dim + 1)), device)

    fmllr_te = fmllr_round(alimdl, lda_te)
    sat_te = adapt(lda_te, fmllr_te)
    # second round: re-estimate from the ADAPTED decode's lattice — a
    # correction transform on top of the first (decode_fmllr.sh's
    # est_fmllr2/compose-transforms stage)
    fmllr2 = fmllr_round(tri3b.am, sat_te)
    sat_te = adapt(sat_te, fmllr2)
    res = decode_gmm(sat_te, tri3b.am, tri3b.tm, HCLG3, lang, dcfg,
                     refs=test.text, device=device)
    wers["tri3b"] = res.wer
    log.info("tri3b decode: %s (%.0fs total)", res.wer, timer.elapsed())

    for stage, wer in wers.items():
        print(f"{stage}: {wer}")
    if return_systems:
        return wers, {
            "lang": lang, "train": train, "test": test, "G": G,
            "delta_tr": delta_tr, "delta_te": delta_te,
            "mono": mono, "mono_ali": mono_ali,
            "tri1": tri1, "tri1_ali": tri1_ali, "HCLG1": HCLG1,
            "tri3b": tri3b, "tri3b_ali": tri3b_ali,
            # SAT-adapted features both sides: the chain stage trains on
            # these (the reference trains chain on the best adapted
            # front-end; sat_te uses the tri3b first-pass fMLLR, i.e.
            # steps/decode_fmllr.sh then nnet decode on those feats)
            "sat_tr": sat_tr, "sat_te": sat_te, "dcfg": dcfg,
        }
    return wers


def ladder_corpus(num_utts: int = 100, num_test: int = 30,
                  noise: float = 0.12, speaker_warp: float = 0.12,
                  coarticulation: float = 0.35, lexicon=None,
                  formants=None) -> Dict:
    """``run``'s keywords for the WER ladder's hard corpus
    (pipelines/ladder.py ``run``; the 12-word confusable lexicon unless
    given): held-out test speakers, the tree and the speaker counts
    scaled with the corpus.  At ``run``'s own defaults mono already
    scores 0.00 and the recipe's exit rule cannot tell the stages
    apart."""
    from kaldi_tpu_torch.pipelines.data import (confusable_formants,
                                                confusable_lexicon)
    # tree size scales with the corpus, as Kaldi recipes tune
    # <num-leaves> <tot-gauss> per corpus: swept at ~100 utts, 30
    # leaves/600 gauss generalizes best (100-leaf trees over-split and
    # regress below mono); grow ~linearly beyond that.
    leaves = max(30, num_utts // 4)
    # speaker count scales with the corpus (a few training speakers let
    # the tree's context splits latch onto the speakers' warps)
    return dict(num_utts=num_utts, num_test=num_test,
                lexicon=lexicon or confusable_lexicon(),
                formants=formants or confusable_formants(),
                noise=noise, speaker_warp=speaker_warp,
                heldout_speakers=True, coarticulation=coarticulation,
                tri_leaves=leaves, tri_gauss=20 * leaves,
                num_speakers=max(4, num_utts // 20),
                num_test_speakers=max(3, num_test // 20))


def main(argv=None):
    """The recipe on the ladder's corpus (``ladder_corpus``); exit 0 when
    tri3b's WER is no worse than mono's."""
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.pipelines.mini "
                      "[options]")
    po.register("num-utts", int, 100, "training utterances")
    po.register("num-test", int, 30, "test utterances")
    po.register("quick", bool, False, "reduced iterations")
    po.register("device", str, "cuda", "torch device to run on")
    po.read(argv)
    wers = run(quick=po["quick"], device=po["device"],
               **ladder_corpus(po["num-utts"], po["num-test"]))
    return 0 if wers["tri3b"].wer <= wers["mono"].wer else 1


if __name__ == "__main__":
    sys.exit(main())
